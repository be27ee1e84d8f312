"""Per-event caption decoder: the teacher-forced pass of training and
evaluation, the KV-cached greedy decode of serving (whole, or in chunks at
per-video cursors for the continuous server) and the beam search of
evaluation; counterpart of the JAX ``models/caption_decoder.py``. The greedy
decode runs as plain ops, one ``decode_pair`` per token (``decode_impl``
"xla"), or through the fused decode step, one kernel launch per token
(``decode_impl`` "fused", ``ops/fused_decode.py``). Every decode is
post-norm only: with ``pre_norm`` each raises before it launches anything
(JAX's plain decode asserts the same; its fused decode has no such check
and would run a pre-norm model with post-norm math)."""

from __future__ import annotations

import torch
from torch import nn

from ..config import check_decode_options
from ..ops import fused_decode as fd
from ..utils.observability import SPANS
from .embeddings import VocabularyEmbedder, caption_positional_encoding
from .layers import Dropout, Linear, UnimodalCaptionDecoderLayer, refuse_pre_norm


def make_causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(seq_len, seq_len) True above the diagonal (masked)."""
    return ~torch.ones((seq_len, seq_len), dtype=torch.bool, device=device).tril()


class UnimodalCaptionDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 512, depth: int = 6,
                 num_heads: int = 8, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 positional_embedding_dropout: float = 0.0, attention_dropout: float = 0.0,
                 projection_dropout: float = 0.0, mlp_dropout_1: float = 0.0,
                 mlp_dropout_2: float = 0.0, embedding_matrix=None, pre_norm: bool = False,
                 return_intermediate: bool = True):
        super().__init__()
        self.depth = depth
        self.num_heads = num_heads
        self.pre_norm = pre_norm
        self.return_intermediate = return_intermediate
        self.target_embedding = VocabularyEmbedder(vocab_size, d_model, embedding_matrix)
        self.register_buffer("pos_table", caption_positional_encoding(d_model),
                             persistent=False)
        self.pos_dropout = Dropout(positional_embedding_dropout)
        self.decoder = nn.ModuleList(
            UnimodalCaptionDecoderLayer(d_model, num_heads, mlp_ratio, qkv_bias,
                                        attention_dropout, projection_dropout,
                                        mlp_dropout_1, mlp_dropout_2, pre_norm)
            for _ in range(depth))
        self.head = Linear(d_model, vocab_size)

    def forward(self, tgt, memory, tgt_mask=None, tgt_padding_mask=None,
                memory_padding_mask=None, groups: int = 1, zeroed_mask=None,
                log_probs: bool = False):
        """Teacher-forced pass: tgt (N, Tc) token ids, memory (B, S, D) with
        groups = N // B -> the (depth, N, Tc, V) stack of every layer (of the
        last one alone, (1, N, Tc, V), without ``return_intermediate``): raw
        logits (training: the criterion folds the log-softmax into its
        loss), or with ``log_probs`` f32 log-probabilities (evaluation), as
        the JAX ``__call__`` returns them unless ``return_logits``."""
        x = self.target_embedding(tgt)
        # the f32 sine table in the embedding's dtype, so a bf16 trunk stays bf16
        x = self.pos_dropout(x + self.pos_table[:, :tgt.shape[1]].to(x.dtype))
        if tgt_mask is not None and tgt_mask.dim() == 2:
            tgt_mask = tgt_mask[None, None]
        intermediate = []
        for layer in self.decoder:
            x = layer(x, memory, tgt_mask, tgt_padding_mask, memory_padding_mask,
                      groups=groups, zeroed_mask=zeroed_mask)
            if self.return_intermediate:
                intermediate.append(x)
        logits = self.head(torch.stack(intermediate) if self.return_intermediate else x[None])
        return torch.log_softmax(logits.float(), dim=-1) if log_probs else logits

    def embed_at(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """(N,) tokens at position ``pos`` -> (N, 1, D) with the sine table.
        ``pos`` is an int, or an (N,) tensor of per-row positions."""
        x = self.target_embedding(tokens[:, None])
        if isinstance(pos, torch.Tensor):
            return x + self.pos_table[0, pos][:, None, :].to(x.dtype)
        return x + self.pos_table[:, pos:pos + 1].to(x.dtype)

    def precompute_memory_kv(self, memory: torch.Tensor, kv_dtype=None):
        """Per-layer cross-attention (k, v) of the memory, in ``kv_dtype``
        when one is given."""
        kv = [layer.project_memory_kv(memory) for layer in self.decoder]
        if kv_dtype is not None:
            kv = [(k.to(kv_dtype), v.to(kv_dtype)) for k, v in kv]
        return kv

    def decode_pair(self, prev_tokens, pad_tokens, step, k_caches, v_caches,
                    mem_kv, memory_padding_mask, groups: int = 1, zeroed_mask=None):
        """Commit ``prev_tokens`` at ``step`` and predict position step+1 in
        one pass through every layer. ``step`` is an int or an (N,) tensor of
        per-row positions. Returns f32 logits at step+1; the caches
        (depth, N, Tc, D) are updated in place."""
        x = torch.cat([self.embed_at(prev_tokens, step),
                       self.embed_at(pad_tokens, step + 1)], dim=1)  # (N, 2, D)
        for li, layer in enumerate(self.decoder):
            mk, mv = mem_kv[li]
            x, _, _ = layer.incremental_pair(
                x, step, k_caches[li], v_caches[li], step + 1, mk, mv,
                memory_padding_mask, groups=groups, zeroed_mask=zeroed_mask)
        return self.head(x[:, 1, :]).float()


def greedy_decode(
    module: UnimodalCaptionDecoder,
    memory: torch.Tensor,          # (B, S, D) shared by `groups` rows each
    memory_padding_mask,           # (N, S) True=masked
    seq_len: int,
    bos_idx: int,
    eos_idx: int,
    pad_idx: int,
    faster_eval: bool = False,
    groups: int = 1,
    zeroed_mask=None,
    decode_impl: str = "xla",
    kv_mode: str = "dense",
    fused_grid: str = "video",
    kv_dtype=None,
) -> torch.Tensor:
    """KV-cached greedy decode, with the rules of ``greedy_loop``.

    ``decode_impl`` "xla" runs each step as plain ops (``decode_pair``);
    "fused" runs it through ``ops.fused_decode.fused_decode_step`` with the
    memory K/V kept ``kv_mode`` ("dense" or "int8") and the kernel's
    ``fused_grid`` schedule ("video" or "batch"); it needs ``groups`` > 1.
    ``kv_dtype`` (a torch dtype, or None to keep the projections' dtype)
    is the dtype the memory K/V are kept in; the self-attention caches take
    the memory's dtype.

    Returns (N, seq_len + 1) int64 token ids including <bos>. A pre-norm
    ``module`` raises ``ValueError``.
    """
    refuse_pre_norm(module)
    check_decode_options(decode_impl=decode_impl, decode_kv=kv_mode,
                         decode_fused_grid=fused_grid)
    N = memory.shape[0] * groups
    D = memory.shape[2]
    pad_tok = torch.full((N,), pad_idx, dtype=torch.long, device=memory.device)

    if decode_impl == "fused":
        if groups <= 1:
            raise ValueError("the fused decode needs the grouped shared-KV path (groups > 1)")
        step_logits = _fused_step_fn(module, memory, memory_padding_mask, seq_len, groups,
                                     zeroed_mask, kv_mode, fused_grid, pad_tok, kv_dtype)
    else:
        mem_kv = module.precompute_memory_kv(memory, kv_dtype)
        k_caches = memory.new_zeros((module.depth, N, seq_len, D))
        v_caches = memory.new_zeros((module.depth, N, seq_len, D))

        def step_logits(prev_tokens, t):
            return module.decode_pair(prev_tokens, pad_tok, t - 1, k_caches, v_caches, mem_kv,
                                      memory_padding_mask, groups, zeroed_mask)

    return greedy_loop(step_logits, N, seq_len, bos_idx, eos_idx, pad_idx, memory.device,
                       faster_eval)


def greedy_loop(step_logits, N: int, seq_len: int, bos_idx: int, eos_idx: int, pad_idx: int,
                device, faster_eval: bool = False) -> torch.Tensor:
    """The greedy decode around ``step_logits(prev_tokens (N,), t)``, which
    commits ``prev_tokens`` at position t - 1 and returns the logits (N, V)
    at t. Argmax per step; without ``faster_eval`` captions freeze after
    <eos> (later slots take <pad>), the loop ends once every caption is done
    (one host sync a step), and a trailing <pad> (or <eos> if none was
    emitted) is appended; with ``faster_eval`` every slot takes the raw
    argmax and an <eos> column is appended. Returns (N, seq_len + 1) int64
    token ids including <bos>. The loop is a ``model.decode`` span, each
    step in it a ``model.decode_step`` (``utils.observability.SPANS``); the
    host sync that ends the loop sits between the steps."""
    with SPANS.span("model.decode"):
        captions = torch.full((N, seq_len), pad_idx, dtype=torch.long, device=device)
        captions[:, 0] = bos_idx
        done = torch.zeros((N,), dtype=torch.bool, device=device)
        for t in range(1, seq_len):
            if not faster_eval and bool(done.all()):
                break
            with SPANS.span("model.decode_step"):
                tok = step_logits(captions[:, t - 1], t).argmax(dim=-1)
                if not faster_eval:
                    tok = torch.where(done, pad_idx, tok)
                captions[:, t] = tok
                done |= tok == eos_idx

        if faster_eval:
            last = torch.full((N,), eos_idx, dtype=torch.long, device=device)
        else:
            last = torch.where((captions == eos_idx).any(dim=1), pad_idx, eos_idx).long()
        return torch.cat([captions, last[:, None]], dim=1)


def greedy_decode_chunk(
    module: UnimodalCaptionDecoder,
    captions: torch.Tensor,        # (N, seq_len) int64, position 0 = <bos>
    done: torch.Tensor,            # (N,) bool: the row emitted <eos>
    t_vid: torch.Tensor,           # (B,) int64: next position to fill, per video
    k_caches: torch.Tensor,        # (depth, N, seq_len, D)
    v_caches: torch.Tensor,
    mem_kv,                        # list of (k, v) from precompute_memory_kv
    memory_padding_mask,           # (N, S)
    seq_len: int,
    eos_idx: int,
    pad_idx: int,
    groups: int,
    zeroed_mask,
    active_vid: torch.Tensor,      # (B,) bool: the slot holds a live request
    chunk: int,
):
    """Advance each video's greedy decode by up to ``chunk`` positions at its
    own cursor ``t_vid``: the continuous server's step, where slots at
    different depths of their captions share one pass. The JAX
    ``greedy_decode_chunk``.

    Tokens follow ``greedy_decode`` (argmax, the first index on ties; done
    rows take <pad>); a video freezes when all its ``groups`` rows are done,
    its cursor reaches ``seq_len`` or its slot is inactive. A frozen video
    still runs the layer pass, at the position it last committed, and
    rewrites the same cache values there; its captions, ``done`` and cursor
    do not move. Plain ops only.

    ``captions``, ``done``, ``t_vid`` and the caches are updated in place
    and returned: (captions, done, t_vid, k_caches, v_caches). A pre-norm
    ``module`` raises ``ValueError``."""
    refuse_pre_norm(module)
    B = t_vid.shape[0]
    N = captions.shape[0]
    rows = torch.arange(N, device=captions.device)
    pad_tok = torch.full((N,), pad_idx, dtype=captions.dtype, device=captions.device)
    for _ in range(chunk):
        adv_vid = active_vid & (t_vid < seq_len) & ~done.view(B, groups).all(dim=1)
        adv_row = adv_vid.repeat_interleave(groups)
        t_w = t_vid.repeat_interleave(groups).clamp(1, seq_len - 1)
        logits = module.decode_pair(captions[rows, t_w - 1], pad_tok, t_w - 1, k_caches,
                                    v_caches, mem_kv, memory_padding_mask, groups, zeroed_mask)
        tok = torch.where(done, pad_tok, logits.argmax(dim=-1))
        captions[rows, t_w] = torch.where(adv_row, tok, captions[rows, t_w])
        done |= (tok == eos_idx) & adv_row
        t_vid += adv_vid.to(t_vid.dtype)
    return captions, done, t_vid, k_caches, v_caches


def beam_search_decode(
    module: UnimodalCaptionDecoder,
    memory: torch.Tensor,          # (N, S, D); or (B, S, D) with groups = N // B
    memory_padding_mask,           # (N, S) True=masked
    seq_len: int,
    bos_idx: int,
    eos_idx: int,
    pad_idx: int,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    groups: int = 1,
    zeroed_mask=None,
) -> torch.Tensor:
    """Batched beam search with per-layer KV caches, plain ops; the JAX
    ``beam_search_decode``, with the rules of ``beam_loop``. The K beams of
    row n are rows n*K + k, so grouped memory stays per video with group
    size groups*K and ungrouped memory is repeated K times. A pre-norm
    ``module`` raises ``ValueError``."""
    refuse_pre_norm(module)
    N = memory.shape[0] * groups
    K = beam_size
    mem_mask = memory_padding_mask.repeat_interleave(K, dim=0)  # (N*K, S)
    mem = memory if groups > 1 else memory.repeat_interleave(K, dim=0)
    groups_eff = groups * K if groups > 1 else 1
    zeroed_eff = zeroed_mask.repeat_interleave(K, dim=0) if zeroed_mask is not None else None
    mem_kv = module.precompute_memory_kv(mem)
    pad_tok = torch.full((N * K,), pad_idx, dtype=torch.long, device=memory.device)

    def step_logits(prev_tokens, t, k_caches, v_caches):
        return module.decode_pair(prev_tokens, pad_tok, t - 1, k_caches, v_caches, mem_kv,
                                  mem_mask, groups_eff, zeroed_eff)

    return beam_loop(step_logits, N, K, seq_len, mem, module.depth, bos_idx, eos_idx, pad_idx,
                     length_penalty)


def beam_loop(step_logits, N: int, K: int, seq_len: int, cache_like: torch.Tensor, depth: int,
              bos_idx: int, eos_idx: int, pad_idx: int, length_penalty: float = 0.0):
    """The beam search around ``step_logits(prev_tokens (N*K,), t, k_caches,
    v_caches)``, which commits ``prev_tokens`` at position t - 1 into the
    caches (depth, N*K, seq_len, D; in ``cache_like``'s dtype, on its
    device), in place, and returns the logits (N*K, V) at t. Beams of row n
    are rows n*K + k. Each step commits the previous token and predicts the
    next in one pass, then reorders the caches by parent beam (JAX commits,
    predicts and then reorders, in two passes). Candidates are the top K of
    the (K * V) scores by a stable descending sort, so ties go to the lower
    index as ``lax.top_k`` breaks them; finished beams extend only with
    <pad> at cost 0. The loop ends once every beam is finished (one host
    sync a step), which changes no result. With ``length_penalty`` the final
    scores are divided by ((5 + length) / 6) ** length_penalty, the length
    counting the tokens that are not <pad>, <bos> included.

    Returns (N, seq_len + 1) int64 captions of the best beam, with the tail
    rule of ``greedy_loop`` (a trailing <pad>, or <eos> if none was
    emitted)."""
    D = cache_like.shape[-1]
    dev = cache_like.device
    NEG = -1e9
    tokens = torch.full((N, K, seq_len), pad_idx, dtype=torch.long, device=dev)
    tokens[:, :, 0] = bos_idx
    # only beam 0 is live at the start, so the first expansion diversifies
    scores = torch.full((N, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((N, K), dtype=torch.bool, device=dev)
    k_caches = cache_like.new_zeros((depth, N * K, seq_len, D))
    v_caches = cache_like.new_zeros((depth, N * K, seq_len, D))
    rows = torch.arange(N, device=dev)[:, None]

    for t in range(1, seq_len):
        if bool(done.all()):
            break
        logits = step_logits(tokens[:, :, t - 1].reshape(N * K), t, k_caches, v_caches)
        logp = torch.log_softmax(logits, dim=-1).reshape(N, K, -1)  # (N, K, V)
        V = logp.shape[-1]
        pad_only = torch.full((V,), NEG, dtype=logp.dtype, device=dev)
        pad_only[pad_idx] = 0.0
        logp = torch.where(done[..., None], pad_only, logp)
        cand = (scores[..., None] + logp).reshape(N, K * V)
        order = torch.sort(cand, dim=1, descending=True, stable=True)
        scores, idx = order.values[:, :K], order.indices[:, :K]
        parent = idx // V
        new_tok = idx % V
        tokens = tokens[rows, parent]
        done = done[rows, parent]
        flat_parent = (rows * K + parent).reshape(-1)
        k_caches = k_caches[:, flat_parent]
        v_caches = v_caches[:, flat_parent]
        new_tok = torch.where(done, pad_idx, new_tok)
        tokens[:, :, t] = new_tok
        done = done | (new_tok == eos_idx)

    ranked = scores
    if length_penalty:
        lengths = (tokens != pad_idx).sum(dim=-1).float()
        ranked = scores / ((5.0 + lengths) / 6.0) ** length_penalty
    best = ranked.argmax(dim=1)
    captions = tokens[rows[:, 0], best]
    has_eos = (captions == eos_idx).any(dim=1)
    last = torch.where(has_eos, pad_idx, eos_idx).long()
    return torch.cat([captions, last[:, None]], dim=1)


def _fused_step_fn(module, memory, memory_padding_mask, seq_len, groups, zeroed_mask,
                   kv_mode, fused_grid, pad_tok, kv_dtype=None):
    """The fused path's inputs (JAX ``_greedy_decode_fused``) and a function
    of (prev_tokens, t) that commits ``prev_tokens`` at t-1 and returns the
    f32 logits at t. Embeddings and the vocabulary head stay plain ops, as in JAX; the
    layers run in one ``fused_decode_step``, in the memory's dtype; the
    head's logits are f32. A pre-norm ``module`` raises ``ValueError``
    before the kernel is reached (JAX's fused decode has no such check)."""
    refuse_pre_norm(module)
    B, S, D = memory.shape
    G = groups
    Sp = fd.padded_len(S)
    weights = fd.extract_decoder_weights(module)
    mem_k, mem_v = fd.stack_memory_kv(weights, memory, Sp)
    if kv_dtype is not None:
        mem_k, mem_v = mem_k.to(kv_dtype), mem_v.to(kv_dtype)
    k_scales = v_scales = None
    if kv_mode == "int8":
        mem_k, k_scales = fd.quantize_kv_int8(mem_k)
        mem_v, v_scales = fd.quantize_kv_int8(mem_v)
    mask_i8, log_m = fd.decode_masks(memory_padding_mask, zeroed_mask, B, G, Sp)
    k_caches = memory.new_zeros((module.depth, B, seq_len * G, D))
    v_caches = memory.new_zeros((module.depth, B, seq_len * G, D))

    def step_logits(prev_tokens, t):
        x_prev = module.embed_at(prev_tokens, t - 1)[:, 0].reshape(B, G, D)
        x_next = module.embed_at(pad_tok, t)[:, 0].reshape(B, G, D)
        x = torch.cat([x_prev, x_next], dim=1).contiguous()  # (B, 2G, D), t-major rows
        x_out, _, _ = fd.fused_decode_step(
            x, k_caches, v_caches, t - 1, t, mem_k, mem_v, k_scales, v_scales,
            mask_i8, log_m, weights, G=G, num_heads=module.num_heads,
            has_bias_col=zeroed_mask is not None, grid_mode=fused_grid)
        return module.head(x_out[:, G:].reshape(B * G, D)).float()

    return step_logits
