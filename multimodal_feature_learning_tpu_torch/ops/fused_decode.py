"""One greedy decode step through every caption layer: the plain PyTorch
version and the wrapper of the hand-written CUDA kernel.

Counterpart of the JAX ``ops/fused_decode.py``, whose ``fused_decode_step``
runs the Pallas kernels ``_decode_step_kernel`` (grid "video", one program
per (layer, video)) and ``_decode_step_kernel_batch`` (grid "batch", Bt
videos a program). Here ``csrc/fused_decode.cu`` stands for both: one
launch a step, the layer loop inside the kernel, the products on the
tensor cores in 3xTF32 (``split_tf32`` is the split's plain counterpart).
The two grids run one schedule on the card and compute the same numbers;
``batch_tile`` is still validated, so the config knobs behave as before.

Widths: each (D, Dh) pair has a library of its own, ``-DFD_D`` and
``-DFD_DH`` (``width_flags``; the flagship's 512 and 64 are the default
build), built under ``build/kernels/`` at its first launch; everything else
is taken at run time within the limits ``check_kernel_shape`` states.

The step runs in x's dtype ``ct``, f32 or bf16, as the TPU kernels run in
theirs: in bf16 the weights, caches and dense memory K/V are bf16, each
product accumulates in f32 and is rounded to bf16 (on bf16 tensor cores
in the kernel), and the logits, softmaxes and LayerNorm statistics stay
f32 (``fused_decode_step_plain`` has every rounding point).

Row layout per video, as in JAX: R = 2G rows, rows [0, G) are the commit
positions (the token at ``step``, one per event) and rows [G, 2G) the
predict positions (``step + 1``). The self-attention caches are
position-major, (depth, B, Tc*G, D): row p*G + e holds event e's key at
position p. The memory K/V are padded from S to Sp = round_up(S, 128) with
blocked, zero-valued rows; a row whose every position is blocked therefore
averages V over all Sp columns, as the TPU kernel computes it.

A tensor on the CPU takes ``fused_decode_step_plain``; a CUDA tensor goes
to the kernel or raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .build import KernelBinding, load_library

NEG_MASK = -1e20  # masked logit, applied before the scale
LN_EPS = 1e-6
KV_PAD = 128      # S is padded to a multiple of this
CHUNK = 128       # memory columns per cross-attention unit of the kernel

_ATT_KEYS = ("q_linear", "k_linear", "v_linear", "projection_layer")

W_ORDER = (
    "sa_wq", "sa_bq", "sa_wk", "sa_bk", "sa_wv", "sa_bv", "sa_wo", "sa_bo",
    "ca_wq", "ca_bq", "ca_wk", "ca_bk", "ca_wv", "ca_bv", "ca_wo", "ca_bo",
    "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2",
    "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b",
)


def padded_len(S: int) -> int:
    return -(-S // KV_PAD) * KV_PAD


def extract_decoder_weights(caption_module) -> Dict[str, torch.Tensor]:
    """The caption decoder's per-layer weights stacked into the 26 arrays of
    JAX ``_W_ORDER``: kernels (depth, in, out), biases and LayerNorm
    parameters (depth, 1, width), contiguous."""
    layers = list(caption_module.decoder)

    def stack(get):
        return torch.stack([get(layer).detach() for layer in layers]).contiguous()

    def bias(linear):
        if linear.bias is not None:
            return linear.bias
        return linear.weight.new_zeros(linear.out_features)

    w = {}
    for prefix, attn in (("sa", "self_attention"), ("ca", "cross_attention")):
        for short, name in zip("qkvo", _ATT_KEYS):
            w[f"{prefix}_w{short}"] = stack(lambda l: getattr(getattr(l, attn), name).weight.T)
            w[f"{prefix}_b{short}"] = stack(lambda l: bias(getattr(getattr(l, attn), name))[None])
    for i in (1, 2):
        w[f"mlp_w{i}"] = stack(lambda l: getattr(l.mlp, f"fully_connected_{i}").weight.T)
        w[f"mlp_b{i}"] = stack(lambda l: getattr(l.mlp, f"fully_connected_{i}").bias[None])
    for i in (1, 2, 3):
        w[f"ln{i}_s"] = stack(lambda l: getattr(l, f"layer_norm_{i}").weight[None])
        w[f"ln{i}_b"] = stack(lambda l: getattr(l, f"layer_norm_{i}").bias[None])
    return w


def stack_memory_kv(weights: Dict[str, torch.Tensor], memory: torch.Tensor,
                    s_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V of the shared memory (B, S, D), stacked
    (depth, B, s_pad, D); the rows past S are zero."""
    S = memory.shape[1]
    pad = (0, 0, 0, s_pad - S)
    mem_k = torch.einsum("bsd,lde->lbse", memory, weights["ca_wk"]) + weights["ca_bk"][:, None]
    mem_v = torch.einsum("bsd,lde->lbse", memory, weights["ca_wv"]) + weights["ca_bv"][:, None]
    return (torch.nn.functional.pad(mem_k, pad).contiguous(),
            torch.nn.functional.pad(mem_v, pad).contiguous())


def quantize_kv_int8(mem: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (layer, video, token): values (L, B, Sp, D) int8,
    rounded half to even, and scales (L, B, 1, Sp) f32 (1 where a row is 0)."""
    memf = mem.float()
    amax = memf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(memf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale[:, :, None, :].contiguous()


def decode_masks(memory_padding_mask: torch.Tensor, zeroed_mask: Optional[torch.Tensor],
                 B: int, G: int, s_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's mask inputs: ``mask_i8`` (B, 2G, s_pad) int8, 1 = blocked
    (pad | zeroed, and every column past S), and ``log_m`` (B, 2G, 1) f32,
    the log of the number of attendable zeroed positions (-1e20 where there
    are none; 0 without a bias column). Rows are t-major: row r is event
    r % G."""
    S = memory_padding_mask.shape[1]
    pad = memory_padding_mask.reshape(B, G, S)
    if zeroed_mask is not None:
        zer = zeroed_mask.reshape(B, G, S)
        blocked = pad | zer
        m = (~pad & zer).sum(dim=2).float()
        log_m = torch.where(m > 0, torch.log(m.clamp(min=1.0)), torch.full_like(m, NEG_MASK))
    else:
        blocked = pad
        log_m = torch.zeros((B, G), dtype=torch.float32, device=pad.device)
    mask_i8 = torch.nn.functional.pad(blocked, (0, s_pad - S), value=True).to(torch.int8)
    return mask_i8.repeat(1, 2, 1).contiguous(), log_m.repeat(1, 2)[..., None].contiguous()


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def erfc_f32(z: torch.Tensor) -> torch.Tensor:
    """erfc by Abramowitz & Stegun 7.1.26, the polynomial of the JAX kernel's
    ``_erfc_f32``."""
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erfc_a = poly * torch.exp(-a * a)
    return torch.where(z >= 0, erfc_a, 2.0 - erfc_a)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """0.5 x erfc(-x sqrt(1/2)) with the polynomial erfc, as
    ``_gelu_exact``: each step in x's dtype ``ct`` (sqrt(1/2) rounded to
    it), the erfc in f32 and rounded to ``ct``."""
    ct = x.dtype
    z = (-x) * torch.tensor(SQRT_HALF, dtype=ct)
    return (0.5 * x) * erfc_f32(z.float()).to(ct)


def layer_norm_one_pass(x, scale, bias):
    """LayerNorm with var = max(E[x^2] - mean^2, 0), eps 1e-6: statistics
    and the affine map in f32, the result in x's dtype (``_layer_norm``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
    return ((xf - mean) * (torch.rsqrt(var + LN_EPS) * scale.float()) + bias.float()).to(x.dtype)


def _softmax_rows(logits):
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``a`` as hi + lo, each rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero; the bits ``cvt.rna.tf32.f32`` gives): the
    plain counterpart of the kernel's ``split_tf32``. The rest ``a - hi``
    is exact in f32, so hi + lo is ``a`` within 2^-22 of its magnitude, and
    a product summed as lo*hi + hi*lo + hi*hi (each product of two TF32
    values is exact in f32) keeps about f32 accuracy."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
        return (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)

    a = a.float()
    hi = rna(a)
    return hi, rna(a - hi)


def cross_attention_plain(qc, mem_k, mem_v, k_scales, v_scales, blocked, log_m, kb, vb,
                          *, num_heads: int, has_bias_col: bool):
    """One layer's shared-KV cross-attention of the decode step: qc (B, R,
    D) in ``ct``, memory K/V (B, Sp, D) in ``ct`` or int8 with scales (B, 1,
    Sp), ``blocked`` (B, 1, R, Sp) bool, ``log_m`` (B, R, 1), the K/V
    projections' biases kb, vb (D,) (the bias column). Returns the heads'
    outputs (B, H, R, Dh) in f32. Products run in ``ct`` (int8 K/V widened
    to it) and are rounded to it; logits, softmax and scales are f32."""
    B, R, D = qc.shape
    H = num_heads
    Dh = D // H
    scale = Dh ** -0.5
    ct = qc.dtype

    def heads(t):  # (B, T, D) -> (B, H, T, Dh)
        return t.reshape(t.shape[0], t.shape[1], H, Dh).transpose(1, 2)

    kv_int8 = mem_k.dtype == torch.int8
    kh, vh = heads(mem_k.to(ct)), heads(mem_v.to(ct))
    lg = (heads(qc) @ kh.transpose(-1, -2)).float()  # (B, H, R, Sp)
    if kv_int8:
        lg = lg * k_scales[:, None]
    scaled = lg.masked_fill(blocked, NEG_MASK) * scale
    if not has_bias_col:
        attn = _softmax_rows(scaled)
        if kv_int8:
            attn = attn * v_scales[:, None]
        return (attn.to(ct) @ vh).float()
    # q . k_bias as an f32 multiply-reduce rounded to ct, as the TPU kernel
    prod = heads(qc).float() * kb.float().reshape(H, 1, Dh)
    l_bias = prod.sum(dim=-1, keepdim=True).to(ct).float() * scale
    bias_logit = l_bias + log_m[:, None]  # (B, H, R, 1)
    m_max = torch.maximum(scaled.amax(dim=-1, keepdim=True), bias_logit)
    e_main = torch.exp(scaled - m_max)
    e_bias = torch.exp(bias_logit - m_max)
    denom = e_main.sum(dim=-1, keepdim=True) + e_bias
    attn = e_main / denom
    if kv_int8:
        attn = attn * v_scales[:, None]
    return (attn.to(ct) @ vh).float() + (e_bias / denom) * vb.float().reshape(H, 1, Dh)


def fused_decode_step_plain(x, k_caches, v_caches, step: int, valid_len: int,
                            mem_k, mem_v, k_scales, v_scales, mask_i8, log_m,
                            weights, *, G: int, num_heads: int, has_bias_col: bool):
    """The math of ``_decode_step_kernel`` in plain PyTorch, all videos at
    once: every video attends only its own event's keys and its own Sp
    columns, so the result is that of any batch tile. Runs in x's dtype
    ``ct`` (f32 or bf16), with the TPU kernel's rounding: each product
    accumulates in f32 and is rounded to ``ct`` before its bias is added;
    logits, softmaxes and LayerNorm statistics are f32. Writes the commit
    rows into the caches in place; returns (x_out, k_caches, v_caches)."""
    depth, B, C, D = k_caches.shape
    R = x.shape[1]
    H = num_heads
    Dh = D // H
    scale = Dh ** -0.5
    kv_int8 = mem_k.dtype == torch.int8
    dev = x.device
    ct = x.dtype

    rows = torch.arange(R, device=dev)[:, None]
    cols = torch.arange(C, device=dev)[None, :]
    sa_blocked = (cols % G != rows % G) | (cols // G >= valid_len)  # (R, C)
    blocked = (mask_i8 != 0)[:, None]  # (B, 1, R, Sp)

    def heads(t):  # (B, T, D) -> (B, H, T, Dh)
        return t.reshape(t.shape[0], t.shape[1], H, Dh).transpose(1, 2)

    def merge(t):  # (B, H, R, Dh) -> (B, R, D)
        return t.transpose(1, 2).reshape(B, R, D)

    for li in range(depth):
        w = {name: weights[name][li] for name in W_ORDER}

        def dense(v, prefix, which):
            return v @ w[f"{prefix}_w{which}"] + w[f"{prefix}_b{which}"]

        # self-attention: commit the G rows' k/v at `step`, then attend
        k_caches[li, :, step * G:(step + 1) * G] = dense(x[:, :G], "sa", "k")
        v_caches[li, :, step * G:(step + 1) * G] = dense(x[:, :G], "sa", "v")
        lg = (heads(dense(x, "sa", "q")) @ heads(k_caches[li]).transpose(-1, -2)).float()
        attn = _softmax_rows(lg.masked_fill(sa_blocked, NEG_MASK) * scale).to(ct)
        x = layer_norm_one_pass(x + dense(merge(attn @ heads(v_caches[li])), "sa", "o"),
                                w["ln1_s"], w["ln1_b"])

        # cross-attention over the shared memory K/V, with the bias column
        out = cross_attention_plain(
            dense(x, "ca", "q"), mem_k[li], mem_v[li],
            k_scales[li] if kv_int8 else None, v_scales[li] if kv_int8 else None, blocked,
            log_m, w["ca_bk"][0], w["ca_bv"][0], num_heads=H, has_bias_col=has_bias_col)
        x = layer_norm_one_pass(x + dense(merge(out).to(ct), "ca", "o"), w["ln2_s"], w["ln2_b"])

        # MLP
        y = dense(gelu_exact(dense(x, "mlp", "1")), "mlp", "2")
        x = layer_norm_one_pass(x + y, w["ln3_s"], w["ln3_b"])
    return x, k_caches, v_caches


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------


def batch_tile_for(B: int, batch_tile: int = 0) -> int:
    """Videos per work unit of the "batch" grid: ``batch_tile``, or the
    largest of 8, 4, 2, 1 that divides B."""
    bt = batch_tile or next(t for t in (8, 4, 2, 1) if B % t == 0)
    if B % bt:
        raise ValueError(f"batch_tile {bt} must divide B={B}")
    return bt


# The kernel's stated limits. Dh is a multiple of 16 up to 128 (the tensor
# cores' k step of 16 in bf16, and the cross-attention's K and V chunks of
# 128 x Dh f32 in one block's shared memory); F is a multiple of 16 (whole
# k steps and 16-byte rows); and a shape's shared-memory plan (``smem_plan``)
# fits one block: SMEM_MAX bytes on an H100. Within these, every D = H Dh up
# to 1024, any B, depth, G (rows 2G), caption length, Sp = round_up(S, 128)
# and F, f32 and bf16, dense and int8 K/V, with or without the bias column,
# in both grids: at D <= 1024 and G <= 32 the plan always fits
# (tests/test_torch_fused_decode.py checks the corners).
DH_STEP, DH_MAX = 16, 128
F_STEP = 16
SMEM_MAX = 232_448
FLAGSHIP_WIDTHS = (512, 64)  # (D, Dh) of the build without -D flags


def width_flags(D: int, Dh: int) -> Tuple[str, ...]:
    """The nvcc flags of the library built for widths (D, Dh): none for the
    flagship's, else ``-DFD_D`` and ``-DFD_DH``; each set is its own library
    under ``build/kernels/``, built at its first launch."""
    if (D, Dh) == FLAGSHIP_WIDTHS:
        return ()
    return (f"-DFD_D={D}", f"-DFD_DH={Dh}")


# the constants of csrc/fused_decode.cu that size a block's shared memory
_BM, _BN, _NWARPS, _RT, _MAX_CG = 32, 64, 16, 32, 5
_WS = _RS = _BN + 8
_PS, _PSB = CHUNK + 4, CHUNK + 8
_RED_BYTES = (_NWARPS // 2) * _BM * _RS * 4


def smem_plan(D: int, Dh: int, G: int, Tc: int, Sp: int, bf16: bool,
              kv_int8: bool) -> Dict[str, int]:
    """The plan of the kernel's general schedule (``plan_smem`` of
    ``csrc/fused_decode.cu``, line for line): the GEMM tile's W chunk rows
    ``kc`` (D where the whole slab fits), the combine's chunks a group
    ``cg``, the cross-attention's buffers and whether they hold the q rows,
    the self-attention's events a unit and positions a tile, and ``bytes``,
    the block's need. Where the flagship's schedule fits (``plan_fixed``:
    Dh 64, at most 32 rows and five chunks, F = 4D, the whole W slab) the
    kernel runs that one instead; the wrapper's check needs only this plan,
    since the general schedule takes every shape the other does."""
    H, R, NC = D // Dh, 2 * G, Sp // CHUNK
    es = 2 if bf16 else 4
    QS = Dh + 4

    def w_region(kc, nb):
        return max(nb * kc * _WS * es, _RED_BYTES)

    a_bytes, coef_min = _BM * (D + 4) * 4, _BM * H * 3 * 4
    if a_bytes + w_region(D, 1) + coef_min <= SMEM_MAX:
        kc, nb = D, 1
    else:
        kc, nb = 64, 2
        while kc + 64 < D and a_bytes + w_region(kc + 64, 2) + coef_min <= SMEM_MAX:
            kc += 64
    base = a_bytes + w_region(kc, nb)
    cg = min(NC, _MAX_CG)
    while cg > 1 and base + _BM * H * (cg + 2) * 4 > SMEM_MAX:
        cg -= 1
    gemm = base + _BM * H * (cg + 2) * 4
    if bf16:
        krow = Dh + 16 if kv_int8 else (Dh + 8) * 2
        fixed, kv = _RT * _PS * 4 + _RT * _PSB * 2 + _RT * (Dh // 2 + 4) * 4, 2 * CHUNK * krow
    else:
        krow, vrow = (Dh + 16, Dh + 16) if kv_int8 else (QS * 4, (Dh + 8) * 4)
        fixed, kv = (2 * _RT * _PS + 2 * _RT * QS) * 4, CHUNK * (krow + vrow)
    tail = R * CHUNK + (2 * CHUNK * 4 if kv_int8 else 0)
    for nbuf, q_ring in ((2, 1), (1, 1), (1, 0)):
        cross = fixed + nbuf * (kv + q_ring * R * QS * 4 + tail)
        if cross <= SMEM_MAX:
            break
    smem = max(gemm, cross)

    def self_bytes(eg, pt):
        return (2 * eg * QS + 2 * pt * eg * QS + 2 * eg * Tc + (2 * eg * Dh if pt < Tc else 0)) * 4

    eg, pt = G, Tc
    while eg > 1 and self_bytes(eg, Tc) > smem:
        eg -= 1
    while pt > 1 and self_bytes(eg, pt) > smem:
        pt -= 1
    return {"kc": kc, "cg": cg, "ca_nbuf": nbuf, "ca_q_ring": q_ring, "sa_eg": eg,
            "sa_pt": pt, "gemm": gemm, "cross": cross, "bytes": max(smem, self_bytes(eg, pt))}


def check_kernel_shape(D: int, H: int, F: int, G: int, Tc: int, Sp: int, bf16: bool,
                       kv_int8: bool) -> None:
    """Raise ValueError, naming the limit, for a shape the kernel does not
    take (the module's stated limits); nothing is launched."""
    if H < 1 or D % H:
        raise ValueError(f"D={D} is not a multiple of the {H} heads")
    Dh = D // H
    if Dh % DH_STEP or not DH_STEP <= Dh <= DH_MAX:
        raise ValueError(f"the fused decode kernel takes a head width Dh that is a multiple "
                         f"of {DH_STEP} up to {DH_MAX}; D={D}, H={H} gives Dh={Dh}")
    if F < F_STEP or F % F_STEP:
        raise ValueError(f"the fused decode kernel takes an MLP width F that is a multiple "
                         f"of {F_STEP}; got F={F}")
    if Sp < CHUNK or Sp % CHUNK:
        raise ValueError(f"Sp={Sp} must be a positive multiple of {CHUNK}")
    plan = smem_plan(D, Dh, G, Tc, Sp, bf16, kv_int8)
    if plan["bytes"] > SMEM_MAX:
        raise ValueError(f"the fused decode kernel's shared-memory plan needs "
                         f"{plan['bytes']} bytes a block at D={D}, Dh={Dh}, G={G}, "
                         f"caption length {Tc}, {'bf16' if bf16 else 'f32'}"
                         f"{', int8 K/V' if kv_int8 else ''}: more than the {SMEM_MAX} "
                         f"of an H100 block")


class FusedDecodeKernel(KernelBinding):
    """``fused_decode_launch`` of ``csrc/fused_decode.cu`` under one grid
    mode; each mode keeps its own launch count. Each (D, Dh) runs the
    library built for it (``width_flags``), built at its first launch.

    Takes every shape within the stated limits (``check_kernel_shape``):
    Dh a multiple of 16 from 16 to 128, F a multiple of 16, and a
    shared-memory plan within one block's 232,448 bytes, which holds at
    every D <= 1024 and G <= 32 (rows 64); any B, depth, caption length
    and Sp (a multiple of 128); f32 and bf16; dense and int8 K/V; with and
    without the bias column. A shape outside them raises ValueError before
    any launch."""

    source, symbol = "fused_decode.cu", "fused_decode_launch"
    # fused_decode_launch(x, x_out, x_scratch, y_buf, k_cache, v_cache, mem_k,
    #   mem_v, k_scales, v_scales, mask, log_m, weights[26], q_buf, attn_buf,
    #   part_buf, h_buf, ca_o, ca_ml, ca_bl, B, G, D, H, depth, C, Sp, F, step,
    #   valid_len, has_bias, kv_int8, is_bf16, stream)
    argtypes = [ctypes.c_void_p] * 12 + [ctypes.POINTER(ctypes.c_void_p)] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    errors = {1001: "the library was built for other widths",
              1002: "the shape's shared-memory plan exceeds a block's",
              1003: "an argument is out of range"}

    def __init__(self, grid_mode: str, replaces: str, flags: Tuple[str, ...] = ()):
        super().__init__()
        self.grid_mode = grid_mode
        self.replaces = replaces
        self.flags = tuple(flags)
        self._fns = {}
        self._last_flags = self.flags

    def library_flags(self, D: int, Dh: int) -> Tuple[str, ...]:
        return width_flags(D, Dh) + self.flags

    def _launcher_for(self, flags: Tuple[str, ...]):
        if flags not in self._fns:
            fn = getattr(load_library(self.source, flags), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[flags] = fn
        return self._fns[flags]

    def __call__(self, x, k_caches, v_caches, step: int, valid_len: int, mem_k, mem_v,
                 k_scales, v_scales, mask_i8, log_m, weights, *, G: int, num_heads: int,
                 has_bias_col: bool, batch_tile: int = 0):
        depth, B, C, D = k_caches.shape
        R, Sp = x.shape[1], mem_k.shape[2]
        F = weights["mlp_w1"].shape[2]
        dev = x.device
        kv_int8 = mem_k.dtype == torch.int8
        ct = x.dtype  # the kernel's element type: float32 or bfloat16
        if ct not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the fused decode kernel takes float32 or bfloat16 x, got {ct}")
        # the caches, the weights and dense memory K/V in x's dtype; log_m
        # and the int8 scales f32
        in_ct = [("k_caches", k_caches), ("v_caches", v_caches)]
        in_ct += [(n, weights[n]) for n in W_ORDER]
        f32 = [("log_m", log_m)]
        if kv_int8:
            f32 += [("k_scales", k_scales), ("v_scales", v_scales)]
        else:
            in_ct += [("mem_k", mem_k), ("mem_v", mem_v)]
        for want, group in ((ct, in_ct), (torch.float32, f32)):
            for name, t in group:
                if t.dtype != want:
                    raise TypeError(f"{name} must be {want} (x is {ct}), got {t.dtype}")
        if R != 2 * G or x.shape != (B, R, D) or C % G or v_caches.shape != k_caches.shape:
            raise ValueError(f"x {tuple(x.shape)} and caches {tuple(k_caches.shape)} do not "
                             f"match G={G}")
        check_kernel_shape(D, num_heads, F, G, C // G, Sp, ct == torch.bfloat16, kv_int8)
        if dev.type != "cuda":
            raise ValueError(f"the fused decode kernel takes CUDA tensors, got {dev}")
        if not 0 <= step < C // G or not step < valid_len <= C // G:
            raise ValueError(f"step {step} / valid_len {valid_len} outside Tc={C // G}")
        if kv_int8 and (k_scales.shape != (depth, B, 1, Sp) or v_scales.shape != k_scales.shape):
            raise ValueError(f"scales must be ({depth}, {B}, 1, {Sp})")
        tensors = [("x", x)] + in_ct + f32 + [("mem_k", mem_k), ("mem_v", mem_v),
                                              ("mask_i8", mask_i8)]
        for name, t in tensors:
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous tensor on {dev}")
        if mem_k.shape != (depth, B, Sp, D) or mem_v.shape != mem_k.shape \
                or mem_v.dtype != mem_k.dtype or mask_i8.shape != (B, R, Sp) \
                or mask_i8.dtype != torch.int8 or log_m.shape != (B, R, 1):
            raise ValueError("memory K/V, mask_i8 or log_m have the wrong shape or type")
        if self.grid_mode == "batch":
            batch_tile_for(B, batch_tile)  # validated; the card runs one schedule

        M, H, NC = B * R, num_heads, Sp // CHUNK

        def scratch(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        x_out, x_scratch, y_buf = torch.empty_like(x), scratch(2, M, D), scratch(M, D)
        q_buf, attn_buf, h_buf = scratch(M, D), scratch(M, D), scratch(M, F)
        part_buf = scratch(-(-F // D), M, D)  # the W2 product's ceil(F / D) partials
        ca_o, ca_ml = scratch(B, H, NC, R, D // H), scratch(B, H, NC, R, 2)
        ca_bl = scratch(B, H, R)
        w_ptrs = (ctypes.c_void_p * len(W_ORDER))(*[weights[n].data_ptr() for n in W_ORDER])
        ks = k_scales.data_ptr() if kv_int8 else 0
        vs = v_scales.data_ptr() if kv_int8 else 0
        flags = self.library_flags(D, D // H)
        fn = self._launcher_for(flags)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(x.data_ptr(), x_out.data_ptr(), x_scratch.data_ptr(), y_buf.data_ptr(),
                    k_caches.data_ptr(), v_caches.data_ptr(), mem_k.data_ptr(),
                    mem_v.data_ptr(), ks, vs, mask_i8.data_ptr(), log_m.data_ptr(), w_ptrs,
                    q_buf.data_ptr(), attn_buf.data_ptr(), part_buf.data_ptr(),
                    h_buf.data_ptr(), ca_o.data_ptr(), ca_ml.data_ptr(), ca_bl.data_ptr(),
                    B, G, D, num_heads, depth, C, Sp, F, int(step), int(valid_len),
                    int(has_bias_col), int(kv_int8), int(ct == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"fused_decode_launch failed with error {rc}: "
                               f"{self.errors.get(rc, 'a CUDA error')}")
        self.launches += 1
        self._last_flags = flags
        return x_out, k_caches, v_caches

    def plan(self, B: int, G: int, D: int, H: int, C: int, Sp: int, F: int, kv_int8: bool,
             bf16: bool) -> Tuple[int, str]:
        """(bytes of shared memory a block takes, schedule) of a launch at
        this shape, from the library built for its widths: "flagship" where
        the flagship's schedule fits (every loop and layout fixed at compile
        time), else "general" (``smem_plan``)."""
        lib = load_library(self.source, self.library_flags(D, D // H))
        fn = lib.fused_decode_plan
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_longlong
        general = ctypes.c_int(1)
        smem = fn(B, G, D, H, C, Sp, F, int(kv_int8), int(bf16), ctypes.byref(general))
        if smem < 0:
            raise ValueError(f"the library for D={D}, Dh={D // H} does not take this shape")
        return int(smem), "general" if general.value else "flagship"

    def stage_us(self, depth: int) -> Dict[str, object]:
        """Device microseconds of each stage of the last launch, averaged over
        the layers (``STAGES``), of the last layer's closing LayerNorm, of the
        phases of block 0's first cross-attention unit and of its first tile
        of four GEMM stages (``GEMM_TIMED``, ``GEMM_PHASES``), and of one
        grid barrier with no work around it (the timing build ends with
        four); only for a binding built with ``STAGE_TIMING_FLAGS``."""
        if "-DFD_STAGE_TIMING" not in self.flags:
            raise RuntimeError("stage times need a build with STAGE_TIMING_FLAGS")
        if depth > MAX_TIMED_DEPTH:
            raise ValueError(f"the timing build records the first {MAX_TIMED_DEPTH} layers")
        lib = load_library(self.source, self._last_flags)
        k = len(STAGES)
        n = 2 + k * MAX_TIMED_DEPTH
        marks = (ctypes.c_ulonglong * n)()
        sub = (ctypes.c_ulonglong * 8)()
        bar = (ctypes.c_ulonglong * 5)()
        gemm = (ctypes.c_ulonglong * 20)()
        for rc in (lib.fused_decode_stage_ns(marks, n), lib.fused_decode_sub_ns(sub),
                   lib.fused_decode_barrier_ns(bar), lib.fused_decode_gemm_ns(gemm)):
            if rc != 0:
                raise RuntimeError(f"reading the stage times failed with CUDA error {rc}")
        ends = [marks[i] for i in range(1 + k * depth + 1)]  # start, every stage, closing LN
        per = {name: sum(ends[1 + li * k + i] - ends[li * k + i] for li in range(depth))
               / depth / 1e3 for i, name in enumerate(STAGES)}
        return {"total_us": (ends[-1] - ends[0]) / 1e3,
                "grid_barriers": k * depth + 1,
                "empty_grid_barrier_us": (bar[4] - bar[0]) / 4 / 1e3,
                "per_layer_us": per,
                "final_ln3_us": (ends[-1] - ends[-2]) / 1e3,
                "cross_attention_unit0_us": {
                    name: (sub[i + 1] - sub[i]) / 1e3
                    for i, name in enumerate(("wait", "logits", "softmax", "weighted_sum"))},
                "gemm_tile0_us": {
                    tile: {name: (gemm[5 * g + i + 1] - gemm[5 * g + i]) / 1e3
                           for i, name in enumerate(GEMM_PHASES)}
                    for g, tile in enumerate(GEMM_TIMED)}}


# the stages of one layer, in the order of the kernel's grid barriers. The
# LayerNorms run inside the A-operand loads of q_kv (LN3 of the layer
# before), cq_proj (LN1) and mlp1 (LN2); the cross-attention's chunks are
# combined inside the A-operand load of co_proj.
STAGES = ("q_kv_ln3", "self_attention", "o_proj", "cq_proj_ln1", "cross_attention_chunks",
          "co_proj_combine", "mlp1_ln2", "mlp2")
STAGE_TIMING_FLAGS = ("-DFD_STAGE_TIMING",)  # a build that records each barrier's time
MAX_TIMED_DEPTH = 16  # layers whose stage times the timing build records
# the GEMM tiles whose phases the timing build records (block 0's first
# tile of each), and the phases: the A rows prepared (LayerNorm or combine;
# the W slab in flight), the wait for the slab, the 3xTF32 products, the sum
# of the warps' k slices and the write
GEMM_TIMED = ("o_proj_layer0", "q_kv_ln3_layer1", "mlp1_ln2_layer0",
              "co_proj_combine_layer0")
GEMM_PHASES = ("a_prep", "wait", "mma", "epilogue")

FUSED_DECODE = {
    "video": FusedDecodeKernel("video", "multimodal_feature_learning_tpu/ops/fused_decode.py:202"),
    "batch": FusedDecodeKernel("batch", "multimodal_feature_learning_tpu/ops/fused_decode.py:376"),
}


def fused_decode_step(x, k_caches, v_caches, step: int, valid_len: int, mem_k, mem_v,
                      k_scales, v_scales, mask_i8, log_m, weights, *, G: int,
                      num_heads: int, has_bias_col: bool, grid_mode: str = "video",
                      batch_tile: int = 0):
    """One decode step through all layers; the contract of JAX
    ``fused_decode_step``. x (B, 2G, D) embedded pair, caches (depth, B,
    Tc*G, D) written in place at rows step*G + e, memory K/V (depth, B, Sp,
    D) f32 or int8 with scales (depth, B, 1, Sp), ``mask_i8`` and ``log_m``
    from ``decode_masks``. Returns (x_out, k_caches, v_caches)."""
    if grid_mode not in FUSED_DECODE:
        raise ValueError(f"grid_mode must be 'video' or 'batch', got {grid_mode!r}")
    if x.device.type == "cpu":
        if grid_mode == "batch":
            batch_tile_for(x.shape[0], batch_tile)
        return fused_decode_step_plain(
            x, k_caches, v_caches, step, valid_len, mem_k, mem_v, k_scales, v_scales,
            mask_i8, log_m, weights, G=G, num_heads=num_heads, has_bias_col=has_bias_col)
    return FUSED_DECODE[grid_mode](
        x, k_caches, v_caches, step, valid_len, mem_k, mem_v, k_scales, v_scales,
        mask_i8, log_m, weights, G=G, num_heads=num_heads, has_bias_col=has_bias_col,
        batch_tile=batch_tile)
