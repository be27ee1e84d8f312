"""The caption decoder's two options of the configuration,
``dvc.caption.pre_norm`` and ``dvc.caption.return_intermediate``, in the
port against the JAX package, in every family where JAX honours them.

At ``_small_cfg`` dims on the CPU, f32, every dropout rate 0, the same flax
params on both sides (a JAX init perturbed from a numpy seed, carried into
the port by ``utils.weights.load_flax_params``, strictly: the pre-norm
layer has the post-norm layer's parameters) and the same synthetic batch
(numpy seed 0). Cases:

- ``pre_norm`` on in the sparse and the regular families (JAX's
  ``UnimodalCaptionDecoderLayer`` with its pre-norm branch);
- ``return_intermediate`` off in the sparse, the multimodal and the regular
  families: the caption stack is the last layer alone, so there are no
  per-layer caption losses (``loss_caption_{i}``) and no
  ``aux_outputs_caption``.

Each case is held as the post-norm parity test of its family holds the
same quantities (``test_torch_train.py`` / ``test_torch_eval.py``,
``test_torch_multimodal.py``, ``test_torch_regular.py``): training
(``forward_train`` + criterion, JAX compiled) matchings equal, loss keys
equal and every term within rel 1e-5 (atol 1e-6), gradient leaves within
2e-4 x max |g_leaf|; teacher-forced ``forward_eval`` (JAX eager) matchings
and argmax captions equal, every caption layer's log-probabilities within
1e-4 (2e-4 in the multimodal family), segments within 1e-5 (3e-5 in the
regular family, as its file says why).

Under ``pre_norm`` every KV-cached decode of the port refuses the model with
a ``ValueError`` naming the option, before any kernel or layer runs: the
greedy, beam and fused decodes, the continuous server's chunks, both
servers and every decoding ``val_mode``. JAX's plain decode asserts the
same; its fused decode has no such check.

The multimodal families have no pre-norm caption layer in JAX; they ignore
``pre_norm``, and so does the port (its tree and losses are unchanged)."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, LOGP_ATOL, PAD, VOCAB_SIZE, array_batch, assert_grads_match,
    assert_losses_match, build_jax_family, build_port_family, family_cfg, flatten_params,
    jax_losses_and_grads, no_dropout, perturb, port_losses_and_grads, small_vocab,
    torch_cfg_like,
)
from test_torch_regular import SEG_ATOL, regular_cfg, without_dropout

from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.models import caption_decoder as tcd
from multimodal_feature_learning_tpu_torch.models.layers import PRE_NORM_DECODE
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

# name: (family, pre_norm, return_intermediate)
CASES = {
    "sparse_pre_norm": ("sparse", True, True),
    "regular_pre_norm": ("regular", True, True),
    "sparse_last_layer": ("sparse", False, False),
    "mm_last_layer": ("mm", False, False),
    "regular_last_layer": ("regular", False, False),
}
MM_LOGP_ATOL = 2 * LOGP_ATOL
REFUSED = "dvc.caption.pre_norm"


def jax_regular(jcfg, batch):
    """(model, params) of JAX's RegularDVC, its query decoder's fixed
    dropout at 0, as ``test_torch_regular.py`` builds it."""
    from multimodal_feature_learning_tpu.models.regular_dvc import build_regular_model

    jmodel = build_regular_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    jmodel.proposal_net = jmodel.proposal_net.clone(dropout=0.0)
    params = perturb(jmodel.init(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in batch.items()}), 0)
    return jmodel, params


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, JAX config, JAX model, params, port model, numpy batch, port
    batch, (JAX's, the port's) training forward)."""
    family, pre_norm, return_intermediate = CASES[request.param]
    if family == "regular":
        jcfg = regular_cfg(raw=False)
    else:
        jcfg = family_cfg(family)
    jcfg = no_dropout(jcfg)
    jcfg.dvc.caption.pre_norm = pre_norm
    jcfg.dvc.caption.return_intermediate = return_intermediate
    batch = array_batch(torch_cfg_like(jcfg), 2)
    if family == "regular":
        jmodel, params = jax_regular(jcfg, batch)
        model, criterion, weight_dict = build_model_and_criterion(
            torch_cfg_like(jcfg), small_vocab(), device="cpu")
        load_flax_params(model, flatten_params(params))
        without_dropout(model)
    else:
        jmodel, params = build_jax_family(jcfg)
        model, criterion, weight_dict = build_port_family(jcfg, params)
    tb = batch_to_device(batch, "cpu")
    trained = (jax_losses_and_grads(jcfg, jmodel, params, batch),
               port_losses_and_grads(model, criterion, weight_dict, tb))
    return request.param, jcfg, jmodel, params, model, batch, tb, trained


def test_the_options_reach_the_caption_decoder(case):
    name, jcfg, *_ = case
    model = case[4]
    family, pre_norm, return_intermediate = CASES[name]
    assert model.caption.return_intermediate is return_intermediate
    layers = list(model.caption.decoder)
    assert len(layers) == jcfg.dvc.caption.depth == 2
    if family != "mm":
        assert model.caption.pre_norm is pre_norm
        assert all(layer.pre_norm is pre_norm for layer in layers)


def test_train_matchings_losses_and_gradients_match_jax(case):
    name, *_, trained = case
    _, _, return_intermediate = CASES[name]
    (ridx, raux, rloss, rgrad), (gidx, gaux, gloss, ggrad) = trained
    np.testing.assert_array_equal(gidx, ridx)
    np.testing.assert_array_equal(gaux, raux)
    assert_losses_match(rloss, gloss, min_terms=9)
    per_layer = sorted(k for k in gloss if k.startswith("loss_caption_"))
    assert per_layer == ([] if not return_intermediate else ["loss_caption_0"]), per_layer
    assert "loss_caption" in gloss
    assert assert_grads_match(rgrad, ggrad) > 0.85 * len(rgrad)


def in_f64(jmodel, params, batch, model, tb):
    """JAX's teacher-forced ``forward_eval`` under ``jax.enable_x64``,
    compiled, and the port's on a float64 copy of its model, each over the
    same params and batch in float64."""
    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(
            lambda p, b: jmodel.forward_eval(p, b, "teacher_forcing"))(
                jax.tree_util.tree_map(f64, params), {k: f64(v) for k, v in batch.items()}))
    model = copy.deepcopy(model).double()
    if hasattr(model, "compute_dtype"):
        model.compute_dtype = torch.float64
    got = model.forward_eval({k: v.double() if v.is_floating_point() else v
                              for k, v in tb.items()}, "teacher_forcing")
    return ref, got


def test_teacher_forced_eval_matches_jax(case):
    """f32 on both sides, JAX eager; a pre-norm model in float64 on both
    sides (``in_f64``). Its last layer's residual stream reaches the head
    without a LayerNorm, so its log-probabilities are large (to -92 at
    these weights), and in f32 each side lies up to 1.1e-4 from a float64
    evaluation of the same model (measured: JAX 8.0e-5, the port 1.14e-4),
    above the family's 1e-4; in float64 the two sides part only where both
    cast to f32 (the log-softmax and the segment head: 7.6e-5 measured)."""
    name, jcfg, jmodel, params, model, batch, tb, _ = case
    family, pre_norm, return_intermediate = CASES[name]
    logp_atol = MM_LOGP_ATOL if family == "mm" else LOGP_ATOL
    if pre_norm:
        (rout, rcap, ridx, raux, _), (gout, gcap, gidx, gaux, _) = in_f64(
            jmodel, params, batch, model, tb)
    else:
        rout, rcap, ridx, raux, _ = jmodel.forward_eval(params, batch, "teacher_forcing")
        gout, gcap, gidx, gaux, _ = model.forward_eval(tb, "teacher_forcing")
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux))
    np.testing.assert_allclose(gout["pred_segments"].numpy(), np.asarray(rout["pred_segments"]),
                               rtol=0, atol=SEG_ATOL if family == "regular" else 1e-5)
    np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap))
    assert len({tuple(r) for r in gcap.tolist()}) > 1  # not a degenerate argmax
    np.testing.assert_allclose(gout["pred_captions"].numpy(), np.asarray(rout["pred_captions"]),
                               rtol=0, atol=logp_atol)
    n_aux = jcfg.dvc.caption.depth - 1 if return_intermediate else 0
    assert len(gout["aux_outputs_caption"]) == len(rout["aux_outputs_caption"]) == n_aux
    for g, r in zip(gout["aux_outputs_caption"], rout["aux_outputs_caption"]):
        np.testing.assert_allclose(g["pred_captions"].numpy(), np.asarray(r["pred_captions"]),
                                   rtol=0, atol=logp_atol)


def refusals(model, tb):
    """{path: a call of the port that must refuse a pre-norm caption
    decoder}: every decode of the sparse family (the model-level entry
    points and the decode functions themselves), or the decoding val_modes
    of the regular family."""
    modes = {"one_by_one": lambda: model.forward_eval(tb, "one_by_one"),
             "beam": lambda: model.forward_eval(tb, "beam", beam_size=2)}
    if not hasattr(model, "forward_serve"):
        return modes
    from multimodal_feature_learning_tpu_torch.serve import ContinuousDVCServer, DVCServer

    cap = model.caption
    N, S, D = 2 * model.max_gt, model.num_tokens, cap.head.in_features
    memory = torch.zeros((2, S, D))
    mask = torch.zeros((N, S), dtype=torch.bool)
    seq = model.seq_len
    caches = torch.zeros((cap.depth, N, seq, D))
    args = (memory, mask, seq, BOS, EOS, PAD)
    serve = (tb["video_tensor"], tb["video_mask"], tb["durations"])

    def fused_forward_serve():
        model.decode_impl = "fused"
        try:
            return model.forward_serve(*serve)
        finally:
            model.decode_impl = "xla"

    return {
        **modes,
        "serve_mode": lambda: model.forward_eval(tb, "serve"),
        "forward_serve": lambda: model.forward_serve(*serve),
        "forward_serve_fused": fused_forward_serve,
        "forward_serve_prefill": lambda: model.forward_serve_prefill(*serve),
        "dvc_server": lambda: DVCServer(model, batch_size=2),
        "continuous_server": lambda: ContinuousDVCServer(model, batch_size=2, chunk=2),
        "greedy_decode": lambda: tcd.greedy_decode(cap, *args, groups=model.max_gt),
        "greedy_decode_fused": lambda: tcd.greedy_decode(cap, *args, groups=model.max_gt,
                                                         decode_impl="fused"),
        "greedy_decode_chunk": lambda: tcd.greedy_decode_chunk(
            cap, torch.full((N, seq), PAD), torch.zeros(N, dtype=torch.bool),
            torch.ones(2, dtype=torch.long), caches, caches.clone(),
            cap.precompute_memory_kv(memory), mask, seq, EOS, PAD, model.max_gt, None,
            torch.ones(2, dtype=torch.bool), 2),
        "beam_search_decode": lambda: tcd.beam_search_decode(cap, *args, beam_size=2,
                                                             groups=model.max_gt),
        "fused_step_fn": lambda: tcd._fused_step_fn(cap, memory, mask, seq, model.max_gt, None,
                                                    "dense", "video", torch.full((N,), PAD)),
        "incremental_pair": lambda: cap.decoder[0].incremental_pair(
            torch.zeros((N, 2, D)), 0, caches[0], caches[1], 1,
            *cap.decoder[0].project_memory_kv(memory), mask, groups=model.max_gt),
    }


@pytest.mark.parametrize("case", [n for n, c in CASES.items() if c[1]], indirect=True)
def test_pre_norm_decodes_are_refused_as_in_jax(case, monkeypatch):
    """Every decode of a pre-norm model raises ``ValueError`` naming the
    option, and no MSDA call or matching runs first; JAX's plain decode
    asserts there too."""
    from multimodal_feature_learning_tpu_torch.models import dvc, msda_module

    name, _, jmodel, params, model, batch, tb, _ = case
    ran = []
    monkeypatch.setattr(msda_module, "ms_deform_attn", lambda *a: ran.append("msda"))
    monkeypatch.setattr(dvc, "batched_hungarian_torch", lambda *a: ran.append("matcher"))
    paths = refusals(model, tb)
    assert len(paths) == (2 if CASES[name][0] == "regular" else 14)
    for path, call in paths.items():
        with pytest.raises(ValueError, match=REFUSED):
            call()
        assert ran == [], (path, ran)
    assert REFUSED in PRE_NORM_DECODE
    monkeypatch.undo()
    with pytest.raises(AssertionError):  # raised while tracing, before anything runs
        jax.jit(lambda p, b: jmodel.forward_eval(p, b, "one_by_one"))(params, batch)
