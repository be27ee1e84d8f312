"""The port's evaluation forward, beam search and eval step against the JAX
package's.

At ``_small_cfg`` dims with the differentiable context mask (the config
default), f32 on the CPU, dropout off (both sides run in eval mode), the
same flax params on both sides and the same synthetic batch (numpy seed 0,
``data/anet.py::synthetic_batches``, B=2). ``forward_eval`` in each
val_mode: matched indices, final and auxiliary, equal; captions equal,
token for token; the teacher-forced log-probabilities of every caption
layer within 1e-4 (f32 sums in another order through 2+2 transformer and 2
caption layers); segments within 1e-5. The fused decode runs JAX's Pallas
kernel in interpret mode. ``make_eval_step``'s loss terms, every
``loss_caption_{i}`` included, within 1e-4 relative (atol 1e-6)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, PAD, VOCAB_SIZE, build_jax_model, build_port_model, flatten_params,
    jax_small_cfg, perturb, torch_cfg_like,
)

from multimodal_feature_learning_tpu.engine.evaluate import make_eval_step as jax_eval_step
from multimodal_feature_learning_tpu.models import caption_decoder as jcd
from multimodal_feature_learning_tpu.models import criterion as jcrit
from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
from multimodal_feature_learning_tpu_torch.models import caption_decoder as tcd
from multimodal_feature_learning_tpu_torch.models import criterion as tcrit
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

LOGP_ATOL = 1e-4
LOSS_REL = 1e-4

MODES = {
    "one_by_one": ("one_by_one", {}),
    "one_by_one_faster": ("one_by_one", {"faster_eval": True}),
    "teacher_forcing": ("teacher_forcing", {}),
    "beam3": ("beam", {"beam_size": 3}),
    "beam3_lp": ("beam", {"beam_size": 3, "length_penalty": 0.6}),
    "serve": ("serve", {}),
}


@pytest.fixture(scope="module")
def pair():
    """(jax model, flax params, port model, numpy batch, port batch)."""
    jcfg = jax_small_cfg()
    jmodel, params = build_jax_model(jcfg)
    batch = next(synthetic_batches(torch_cfg_like(jcfg), 2, VOCAB_SIZE, seed=0))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    return jmodel, params, build_port_model(jcfg, params), batch, batch_to_device(batch, "cpu")


def assert_outputs_match(ref, got):
    """forward_eval's 5-tuples of both sides."""
    (rout, rcap, ridx, raux, rmask), (gout, gcap, gidx, gaux, gmask) = ref, got
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    assert (gaux is None) == (raux is None)
    if raux is not None:
        np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
    np.testing.assert_allclose(gout["pred_segments"].numpy(), np.asarray(rout["pred_segments"]),
                               rtol=0, atol=1e-5)
    assert gcap.shape == np.asarray(rcap).shape
    np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap))
    for key in ("pred_captions", "aux_outputs", "aux_outputs_caption"):
        assert (key in gout) == (key in rout), key
    if "pred_captions" in rout:
        np.testing.assert_allclose(gout["pred_captions"].numpy(),
                                   np.asarray(rout["pred_captions"]), rtol=0, atol=LOGP_ATOL)
        assert len(gout["aux_outputs_caption"]) == len(rout["aux_outputs_caption"]) > 0
        for g, r in zip(gout["aux_outputs_caption"], rout["aux_outputs_caption"]):
            np.testing.assert_allclose(g["pred_captions"].numpy(),
                                       np.asarray(r["pred_captions"]), rtol=0, atol=LOGP_ATOL)


@pytest.mark.parametrize("case", list(MODES))
def test_forward_eval_matches_jax(pair, case):
    jmodel, params, tmodel, batch, tb = pair
    mode, kw = MODES[case]
    ref = jmodel.forward_eval(params, batch, mode, **kw)
    got = tmodel.forward_eval(tb, mode, **kw)
    assert_outputs_match(ref, got)
    caps = got[1]
    assert len({tuple(r) for r in caps.tolist()}) > 1  # not a degenerate decode
    expected_len = tmodel.seq_len - 1 if mode == "teacher_forcing" else tmodel.seq_len + 1
    assert caps.shape == (tb["cap_tokens"].shape[0] * tmodel.max_gt, expected_len)


@pytest.mark.parametrize("grid", ["video", "batch"])
def test_fused_forward_eval_matches_jax(pair, monkeypatch, grid):
    """``decode_impl="fused"`` on both sides, JAX's Pallas kernel in
    interpret mode, as ``tests/test_torch_fused_decode.py`` runs it."""
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
    from multimodal_feature_learning_tpu.ops import fused_decode as jfd

    _, params, tmodel, batch, tb = pair
    jcfg = jax_small_cfg()
    jcfg.decode_impl, jcfg.decode_fused_grid = "fused", grid
    jmodel = jax_build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    orig = jfd.fused_decode_step
    monkeypatch.setattr(jfd, "fused_decode_step",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    ref = jmodel.forward_eval(params, batch, "one_by_one")
    tmodel.decode_impl, tmodel.decode_fused_grid = "fused", grid
    try:
        got = tmodel.forward_eval(tb, "one_by_one")
    finally:
        tmodel.decode_impl, tmodel.decode_fused_grid = "xla", "video"
    assert_outputs_match(ref, got)


# -- beam search on the caption decoder alone ----------------------------------

B, G, S, D, DEPTH, H, VOCAB, LC = 2, 3, 12, 32, 2, 2, 30, 7


@pytest.fixture(scope="module")
def decoder():
    """(flax module, params, port module, memory (B,S,D), pad (N,S),
    zeroed (N,S)) with params perturbed from a numpy seed."""
    jmod = jcd.UnimodalCaptionDecoder(vocab_size=VOCAB, seq_len=LC, d_model=D, depth=DEPTH,
                                      num_heads=H)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((B * G, LC), jnp.int32),
                       jnp.zeros((B * G, S, D)))
    params = jax.tree_util.tree_map(jnp.asarray, perturb(params, seed=2, scale=0.3))
    tmod = tcd.UnimodalCaptionDecoder(VOCAB, D, DEPTH, H)
    load_flax_params(tmod, flatten_params(params))
    rng = np.random.default_rng(1)
    memory = rng.normal(size=(B, S, D)).astype(np.float32)
    pad = rng.random((B * G, S)) < 0.3
    zeroed = rng.random((B * G, S)) < 0.4
    return jmod, params, tmod.eval(), memory, pad, zeroed


def decoder_inputs(decoder, grouped: bool):
    """(memory, groups) as both sides take them: per video with groups = G,
    or one memory row per caption row."""
    memory = decoder[3]
    return (memory, G) if grouped else (np.repeat(memory, G, axis=0), 1)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_beam_search_decode_matches_jax(decoder, grouped, length_penalty):
    jmod, params, tmod, _, pad, zeroed = decoder
    memory, groups = decoder_inputs(decoder, grouped)
    z = zeroed if grouped else None
    ref = jcd.beam_search_decode(
        jmod, params, jnp.asarray(memory), jnp.asarray(pad), LC, BOS, EOS, PAD, beam_size=4,
        length_penalty=length_penalty, groups=groups,
        zeroed_mask=None if z is None else jnp.asarray(z))
    with torch.no_grad():
        got = tcd.beam_search_decode(
            tmod, torch.from_numpy(memory), torch.from_numpy(pad), LC, BOS, EOS, PAD,
            beam_size=4, length_penalty=length_penalty, groups=groups,
            zeroed_mask=None if z is None else torch.from_numpy(z))
    assert got.shape == (B * G, LC + 1) and got.dtype == torch.long
    assert len({tuple(r) for r in got.tolist()}) > 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_beam1_equals_greedy(decoder, grouped):
    _, _, tmod, _, pad, zeroed = decoder
    memory, groups = decoder_inputs(decoder, grouped)
    z = torch.from_numpy(zeroed) if grouped else None
    args = (tmod, torch.from_numpy(memory), torch.from_numpy(pad), LC, BOS, EOS, PAD)
    with torch.no_grad():
        greedy = tcd.greedy_decode(*args, groups=groups, zeroed_mask=z)
        beam = tcd.beam_search_decode(*args, beam_size=1, groups=groups, zeroed_mask=z)
    assert torch.equal(beam, greedy)


def test_teacher_forced_log_probs_match_jax(decoder):
    """The teacher-forced pass's f32 log-probabilities of every layer, JAX's
    default output; training keeps the raw logits."""
    jmod, params, tmod, memory, pad, zeroed = decoder
    tgt = np.random.default_rng(3).integers(0, VOCAB, size=(B * G, LC - 1)).astype(np.int32)
    tgt[:, 0] = BOS
    causal = jcd.make_causal_mask(LC - 1)
    ref = jax.jit(lambda p: jmod.apply(
        p, jnp.asarray(tgt), jnp.asarray(memory), causal, jnp.asarray(tgt == PAD),
        jnp.asarray(pad), groups=G, zeroed_mask=jnp.asarray(zeroed)))(params)
    args = (torch.from_numpy(tgt).long(), torch.from_numpy(memory),
            tcd.make_causal_mask(LC - 1), torch.from_numpy(tgt == PAD), torch.from_numpy(pad))
    with torch.no_grad():
        got = tmod(*args, groups=G, zeroed_mask=torch.from_numpy(zeroed), log_probs=True)
        logits = tmod(*args, groups=G, zeroed_mask=torch.from_numpy(zeroed))
    assert got.dtype == torch.float32 and got.shape == (DEPTH, B * G, LC - 1, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LOGP_ATOL)
    torch.testing.assert_close(torch.log_softmax(logits, dim=-1), got)


def test_caption_loss_from_log_probs_matches_jax():
    rng = np.random.default_rng(4)
    log_pred = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(5, 6, VOCAB)), jnp.float32))
    target = rng.integers(0, VOCAB, size=(5, 6)).astype(np.int32)
    target[:, -2:] = PAD
    ref = float(jcrit.label_smoothing_kl(log_pred, jnp.asarray(target), PAD, 0.5))
    got = float(tcrit.label_smoothing_kl(torch.from_numpy(np.asarray(log_pred)),
                                         torch.from_numpy(target), PAD, 0.5))
    assert abs(got - ref) <= 1e-5 * abs(ref)


# -- the eval step -------------------------------------------------------------


def jax_criterion(jcfg):
    weight_dict = jcrit.build_weight_dict(jcfg)
    crit = jcrit.SetCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=weight_dict,
                              losses=list(jcfg.dvc.losses), pad_idx=PAD,
                              smoothing=jcfg.dvc.smoothing)
    return crit, weight_dict


def assert_losses_match(ref, got):
    ref = {k: float(v) for k, v in ref.items()}
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k, r in ref.items():
        assert abs(float(got[k]) - r) <= max(LOSS_REL * abs(r), 1e-6), (k, float(got[k]), r)


@pytest.mark.parametrize("case", ["one_by_one", "teacher_forcing"])
def test_eval_step_matches_jax(pair, case):
    jmodel, params, tmodel, batch, tb = pair
    mode, kw = MODES[case]
    jcfg = jax_small_cfg()
    crit, weight_dict = jax_criterion(jcfg)
    rcap, rseg, rloss = jax_eval_step(jmodel, crit, weight_dict, mode, **kw)(params, batch)
    criterion, tweights = tcrit.build_criterion(torch_cfg_like(jcfg), PAD)
    gcap, gseg, gloss = make_eval_step(tmodel, criterion, tweights, mode, **kw)(tb)
    np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap))
    np.testing.assert_allclose(gseg.numpy(), np.asarray(rseg), rtol=1e-5, atol=1e-5)
    captions = [k for k in rloss if k.startswith("loss_caption")]
    assert len(captions) == jcfg.dvc.caption.depth  # loss_caption and each loss_caption_{i}
    assert_losses_match(rloss, gloss)


def test_serve_eval_step_has_the_final_layer_losses(pair):
    """``serve`` matches the final decoder layer only and runs no
    teacher-forced pass. The JAX package's eval step cannot take it: its
    criterion reads the caption log-probabilities that ``serve`` does not
    make, and the encoder's auxiliary outputs with auxiliary matchings that
    ``serve`` does not make. The port leaves both losses out, so its losses
    are JAX's criterion without the caption loss on JAX's serve outputs
    without the encoder's auxiliary outputs."""
    jmodel, params, tmodel, batch, tb = pair
    jcfg = jax_small_cfg()
    crit, weight_dict = jax_criterion(jcfg)
    crit.losses = [k for k in crit.losses if k != "captions"]

    def serve_losses(p, b):
        out, _, idx, idx_aux, mask = jmodel.forward_eval(p, b, "serve")
        assert idx_aux is None and "aux_outputs_enc" in out
        out = {k: v for k, v in out.items() if k != "aux_outputs_enc"}
        losses = crit(out, b, idx, idx_aux, mask)
        losses["loss"] = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        return losses

    ref = jax.jit(serve_losses)(params, batch)
    criterion, tweights = tcrit.build_criterion(torch_cfg_like(jcfg), PAD)
    _, _, got = make_eval_step(tmodel, criterion, tweights, "serve")(tb)
    assert "loss_caption" not in got and "loss_bbox_0" not in got
    assert_losses_match(ref, got)


def test_eval_config_defaults_are_jax_defaults():
    from multimodal_feature_learning_tpu.config import load_config

    jcfg, cfg = load_config(), Config()
    for name in ("val_mode", "faster_eval", "beam_size", "length_penalty"):
        assert getattr(cfg.eval, name) == jcfg.eval[name], name


def test_unknown_val_mode_raises(pair):
    _, _, tmodel, _, tb = pair
    with pytest.raises(ValueError, match="val_mode"):
        tmodel.forward_eval(tb, "greedy")
    with pytest.raises(ValueError, match="val_mode"):
        make_eval_step(tmodel, None, {}, "greedy")
