"""The port's ``SetCriterion`` against the JAX package's, on the same outputs.

The JAX model's ``forward_train`` output (small dims, dropout 0, a
synthetic batch) goes to both criteria with the same matchings, with and
without the differentiable context mask (``contexts`` loss). Every loss
term: rel 1e-5 (atol 1e-6), the gap of f32 sums taken in another order. The
pieces are held on their own too: the from-logits caption KL against JAX's
(values and gradients), the Gaussian-masked counter loss, the
mask-prediction target with ties in the attention map, and the weight
dict."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    PAD, VOCAB_SIZE, build_jax_model, jax_small_cfg, no_dropout, torch_cfg_like,
)

from multimodal_feature_learning_tpu.models import criterion as jcrit
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.models import criterion as tcrit


def to_torch(x):
    if isinstance(x, dict):
        return {k: to_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_torch(v) for v in x]
    if isinstance(x, (jax.Array, np.ndarray)):
        return torch.from_numpy(np.array(x))
    return x


@pytest.fixture(scope="module", params=[True, False], ids=["ctxmask", "cropmask"])
def outputs(request):
    jcfg = no_dropout(jax_small_cfg(use_differentiable_mask=request.param))
    jmodel, params = build_jax_model(jcfg)
    batch = next(synthetic_batches(torch_cfg_like(jcfg), 4, VOCAB_SIZE, seed=5))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    static = ("temporal_shapes", "level_start_index", "caption_head")

    def forward(p, b):
        out, indices, indices_aux, memory_mask = jmodel.forward_train(
            p, b, jax.random.PRNGKey(0))
        return ({k: v for k, v in out.items() if k not in static}, indices, indices_aux,
                memory_mask)

    out, indices, indices_aux, memory_mask = jax.jit(forward)(params, batch)
    out = dict(out)
    out["temporal_shapes"] = tuple(jmodel.temporal_shapes)
    starts = np.cumsum((0,) + tuple(jmodel.temporal_shapes[:-1]))
    out["level_start_index"] = tuple(int(s) for s in starts)
    out["caption_head"] = "logits"
    return jcfg, out, batch, indices, indices_aux, memory_mask


def test_every_loss_term_matches_jax(outputs):
    jcfg, out, batch, indices, indices_aux, memory_mask = outputs
    weight_dict = jcrit.build_weight_dict(jcfg)
    ref = jcrit.SetCriterion(num_classes=200, weight_dict=weight_dict,
                             losses=list(jcfg.dvc.losses), pad_idx=PAD,
                             smoothing=jcfg.dvc.smoothing)(
        out, batch, indices, indices_aux, memory_mask)
    crit, _ = tcrit.build_criterion(torch_cfg_like(jcfg), PAD)
    got = crit(to_torch(out), to_torch(batch), to_torch(indices), to_torch(indices_aux),
               to_torch(memory_mask))
    assert set(got) == set(ref)
    expected = {"loss_counter", "loss_bbox", "loss_giou", "loss_caption",
                "loss_mask_prediction", "loss_caption_0", "loss_bbox_0", "loss_bbox_enc_0"}
    if jcfg.use_differentiable_mask:
        expected.add("loss_context")
    assert expected <= set(got)
    for k, r in ref.items():
        r = float(r)
        assert abs(float(got[k]) - r) <= max(1e-5 * abs(r), 1e-6), (k, float(got[k]), r)


def test_caption_kl_from_logits_matches_jax_with_gradients():
    rng = np.random.default_rng(0)
    D, N, S, V = 3, 5, 7, 40
    logits = (3 * rng.normal(size=(D, N, S, V))).astype(np.float32)
    target = rng.integers(4, V, size=(N, S)).astype(np.int32)
    target[:, -2:] = PAD
    target[0, 3] = PAD
    ref_fn = lambda x: jcrit.label_smoothing_kl_logits_stack(x, jnp.asarray(target), PAD, 0.5)
    ref = np.asarray(ref_fn(jnp.asarray(logits)))
    ref_g = np.asarray(jax.grad(lambda x: ref_fn(x).sum())(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = tcrit.label_smoothing_kl_logits_stack(x, torch.from_numpy(target), PAD, 0.5)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=0, atol=1e-6)
    # the log-prob path of the JAX package gives the same loss
    logp = jax.nn.log_softmax(jnp.asarray(logits[-1]), axis=-1)
    np.testing.assert_allclose(
        float(got[-1].detach()), float(jcrit.label_smoothing_kl(logp, jnp.asarray(target), PAD, 0.5)),
        rtol=1e-5)


@pytest.mark.parametrize("gau_mask", [1, 0])
def test_counter_loss_matches_jax(gau_mask):
    rng = np.random.default_rng(1)
    B, C = 6, 11
    x = rng.normal(size=(B, C)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    w = np.asarray(jcrit.COUNTER_CLASS_RATE[:C], np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], bool)
    ref = jcrit.cross_entropy_with_gaussian_mask(x, onehot, w, gau_mask, 1.0, valid)
    got = tcrit.cross_entropy_with_gaussian_mask(*(torch.from_numpy(a) for a in (x, onehot, w)),
                                                 gau_mask, 1.0, torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_mask_prediction_target_with_ties_matches_jax():
    """Ties in the attention map (two queries on one token, zero weights)
    and a padded tail: the stable sort picks the tokens lax.top_k picks."""
    rng = np.random.default_rng(2)
    B, layers, Q, H, shapes, P = 2, 2, 3, 2, (8, 4), 2
    S, L = sum(shapes), len(shapes)
    loc = rng.uniform(0, 1, size=(B, layers, Q, H, L, P)).astype(np.float32)
    loc[:, :, 1] = loc[:, :, 0]
    aw = rng.uniform(size=loc.shape).astype(np.float32)
    aw[0, :, 2] = 0.0
    mask = np.zeros((B, S), bool)
    mask[1, 6:8] = True
    out = {
        "backbone_mask_prediction": rng.normal(size=(B, S)).astype(np.float32),
        "temporal_shapes": shapes, "level_start_index": (0, 8),
        "sampling_locations_dec": loc, "attn_weights_dec": aw, "mask_flatten": mask,
        "sparse_token_nums": np.array([4, 3], np.int32),
        "backbone_topk_proposals": np.zeros((B, 5), np.int32),
    }
    targets = {"batch_valid": np.array([True, True])}
    ref = jcrit.SetCriterion(200, {}, [], PAD).loss_mask_prediction(
        {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in out.items()},
        targets, None, 1.0, 1.0)
    got = tcrit.SetCriterion([], PAD).loss_mask_prediction(
        to_torch(out), to_torch(targets), None, 1.0, 1.0)
    np.testing.assert_allclose(float(got["loss_mask_prediction"]),
                               float(ref["loss_mask_prediction"]), rtol=1e-6)


@pytest.mark.parametrize("mask", [True, False])
def test_weight_dict_matches_jax(mask):
    jcfg = jax_small_cfg(use_differentiable_mask=mask)
    assert tcrit.build_weight_dict(torch_cfg_like(jcfg)) == jcrit.build_weight_dict(jcfg)


def test_decoder_attention_map_and_coverage_match_jax():
    from multimodal_feature_learning_tpu.ops import dam as jdam
    from multimodal_feature_learning_tpu_torch.ops import dam as tdam

    rng = np.random.default_rng(3)
    B, layers, Q, H, shapes, P = 2, 3, 4, 2, (9, 5, 3), 2
    loc = rng.uniform(-0.1, 1.1, size=(B, layers, Q, H, len(shapes), P)).astype(np.float32)
    aw = rng.uniform(size=loc.shape).astype(np.float32)
    ref = np.asarray(jdam.attn_map_to_flat_grid(shapes, (0, 9, 14), jnp.asarray(loc),
                                                jnp.asarray(aw)))
    got = tdam.attn_map_to_flat_grid(shapes, (0, 9, 14), torch.from_numpy(loc),
                                     torch.from_numpy(aw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    topk = rng.integers(0, sum(shapes), size=(B, 6))
    flat_topk = tdam.idx_to_flat_grid(sum(shapes), torch.from_numpy(topk))
    np.testing.assert_array_equal(flat_topk.numpy(),
                                  np.asarray(jdam.idx_to_flat_grid(sum(shapes), jnp.asarray(topk))))
    attn = got.sum(axis=(1, 2))
    for c_got, c_ref in zip(tdam.compute_corr(flat_topk, torch.from_numpy(attn), shapes),
                            jdam.compute_corr(np.asarray(flat_topk), attn, shapes)):
        np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=1e-5)
