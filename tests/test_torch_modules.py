"""Modules and helper functions of the port against the JAX package's.

Each flax module is initialised, its params perturbed from a numpy seed and
carried into the port's module by ``utils.weights``; both get the same numpy
inputs and run in f32 on the CPU. Modules: atol 1e-4 (f32 matmuls and
reductions summed in another order). Index and mask helpers: exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import flatten_params, perturb

from multimodal_feature_learning_tpu.data.anet import nearest_resize as jax_nearest_resize
from multimodal_feature_learning_tpu.models import base_encoder as jbase
from multimodal_feature_learning_tpu.models import dvc as jdvc
from multimodal_feature_learning_tpu.models import embeddings as jemb
from multimodal_feature_learning_tpu.models import layers as jlayers
from multimodal_feature_learning_tpu.models import msda_module as jmsda
from multimodal_feature_learning_tpu.models import transformer as jtr
from multimodal_feature_learning_tpu.ops import segment_ops as jseg
from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize
from multimodal_feature_learning_tpu_torch.models import base_encoder as tbase
from multimodal_feature_learning_tpu_torch.models import dvc as tdvc
from multimodal_feature_learning_tpu_torch.models import embeddings as temb
from multimodal_feature_learning_tpu_torch.models import layers as tlayers
from multimodal_feature_learning_tpu_torch.models import msda_module as tmsda
from multimodal_feature_learning_tpu_torch.models import transformer as ttr
from multimodal_feature_learning_tpu_torch.ops import segment_ops as tseg
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

ATOL = 1e-4
SHAPES = (24, 12, 6)  # pyramid of a 24-token grid, 3 levels


def carry(module, params):
    load_flax_params(module, flatten_params(params))
    return module.eval()


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("ref_dim", [1, 2])
def test_msdeformattn_matches_jax(ref_dim):
    rng = np.random.default_rng(0)
    B, Q, D, H, L, P = 2, 7, 32, 2, len(SHAPES), 3
    S = sum(SHAPES)
    query = rng.normal(size=(B, Q, D)).astype(np.float32)
    ref = rng.uniform(0, 1, size=(B, Q, L, ref_dim)).astype(np.float32)
    value_in = rng.normal(size=(B, S, D)).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, SHAPES[0] - 4:SHAPES[0]] = True
    jm = jmsda.MSDeformAttn(D, L, H, P, backend="gather")
    params = perturb(jm.init(jax.random.PRNGKey(0), query, ref, value_in, SHAPES, pad), 1)
    jout, jloc, jattn = jm.apply(params, query, ref, value_in, SHAPES, pad)
    tm = carry(tmsda.MSDeformAttn(D, L, H, P), params)
    with torch.no_grad():
        tout, tloc, tattn = tm(t(query), t(ref), t(value_in), SHAPES, t(pad))
    close(tout, jout)
    close(tloc, jloc)
    close(tattn, jattn)


def test_offset_bias_init_matches_jax():
    np.testing.assert_array_equal(tmsda._offset_bias_init(8, 4, 4),
                                  jmsda._offset_bias_init(8, 4, 4))


def test_base_encoder_matches_jax():
    rng = np.random.default_rng(1)
    B, T, C, D, L = 2, SHAPES[0], 48, 64, len(SHAPES)
    vf = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[1, T - 7:] = True
    dur = np.array([37.6, 120.0], np.float32)
    jm = jbase.BaseEncoder(L, D)
    params = perturb(jm.init(jax.random.PRNGKey(0), vf, mask, dur), 2)
    jsrcs, jmasks, jposes = jm.apply(params, vf, mask, dur)
    tm = carry(tbase.BaseEncoder(L, D, C), params)
    with torch.no_grad():
        tsrcs, tmasks, tposes = tm(t(vf), t(mask), t(dur))
    assert tuple(s.shape[1] for s in tsrcs) == SHAPES == tbase.pyramid_shapes(T, L)
    for a, b in zip(tsrcs, jsrcs):
        close(a, b)
    for a, b in zip(tmasks, jmasks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tposes, jposes):
        close(a, b)


def test_mask_predictor_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    jm = jlayers.MaskPredictor(32)
    params = perturb(jm.init(jax.random.PRNGKey(0), x), 3)
    tm = carry(tlayers.MaskPredictor(32, 32), params)
    with torch.no_grad():
        close(tm(t(x)), jm.apply(params, x))


@pytest.mark.parametrize("zeroed", [False, True], ids=["crop", "bias_column"])
def test_caption_layer_incremental_pair_matches_jax(zeroed):
    """One commit+predict step at position 3 of 6, grouped shared-KV
    cross-attention over a per-video memory, with and without the bias
    column of the differentiable context mask."""
    rng = np.random.default_rng(3)
    B, G, S, D, H, Tc, step = 2, 3, 13, 32, 2, 6, 3
    N = B * G
    x = rng.normal(size=(N, 2, D)).astype(np.float32)
    memory = rng.normal(size=(B, S, D)).astype(np.float32)
    k_cache = rng.normal(size=(N, Tc, D)).astype(np.float32)
    v_cache = rng.normal(size=(N, Tc, D)).astype(np.float32)
    crop = rng.uniform(size=(N, S)) < 0.5
    crop[0] = True  # an event whose crop is empty
    if zeroed:
        pad = rng.uniform(size=(N, S)) < 0.3
        zeroed_mask = crop
    else:
        pad, zeroed_mask = crop, None
    jm = jlayers.UnimodalCaptionDecoderLayer(D, H, 4.0)
    params = perturb(jm.init(jax.random.PRNGKey(0), x, np.repeat(memory, G, 0)), 4)
    mk, mv = jm.apply(params, memory, method=jm.project_memory_kv)
    jx, jk, jv = jm.apply(params, x, step, k_cache, v_cache, step + 1, mk, mv, pad,
                          G, zeroed_mask, method=jm.incremental_pair)
    tm = carry(tlayers.UnimodalCaptionDecoderLayer(D, H, 4.0), params)
    with torch.no_grad():
        tmk, tmv = tm.project_memory_kv(t(memory))
        close(tmk, mk)
        close(tmv, mv)
        tk, tv = t(k_cache).clone(), t(v_cache).clone()
        tx, _, _ = tm.incremental_pair(
            t(x), step, tk, tv, step + 1, tmk, tmv, t(pad), G,
            None if zeroed_mask is None else t(zeroed_mask))
    close(tx, jx)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("zeroed", [False, True], ids=["crop", "bias_column"])
def test_caption_layer_teacher_forced_matches_jax(zeroed):
    """The training pass of a caption layer over a whole caption: causal
    and padding masks in self-attention, grouped shared-KV cross-attention
    with and without the bias column; outputs and input gradients."""
    rng = np.random.default_rng(9)
    B, G, S, D, H, Tc = 2, 3, 13, 32, 2, 6
    N = B * G
    x = rng.normal(size=(N, Tc, D)).astype(np.float32)
    memory = rng.normal(size=(B, S, D)).astype(np.float32)
    causal = ~np.tril(np.ones((Tc, Tc), bool))
    tgt_pad = np.zeros((N, Tc), bool)
    tgt_pad[1, 4:] = True
    crop = rng.uniform(size=(N, S)) < 0.5
    crop[0] = True
    if zeroed:
        pad, zeroed_mask = rng.uniform(size=(N, S)) < 0.3, crop
    else:
        pad, zeroed_mask = crop, None
    jm = jlayers.UnimodalCaptionDecoderLayer(D, H, 4.0)
    params = perturb(jm.init(jax.random.PRNGKey(0), x, np.repeat(memory, G, 0)), 6)
    jfn = lambda x_, m_: jm.apply(params, x_, m_, causal[None, None], tgt_pad, pad,
                                  groups=G, zeroed_mask=zeroed_mask)
    jout = jfn(x, memory)
    jgx, jgm = jax.grad(lambda a, b: jfn(a, b).sum(), argnums=(0, 1))(x, memory)
    tm = carry(tlayers.UnimodalCaptionDecoderLayer(D, H, 4.0), params).train()
    tx, tmem = t(x).requires_grad_(), t(memory).requires_grad_()
    tout = tm(tx, tmem, t(causal), t(tgt_pad), t(pad), groups=G,
              zeroed_mask=None if zeroed_mask is None else t(zeroed_mask))
    tout.sum().backward()
    close(tout, jout)
    close(tx.grad, jgx)
    close(tmem.grad, jgm)


def test_zeroed_tokens_tie_exactly_and_sort_by_index():
    """Tokens whose encoder input is zeroed (padding, invalid proposals)
    share one saliency exactly, so the top-K breaks their ties by index,
    even when the saliency net rounds equal rows apart (as a GEMM on the
    card may): its output gets noise of 1e-6 per row here."""
    torch.manual_seed(0)
    D, L = 32, len(SHAPES)
    tr = ttr.SparseDeformableTransformer(d_model=D, num_heads=2, num_encoder_layers=1,
                                         num_decoder_layers=1, dim_feedforward=64,
                                         num_feature_levels=L, rho=0.5).eval()
    rng = np.random.default_rng(10)
    srcs = [t(rng.normal(size=(2, T, D)).astype(np.float32)) for T in SHAPES]
    poses = [t(rng.normal(size=(2, T, D)).astype(np.float32)) for T in SHAPES]
    masks = []
    for T in SHAPES:
        m = np.zeros((2, T), bool)
        m[1, T // 2:] = True
        masks.append(t(m))
    predictor = tr.enc_mask_predictor.forward
    tr.enc_mask_predictor.forward = lambda x: predictor(x) + 1e-6 * torch.randn(x.shape[:2])
    with torch.no_grad():
        enc = tr.prepare_encoder_inputs(srcs, masks, poses)
    sal, mask = enc["saliency"], enc["mask_flatten"]
    _, valid = ttr.gen_encoder_output_proposals(SHAPES, mask)
    zeroed_real = ~valid & ~mask
    assert int(zeroed_real[1].sum()) > 1  # the padded video has such tokens
    for b in range(2):
        vals = sal[b][zeroed_real[b]]
        assert (vals == vals[:1]).all()
        order = enc["topk"][b].tolist()
        tied = [i for i in order if zeroed_real[b, i]]
        assert tied == sorted(tied)


def test_vocabulary_embedder_and_caption_table_match_jax():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 30, size=(3, 5)).astype(np.int32)
    jm = jemb.VocabularyEmbedder(30, 16)
    params = perturb(jm.init(jax.random.PRNGKey(0), tokens), 5)
    tm = carry(temb.VocabularyEmbedder(30, 16), params)
    with torch.no_grad():
        close(tm(t(tokens).long()), jm.apply(params, tokens), atol=1e-6)
    np.testing.assert_array_equal(temb.caption_positional_encoding(16, 50).numpy(),
                                  np.asarray(jemb.caption_positional_encoding(16, 50)))


def test_segment_ops_match_jax():
    rng = np.random.default_rng(6)
    seg = rng.uniform(-0.2, 1.2, size=(3, 5, 2)).astype(np.float32)
    dur = rng.uniform(5, 200, size=(3, 1)).astype(np.float32)
    close(tseg.segment_cl_to_xy(t(seg)), jseg.segment_cl_to_xy(seg), atol=1e-6)
    close(tseg.segment_xy_to_cl(t(seg)), jseg.segment_xy_to_cl(seg), atol=1e-6)
    close(tseg.denormalize_segments(t(seg), t(dur)), jseg.denormalize_segments(seg, dur),
          atol=1e-4)
    close(tseg.inverse_sigmoid(t(seg)), jseg.inverse_sigmoid(seg), atol=1e-5)


def test_encoder_geometry_matches_jax():
    rng = np.random.default_rng(7)
    B, S = 3, sum(SHAPES)
    masks = []
    for T in SHAPES:
        m = np.zeros((B, T), bool)
        m[1, T - max(1, T // 4):] = True
        masks.append(m)
    flat = np.concatenate(masks, 1)
    ratios = ttr.get_valid_ratios([t(m) for m in masks])
    close(ratios, jtr.get_valid_ratios([jnp.asarray(m) for m in masks]), atol=1e-7)
    close(ttr.get_encoder_reference_points(SHAPES, ratios),
          jtr.get_encoder_reference_points(SHAPES, jnp.asarray(ratios.numpy())), atol=1e-5)
    tun, tval = ttr.gen_encoder_output_proposals(SHAPES, t(flat))
    jun, jval = jtr.gen_encoder_output_proposals(SHAPES, jnp.asarray(flat))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(np.isinf(tun.numpy()), np.isinf(np.asarray(jun)))
    fin = np.isfinite(np.asarray(jun))
    np.testing.assert_allclose(tun.numpy()[fin], np.asarray(jun)[fin], rtol=0, atol=1e-5)
    assert S == flat.shape[1]
    idx = rng.integers(0, 2, size=(B, 30)).astype(bool)
    np.testing.assert_array_equal(
        tbase.interpolate_mask_nearest(t(idx), 11).numpy(),
        np.asarray(jbase.interpolate_mask_nearest(jnp.asarray(idx), 11)))


@pytest.mark.parametrize("vrl,levels", [(24, 3), (300, 4)])
def test_crop_segment_mask_matches_jax(vrl, levels):
    rng = np.random.default_rng(8)
    B, G = 3, 5
    dur = rng.uniform(10, 180, size=(B,)).astype(np.float32)
    seg = np.sort(rng.uniform(-5, 200, size=(B, G, 2)), axis=-1).astype(np.float32)
    S = sum(tbase.pyramid_shapes(vrl, levels))
    assert tdvc.level_windows(vrl, levels) == jdvc.level_windows(vrl, levels)
    np.testing.assert_array_equal(
        tdvc.crop_segment_mask(t(seg), t(dur), vrl, levels, num_tokens=S).numpy(),
        np.asarray(jdvc.crop_segment_mask(seg, dur, vrl, levels, num_tokens=S)))


def test_nearest_resize_matches_jax():
    x = np.arange(2 * 37 * 3, dtype=np.float32).reshape(2, 37, 3)
    for n in (10, 37, 300):
        np.testing.assert_array_equal(nearest_resize(x, n, axis=1),
                                      jax_nearest_resize(x, n, axis=1))
