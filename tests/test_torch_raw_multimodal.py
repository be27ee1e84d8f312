"""The raw multimodal family of the port (``RawMultimodalDVC``: uint8
frames through ViViT, log-mel spectrograms through AST, then the multimodal
stack; BASELINE config #5) against the JAX package's, at the dims of
``tests/test_raw_multimodal.py``: d 32, one layer of each stack, 8 frames
of 32 x 32, spectrograms of 64 frames x 16 mels. AST emits 16 tokens there
while ``audio_rescale_len`` is 7, as in that test: the audio pyramid follows
the 16 tokens and the crop windows the 7, in both packages.

The same flax params (a JAX init perturbed from a numpy seed, every dropout
rate 0) and the same numpy batch on both sides. Tolerances, as
``test_torch_multimodal.py`` holds the family on features: matchings equal,
loss terms rel 1e-5 (atol 1e-6), gradient leaves atol 2e-4 x max |g_leaf|
(JAX's train forward compiled; the biases whose exact gradient is 0 under
1e-5 x their kernel's); in ``forward_eval`` (JAX eager) matchings,
crop masks and captions equal and segments atol 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, PAD, SHIFT_FREE, VOCAB_SIZE, assert_grads_match, assert_losses_match,
    build_port_family, jax_losses_and_grads, no_dropout, perturb, port_losses_and_grads,
)

from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device

T_FRAMES, N_MELS, SPEC_FRAMES, AST_TOKENS, RESCALE_AUDIO = 8, 16, 64, 16, 7


def raw_cfg():
    """tests/test_raw_multimodal.py's config."""
    from multimodal_feature_learning_tpu.config import load_config_train

    cfg = load_config_train()
    cfg.use_raw_videos = True
    cfg.use_differentiable_mask = False
    cfg.dvc.input_modalities = ["video", "audio"]
    cfg.dvc.losses = ["labels", "segments", "captions"]
    cfg.dvc.d_model = 32
    cfg.dvc.num_queries = 4
    cfg.dvc.detr.d_model = 32
    cfg.dvc.detr.num_heads = 2
    cfg.dvc.detr.enc_layers = 1
    cfg.dvc.detr.dec_layers = 1
    cfg.dvc.detr.transformer_ff_dim = 64
    cfg.dvc.detr.num_feature_levels = 2
    cfg.dvc.detr.video_rescale_len = T_FRAMES
    cfg.dvc.caption.d_model = 32
    cfg.dvc.caption.depth = 1
    cfg.dvc.caption.num_heads = 2
    cfg.dvc.vivit.depth = 1
    cfg.dvc.vivit.temporal_depth = 1
    cfg.dvc.vivit.num_heads = 2
    cfg.dvc.ast.depth = 1
    cfg.dvc.ast.num_heads = 2
    anet = cfg.dataset.activity_net
    anet.video_rescale_len = T_FRAMES
    anet.audio_rescale_len = RESCALE_AUDIO
    anet.max_caption_len_all = 6
    anet.max_gt_target_segments = 2
    return no_dropout(cfg)


def raw_batch(B=2, G=2, Lc=6, seed=0):
    from multimodal_feature_learning_tpu.data.audio import aframes_to_fbank

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, size=(B, T_FRAMES, 32, 32, 3)).astype(np.uint8)
    wave = rng.normal(size=int(16000 * 0.67)).astype(np.float32)
    fbank = np.asarray(aframes_to_fbank(jnp.asarray(wave), 16000.0, N_MELS, SPEC_FRAMES))
    caps = np.concatenate([np.full((B, G, 1), BOS, np.int32),
                           rng.integers(4, VOCAB_SIZE, size=(B, G, Lc - 2)).astype(np.int32),
                           np.full((B, G, 1), EOS, np.int32)], axis=2)
    return {
        "video_tensor": frames,
        "video_mask": np.zeros((B, T_FRAMES), bool),
        "audio_tensor": np.stack([fbank, fbank * 0.5]),
        "audio_mask": np.zeros((B, SPEC_FRAMES), bool),
        "durations": np.array([20.0, 35.0], np.float32),
        "gt_segments": rng.uniform(0.2, 0.7, size=(B, G, 2)).astype(np.float32),
        "gt_mask": np.ones((B, G), bool),
        "gt_labels": np.zeros((B, G), np.int32),
        "batch_valid": np.ones((B,), bool),
        "cap_tokens": caps,
    }


@pytest.fixture(scope="module")
def world():
    from multimodal_feature_learning_tpu.models.multimodal import build_multimodal_model

    jcfg = raw_cfg()
    jmodel = build_multimodal_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    batch = raw_batch()
    params = perturb(jmodel.init(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in batch.items()}), 0)
    model, criterion, weight_dict = build_port_family(jcfg, params)
    tb = batch_to_device(batch, "cpu")
    trained = (jax_losses_and_grads(jcfg, jmodel, params, batch),
               port_losses_and_grads(model, criterion, weight_dict, tb))
    return jcfg, jmodel, params, model, batch, tb, trained


def test_the_family_and_its_backbones(world):
    from multimodal_feature_learning_tpu_torch.models.multimodal import RawMultimodalDVC

    jcfg, _, params, model, _, tb, _ = world
    assert isinstance(model, RawMultimodalDVC)
    assert {"video_backbone", "audio_backbone", "proposal", "caption"} == set(params)
    assert tb["video_tensor"].dtype == torch.uint8
    with torch.no_grad():
        vfeat, afeat = model.backbone_features(tb)
    assert vfeat.shape == (2, T_FRAMES, 32)
    assert afeat.shape == (2, AST_TOKENS, 32) != (2, RESCALE_AUDIO, 32)


def test_backbone_features_equal_jax(world):
    """ViViT on the frames normalised in the model, AST on the fbank,
    within 1e-5 of their largest value."""
    from multimodal_feature_learning_tpu.data.video_transforms import normalize

    _, jmodel, params, model, batch, tb, _ = world
    ref_v = jmodel.video_backbone.apply(params["video_backbone"],
                                        normalize(jnp.asarray(batch["video_tensor"])))
    ref_a = jmodel.audio_backbone.apply(params["audio_backbone"],
                                        jnp.asarray(batch["audio_tensor"]))
    with torch.no_grad():
        got_v, got_a = model.backbone_features(tb)
    for got, ref in ((got_v, ref_v), (got_a, ref_a)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_train_matchings_losses_and_gradients_match_jax(world):
    """Gradients reach both backbones (non-zero, finite) and equal JAX's
    leaf by leaf."""
    *_, trained = world
    (ridx, raux, rloss, rgrad), (gidx, gaux, gloss, ggrad) = trained
    np.testing.assert_array_equal(gidx, ridx)
    np.testing.assert_array_equal(gaux, raux)
    assert_losses_match(rloss, gloss, min_terms=5)  # one decoder layer: no aux terms
    # at d 32 each GroupNorm group is one channel: the pyramid's conv biases
    # ahead of it have an exact gradient of 0, like the key biases
    shift_free = (SHIFT_FREE, "input_proj_0||bias", "input_proj_1||bias")
    assert assert_grads_match(rgrad, ggrad, shift_free) > 0.8 * len(rgrad)
    for tree in ("video_backbone", "audio_backbone"):
        leaves = [v for k, v in ggrad.items() if k.startswith(tree)]
        assert all(np.isfinite(v).all() for v in leaves)
        assert sum(float(np.abs(v).sum()) > 0 for v in leaves) > 0.8 * len(leaves), tree
    leaf = "video_backbone||params||token_embeddings_layer||project_to_patch||kernel"
    np.testing.assert_allclose(ggrad[leaf], rgrad[leaf], rtol=0,
                               atol=1e-4 * float(np.abs(rgrad[leaf]).max()))


@pytest.mark.parametrize("mode,kw", [("one_by_one", {}), ("beam", {"beam_size": 3})])
def test_forward_eval_matches_jax(world, mode, kw):
    """Tokens, matchings, the 24-token audio crop mask (16 + 8 tokens,
    windows from audio_rescale_len 7) equal; segments within 1e-5."""
    _, jmodel, params, model, batch, tb, _ = world
    rout, rcap, ridx, raux, rmask = jmodel.forward_eval(params, batch, mode, **kw)
    gout, gcap, gidx, gaux, gmask = model.forward_eval(tb, mode, **kw)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux))
    assert gmask[1].shape == (4, AST_TOKENS + AST_TOKENS // 2)
    for g, r in zip(gmask, rmask):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(gout["pred_segments"].numpy(), np.asarray(rout["pred_segments"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap))
    assert (gcap[:, 0] == BOS).all()
