"""The weight carry (``utils/weights.py``) on the trained full-width snapshot
``snapshots/conv_e79.npz``: every key of the snapshot goes into the port's
full-width model with none left over on either side (load only, no
forward), and a key missing or added on either side raises."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu_torch.config import load_config
from multimodal_feature_learning_tpu_torch.models.dvc import build_model
from multimodal_feature_learning_tpu_torch.utils import weights

SNAPSHOT = Path(__file__).resolve().parents[1] / "snapshots" / "conv_e79.npz"


@pytest.fixture(scope="module")
def snapshot():
    return weights.load_npz(str(SNAPSHOT))


def flagship(use_differentiable_mask=False):
    cfg = load_config()
    cfg.use_differentiable_mask = use_differentiable_mask
    return build_model(cfg, 6563, device="cpu")


def test_snapshot_loads_strictly_into_the_full_width_model(snapshot):
    model = flagship()
    weights.load_flax_params(model, snapshot)
    sd = model.state_dict()
    keys = [k for k in snapshot if k != "__epoch__"]
    assert len(sd) == len(keys) == 463
    assert sum(v.numel() for v in sd.values()) == 75834047
    # a Dense kernel (in, out) lands transposed; a Conv kernel (k, in, out)
    # lands as (out, in, k); the bf16 halves expand exactly
    k = "BF16||proposal||params||transformer||enc_layers_2||linear1||kernel"
    np.testing.assert_array_equal(
        sd["proposal.transformer.enc_layers.2.linear1.weight"].numpy(),
        weights.expand_bf16(snapshot[k]).T)
    k = "BF16||proposal||params||base_encoder||input_proj_1||kernel"
    np.testing.assert_array_equal(
        sd["proposal.base_encoder.input_proj.1.weight"].numpy(),
        weights.expand_bf16(snapshot[k]).transpose(2, 1, 0))
    k = "BF16||caption||params||target_embedding||Embed_0||embedding"
    np.testing.assert_array_equal(sd["caption.target_embedding.embed.weight"].numpy(),
                                  weights.expand_bf16(snapshot[k]))


def test_snapshot_lacks_the_context_mask_head(snapshot):
    """conv_e79 was trained without the differentiable context mask: a model
    built with it finds its context_mask parameters missing and refuses."""
    with pytest.raises(KeyError, match="missing"):
        weights.load_flax_params(flagship(use_differentiable_mask=True), snapshot)


@pytest.mark.parametrize("edit", ["drop", "add"])
def test_leftover_keys_raise(snapshot, edit):
    flat = dict(snapshot)
    if edit == "drop":
        del flat["BF16||proposal||params||count_head_encoder||bias"]
        match = "missing"
    else:
        flat["caption||params||extra_head||bias"] = np.zeros((3,), np.float32)
        match = "unexpected"
    with pytest.raises(KeyError, match=match):
        weights.load_flax_params(flagship(), flat)


def test_bf16_expansion_and_key_mapping():
    x = np.array([1.0, -2.5, 3.140625, 1e-30, -0.0], np.float32)
    upper = (x.view(np.uint32) >> 16).astype(np.uint16)
    np.testing.assert_array_equal(weights.expand_bf16(upper),
                                  torch.tensor(x).to(torch.bfloat16).float().numpy())
    assert weights.torch_key("caption||params||decoder_5||mlp||fully_connected_1||kernel") \
        == "caption.decoder.5.mlp.fully_connected_1.weight"
    assert weights.torch_key("params||gn_0||scale") == "gn.0.weight"
    assert weights.torch_key("proposal||params||query_embedding") == "proposal.query_embedding"
    with pytest.raises(KeyError):
        weights.torch_key("proposal||batch_stats||x")


@pytest.mark.parametrize("mask", [True, False], ids=["ctxmask", "cropmask"])
def test_export_inverts_the_carry_at_small_dims(mask):
    """export_flax_params(load_flax_params(flat)) gives back flat, leaf for
    leaf, as copies that later updates of the model do not reach."""
    from test_torch_common import build_jax_model, build_port_model, flatten_params, jax_small_cfg

    jcfg = jax_small_cfg(use_differentiable_mask=mask)
    _, params = build_jax_model(jcfg)
    flat = flatten_params(params)
    model = build_port_model(jcfg, params)
    out = weights.export_flax_params(model)
    assert set(out) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k], err_msg=k)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k], err_msg=k)


def test_snapshot_key_set_round_trips_without_loading_the_tensors():
    """Every key of conv_e79 maps to a state_dict name and back to itself
    (the ranks come from the full-width model built on the meta device)."""
    from multimodal_feature_learning_tpu_torch.models.dvc import UnimodalDVC

    with np.load(str(SNAPSHOT)) as z:
        keys = [k for k in z.files if k != "__epoch__"]
    cfg = load_config()
    cfg.use_differentiable_mask = False
    with torch.device("meta"):
        sd = UnimodalDVC(cfg, 6563).state_dict()
    assert len(keys) == len(sd) == 463
    for k in keys:
        plain = k[len(weights.BF16_PREFIX):] if k.startswith(weights.BF16_PREFIX) else k
        name = weights.torch_key(plain)
        assert weights.flax_key(name, sd[name].dim()) == plain


# -- the dense and the multimodal families' trees ---------------------------------

FAMILY_TREES = {  # (family, differentiable mask, BiModalEncoder)
    "dense": ("dense", False, False),
    "multimodal_bimodal_ctxmask": ("mm", True, True),
    "multimodal_dense": ("mm_dense", False, False),
}


@pytest.mark.parametrize("case", list(FAMILY_TREES))
def test_family_trees_carry_strictly_and_export_back(case):
    """A JAX init of the dense family, of the multimodal one with the
    BiModalEncoder (``bimodal||params||layer_0``) and both context masks
    (``video_context_mask``, ``audio_context_mask``), and of the dense
    multimodal one loads into the port with strict=True (the cross-modal
    ``enc_layers_mod_{i}`` / ``dec_layers_mod_{i}`` lists included) and
    exports back key for key and value for value."""
    from test_torch_common import build_jax_family, build_port_family, family_cfg, flatten_params

    family, mask, bimodal = FAMILY_TREES[case]
    jcfg = family_cfg(family, mask, bimodal)
    _, params = build_jax_family(jcfg)
    flat = flatten_params(params)
    model, _, _ = build_port_family(jcfg, params)
    out = weights.export_flax_params(model)
    assert set(out) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k], err_msg=k)
    trees = {k.split(weights.SEP)[0] for k in flat}
    expected = {"proposal", "caption"} | ({"bimodal"} if bimodal else set())
    if mask:
        expected |= ({"context_mask"} if family == "dense"
                     else {"video_context_mask", "audio_context_mask"})
    assert trees == expected
    if family.startswith("mm"):
        assert any("enc_layers_mod_1" in k for k in flat)
        assert "proposal.enc_layers_mod.1.cross_attn_v2a.value_proj.weight" in model.state_dict()
    if bimodal:
        assert "bimodal.layer_1.attention_va.q_linear.weight" in model.state_dict()


@pytest.mark.parametrize("family,millions", [("dense", 74.71), ("multimodal_bimodal", 119.68)])
def test_full_width_param_counts_equal_jax(family, millions):
    """At full width with the 6563-word vocabulary and the context mask off,
    as the JAX package trained them, the port's models count the JAX init's
    params exactly (``jax.eval_shape``: no compute; the port's on the meta
    device): 74.71 M dense (runs_dense_conv.log) and 119.68 M multimodal
    with the BiModalEncoder (runs_mm_conv.log)."""
    import jax

    from multimodal_feature_learning_tpu.config import load_config as jax_load_config
    from multimodal_feature_learning_tpu.config import recompute_losses
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
    from multimodal_feature_learning_tpu.models.multimodal import build_multimodal_model
    from test_torch_common import torch_cfg_like

    from multimodal_feature_learning_tpu_torch.models.dvc import UnimodalDVC
    from multimodal_feature_learning_tpu_torch.models.multimodal import MultimodalDVC

    jcfg = jax_load_config("train")
    jcfg.use_differentiable_mask = False
    if family == "dense":
        jcfg.dvc.use_sparse_detr, jcfg.dvc.use_deformable_detr = False, True
        jmodel, cls = jax_build_model(jcfg, 6563), UnimodalDVC
    else:
        jcfg.dvc.input_modalities = ["video", "audio"]
        jcfg.dvc.use_bimodal_encoder = True
        jmodel, cls = build_multimodal_model(jcfg, 6563), MultimodalDVC
    recompute_losses(jcfg)
    anet = jcfg.dataset.activity_net
    G, Lc, F = anet.max_gt_target_segments, anet.max_caption_len_all, jcfg.dvc.detr.feature_dim
    spec = jax.ShapeDtypeStruct
    batch = {"video_tensor": spec((1, anet.video_rescale_len, F), np.float32),
             "video_mask": spec((1, anet.video_rescale_len), bool),
             "audio_tensor": spec((1, anet.audio_rescale_len, F), np.float32),
             "audio_mask": spec((1, anet.audio_rescale_len), bool),
             "durations": spec((1,), np.float32), "gt_segments": spec((1, G, 2), np.float32),
             "gt_mask": spec((1, G), bool), "cap_tokens": spec((1, G, Lc), np.int32)}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = cls(torch_cfg_like(jcfg), 6563)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert round(n_jax / 1e6, 2) == millions


# -- the raw multimodal and the regular families' trees ---------------------------

NEW_FAMILY_TREES = ("raw_multimodal", "regular_ctxmask", "regular_raw")


@pytest.mark.parametrize("case", NEW_FAMILY_TREES)
def test_raw_and_regular_trees_carry_strictly_and_export_back(case):
    """A JAX init of the raw multimodal family (``video_backbone`` and
    ``audio_backbone``: Conv kernels of rank 5 and 4, ``pos_embedding``,
    ``cls``, ``spatial_token``, ``temporal_token``, ``distill_token``, the
    ``spatial_encoder_{i}`` / ``temporal_encoder_{i}`` / ``encoder_{i}``
    lists), of the regular family (``decoder_{i}``, ``query_embedding``,
    ``context_mask``) and of the regular family over raw frames (its own
    ViViT under ``proposal||params||backbone``) loads into the port with
    strict=True and exports back key for key and value for value."""
    import jax
    import jax.numpy as jnp
    from test_torch_common import (BOS, EOS, PAD, VOCAB_SIZE, array_batch, build_port_family,
                                   flatten_params, perturb, torch_cfg_like)

    if case == "raw_multimodal":
        from multimodal_feature_learning_tpu.models.multimodal import build_multimodal_model
        from test_torch_raw_multimodal import raw_batch, raw_cfg

        jcfg, batch = raw_cfg(), raw_batch()
        jmodel = build_multimodal_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    else:
        from multimodal_feature_learning_tpu.models.regular_dvc import build_regular_model
        from test_torch_regular import raw_world, regular_cfg

        jcfg = regular_cfg(raw=case == "regular_raw")
        jmodel = build_regular_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
        if case == "regular_raw":
            import tempfile

            batch = raw_world(Path(tempfile.mkdtemp()))
        else:
            batch = array_batch(torch_cfg_like(jcfg), 2)
    params = perturb(jmodel.init(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in batch.items()}), 0)
    flat = flatten_params(params)
    model, _, _ = build_port_family(jcfg, params)
    out = weights.export_flax_params(model)
    assert set(out) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k], err_msg=k)
    sd = model.state_dict()
    ranks = {v.ndim for k, v in flat.items() if k.endswith("project_to_patch||kernel")}
    if case == "raw_multimodal":
        assert ranks == {4, 5}
        assert sd["video_backbone.encoder.spatial_encoder.0.attention.q_linear.weight"] \
            .shape == (32, 32)
        assert sd["audio_backbone.distill_token"].shape == (1, 1, 32)
        assert {k.split(weights.SEP)[0] for k in flat} == {
            "video_backbone", "audio_backbone", "proposal", "caption"}
    elif case == "regular_raw":
        assert ranks == {5}
        assert "proposal.backbone.encoder.temporal_encoder.0.mlp.fully_connected_1.weight" in sd
    else:
        assert "context_mask.layer_1.weight" in sd and "proposal.decoder.1.norm3.weight" in sd
    assert "proposal.query_embedding" in sd


FULL_WIDTH = {  # chip_smoke.py's full-width raw, regular_raw and regular configurations
    "raw": ["use_raw_videos=true", "dvc.input_modalities=video,audio",
            "dvc.vivit.num_heads=8", "dvc.ast.num_heads=8",
            "dataset.activity_net.audio_rescale_len=93"],
    "regular_raw": ["use_raw_videos=true", "dvc.use_sparse_detr=false"],
    "regular": ["dvc.use_sparse_detr=false"],
}
FULL_WIDTH_PARAMS = {"raw": 202_161_075, "regular_raw": 81_586_809, "regular": 58_083_449}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_raw_and_regular_full_width_param_counts_equal_jax(name):
    """At full width (6563 words, context mask off, 128 x 128 frames, 128
    mels x 64 frames), the port's models count the JAX init's params
    exactly (``jax.eval_shape``: no compute; the port's on the meta device);
    chip_smoke.py holds the same numbers on the card."""
    import jax

    from multimodal_feature_learning_tpu.config import load_config as jax_load_config
    from multimodal_feature_learning_tpu.config import recompute_losses
    from multimodal_feature_learning_tpu.models import build_model_and_criterion as jax_build
    from multimodal_feature_learning_tpu_torch.config import apply_overrides
    from multimodal_feature_learning_tpu_torch.config import load_config as port_load_config
    from multimodal_feature_learning_tpu_torch.models.multimodal import RawMultimodalDVC
    from multimodal_feature_learning_tpu_torch.models.regular_dvc import RegularDVC

    overrides = FULL_WIDTH[name] + ["use_differentiable_mask=false"]
    jcfg = jax_load_config("train")
    for kv in overrides:
        key, val = kv.split("=")
        *path, leaf = key.split(".")
        node = jcfg
        for p in path:
            node = node[p]
        old = node[leaf]
        node[leaf] = (val == "true" if isinstance(old, bool) else
                      val.split(",") if isinstance(old, list) else type(old)(val))
    if name.startswith("regular"):
        jcfg.dvc.use_deformable_detr = False
    recompute_losses(jcfg)

    class Words(list):
        pad_idx, bos_idx, eos_idx = 1, 2, 3

    jmodel, _, _ = jax_build(jcfg, Words(range(6563)))
    anet = jcfg.dataset.activity_net
    G, Lc, T = anet.max_gt_target_segments, anet.max_caption_len_all, anet.video_rescale_len
    spec = jax.ShapeDtypeStruct
    video = (spec((1, T, 128, 128, 3), np.uint8) if jcfg.use_raw_videos
             else spec((1, T, jcfg.dvc.detr.feature_dim), np.float32))
    batch = {"video_tensor": video, "video_mask": spec((1, T), bool),
             "audio_tensor": spec((1, anet.audio_target_length, anet.num_mel_bins), np.float32),
             "audio_mask": spec((1, anet.audio_target_length), bool),
             "durations": spec((1,), np.float32), "gt_segments": spec((1, G, 2), np.float32),
             "gt_mask": spec((1, G), bool), "cap_tokens": spec((1, G, Lc), np.int32)}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))

    tcfg = apply_overrides(port_load_config(), overrides)
    if name.startswith("regular"):
        tcfg.dvc.use_deformable_detr = False
    cls = RawMultimodalDVC if name == "raw" else RegularDVC
    with torch.device("meta"):
        model = cls(tcfg, 6563)
    assert sum(p.numel() for p in model.parameters()) == n_jax == FULL_WIDTH_PARAMS[name]
