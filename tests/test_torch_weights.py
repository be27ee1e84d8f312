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
