"""The port's configuration against the JAX package's: every key of JAX's
``load_config_train()`` and ``load_config_test()`` is in the port's
``load_config("train")`` / ``load_config("test")`` with JAX's default and
its type, and the port has no key that JAX lacks; ``apply_overrides`` of
any key (the port's, and JAX's as its root ``main.py`` applies them) gives
the same tree on both sides; and ``msda_backend`` takes JAX's names, each
computing the same function, and refuses any other with JAX's
``ValueError``."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_common import flatten_params, perturb

from multimodal_feature_learning_tpu.config.defaults import load_config_test, load_config_train
from multimodal_feature_learning_tpu_torch.config import apply_overrides, load_config
from multimodal_feature_learning_tpu_torch.ops.msda import MSDA_BACKENDS

JAX_LOADERS = {"train": load_config_train, "test": load_config_test}


def flat_jax(node, prefix: str = "") -> dict:
    out = {}
    for key, value in node.items():
        if hasattr(value, "items"):
            out.update(flat_jax(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = list(value) if isinstance(value, (list, tuple)) else value
    return out


def flat_port(node, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            out.update(flat_port(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


def typed(tree: dict) -> dict:
    return {k: (type(v).__name__, v) for k, v in tree.items()}


KEYS = sorted(flat_jax(load_config_train()))


def override_for(key: str, default) -> str:
    """``key=value`` with a value of the default's type that differs from it."""
    if isinstance(default, bool):
        value = "false" if default else "true"
    elif isinstance(default, int):
        value = str(default + 3)
    elif isinstance(default, float):
        value = repr(default + 0.25)
    elif isinstance(default, list):
        value = {float: "0.2,0.4", str: "video,audio"}[type(default[0])] if default else "1,2"
    else:
        value = f"{default}_x"
    return f"{key}={value}"


@pytest.mark.parametrize("mode", ["train", "test"])
def test_key_sets_and_defaults_match_jax(mode):
    ref, got = flat_jax(JAX_LOADERS[mode]()), flat_port(load_config(mode))
    assert sorted(set(ref) ^ set(got)) == []
    assert typed(got) == typed(ref)
    assert (got["model_mode"], got["dataset.activity_net.for_testing"]) == (
        ("training", False) if mode == "train" else ("validation", True))


@pytest.mark.parametrize("key", KEYS)
def test_every_override_gives_jax_tree(key):
    from main import apply_overrides as jax_apply_overrides

    override = [override_for(key, flat_jax(load_config_train())[key])]
    ref = flat_jax(jax_apply_overrides(load_config_train(), override))
    got = flat_port(apply_overrides(load_config("train"), override))
    assert typed(got) == typed(ref)
    assert got[key] != flat_port(load_config("train"))[key]


MSDA_SHAPES = (6, 3)


def msda_inputs():
    rng = np.random.default_rng(0)
    B, Q, D, L = 2, 5, 16, len(MSDA_SHAPES)
    query = rng.normal(size=(B, Q, D)).astype(np.float32)
    ref = rng.uniform(0, 1, size=(B, Q, L, 1)).astype(np.float32)
    value = rng.normal(size=(B, sum(MSDA_SHAPES), D)).astype(np.float32)
    pad = np.zeros((B, sum(MSDA_SHAPES)), bool)
    pad[1, -2:] = True
    return query, ref, value, pad


TINY_MODEL = ["dvc.d_model=32", "dvc.detr.d_model=32", "dvc.detr.feature_dim=32",
              "dvc.caption.d_model=32", "dvc.detr.enc_layers=1", "dvc.detr.dec_layers=1",
              "dvc.caption.depth=1", "dvc.detr.video_rescale_len=16",
              "dataset.activity_net.video_rescale_len=16", "dvc.detr.num_feature_levels=2",
              "dataset.activity_net.max_caption_len_all=6"]


def serve_tiny(backend: str) -> dict:
    """``forward_serve`` of the port's sparse model at TINY_MODEL dims,
    weights from seed 0, built under ``msda_backend=backend``, on 2 videos
    of numpy seed 0."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model

    cfg = apply_overrides(load_config(), [*TINY_MODEL, f"msda_backend={backend}"])
    model = build_model(cfg, 40, device="cpu")
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
    return model.forward_serve(video, torch.zeros((2, 16), dtype=torch.bool),
                               torch.tensor([30.0, 60.0]))


@pytest.mark.parametrize("backend", MSDA_BACKENDS)
def test_every_msda_backend_name_computes_jax_function(backend):
    """JAX's ``MSDeformAttn`` under each of its names (its "pallas" needs
    the TPU, so "gather" stands for it on the CPU) against the port's, which
    runs one path under every name, within 1e-5 (``test_torch_modules.py``'s
    tolerance for the module); and the port's model built under the name
    serves as the default name's does, bit for bit."""
    from multimodal_feature_learning_tpu.models import msda_module as jmsda
    from multimodal_feature_learning_tpu_torch.models import msda_module as tmsda
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    query, ref, value, pad = msda_inputs()
    D, L = query.shape[-1], len(MSDA_SHAPES)
    jm = jmsda.MSDeformAttn(D, L, 2, 2, backend=backend if backend != "pallas" else "gather")
    params = perturb(jm.init(jax.random.PRNGKey(0), query, ref, value, MSDA_SHAPES, pad), 1)
    jout = np.asarray(jm.apply(params, query, ref, value, MSDA_SHAPES, pad)[0])
    tm = tmsda.MSDeformAttn(D, L, 2, 2)
    load_flax_params(tm, flatten_params(params))
    with torch.no_grad():
        tout = tm(*(torch.from_numpy(a) for a in (query, ref, value)), MSDA_SHAPES,
                  torch.from_numpy(pad))[0]
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=1e-5)
    got, want = serve_tiny(backend), serve_tiny("")
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_unknown_msda_backend_raises_as_in_jax():
    """JAX raises at the module's first call, the port when a model of a
    family with MSDA (the sparse and dense, the multimodal) is built."""
    from multimodal_feature_learning_tpu.models import msda_module as jmsda
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
    from test_torch_common import small_vocab

    query, ref, value, pad = msda_inputs()
    jm = jmsda.MSDeformAttn(query.shape[-1], len(MSDA_SHAPES), 2, 2, backend="triton")
    with pytest.raises(ValueError, match="unknown backend 'triton'"):
        jm.init(jax.random.PRNGKey(0), query, ref, value, MSDA_SHAPES, pad)
    for family in ([], ["dvc.input_modalities=video,audio"]):
        cfg = apply_overrides(load_config(), [*TINY_MODEL, "msda_backend=triton", *family])
        with pytest.raises(ValueError, match="unknown backend 'triton'"):
            build_model_and_criterion(cfg, small_vocab(), device="cpu")
