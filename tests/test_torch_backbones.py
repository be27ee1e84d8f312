"""The port's raw-input backbones (``models/backbones.py``: the patch
embeddings, ViViT in its four modes, AST) against the JAX package's flax
modules: the same params (a flax init, perturbed from a numpy seed, carried
by ``utils.weights``) and the same numpy inputs. Outputs within 1e-5 of
their largest value (f32; the attention products are summed in another
order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu.models import backbones as jb
from multimodal_feature_learning_tpu_torch.models import backbones as tb
from multimodal_feature_learning_tpu_torch.utils.weights import (export_flax_params,
                                                                 load_flax_params)
from test_torch_common import flatten_params, perturb

REL = 1e-5


def carried(jmodule, tmodule, *inputs, seed=0):
    """(JAX output, port output) of both modules on ``inputs`` with one set
    of params; the port's export gives the flax params back exactly."""
    params = perturb(jmodule.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs)), seed)
    flat = flatten_params(params)
    load_flax_params(tmodule, flat)
    out = export_flax_params(tmodule)
    assert set(out) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k], err_msg=k)
    ref = np.asarray(jmodule.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmodule.eval()(*map(torch.from_numpy, inputs)).numpy()
    return ref, got


def assert_close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * float(np.abs(ref).max()))


@pytest.mark.parametrize("sizes,kernel,strides,pads", [
    ((64, 16), (16, 16), (10, 10), ((6, 6), (5, 5))),    # even totals
    ((65, 17), (16, 16), (10, 10), ((5, 6), (4, 5))),    # odd totals
    ((128, 64), (16, 16), (10, 10), ((4, 4), (6, 6))),
    ((32, 48), (16, 16), (16, 16), ((0, 0), (0, 0))),
    ((7,), (3,), (2,), ((1, 1),)),
])
def test_same_padding_is_xla_s(sizes, kernel, strides, pads):
    assert tb.same_padding(sizes, kernel, strides) == pads


@pytest.mark.parametrize("shape", [(2, 64, 16), (2, 65, 17), (1, 64, 128), (2, 37, 24)])
def test_patch_embedding_pads_as_flax(shape):
    """flax's ``nn.Conv`` pads "SAME": (2, 64, 16) gives 7 x 2 = 14 patches,
    (1, 64, 128) 7 x 13 = 91; odd and even totals on both axes."""
    x = np.random.default_rng(1).normal(size=shape + (1,)).astype(np.float32)
    ref, got = carried(jb.PatchEmbedding(12, 16, strides=(10, 10)),
                       tb.PatchEmbedding(12, 16, (10, 10)), x)
    assert_close(got, ref)
    assert got.shape[1] == -(-shape[1] // 10) * -(-shape[2] // 10)


@pytest.mark.parametrize("shape,patch,tpatch", [((2, 3, 32, 32, 3), 16, 1),
                                                ((1, 4, 40, 24, 3), 16, 2),
                                                ((2, 3, 20, 21, 3), 8, 2)])
def test_token_embedding_equals_flax_conv3d(shape, patch, tpatch):
    """The tubelet Conv3d as a product of the patches, padded "SAME" where
    the sizes do not divide (odd and even totals)."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref, got = carried(jb.TokenEmbedding(12, patch, tpatch), tb.TokenEmbedding(12, patch, tpatch),
                       x)
    assert_close(got, ref)


@pytest.mark.parametrize("mode,tokens", [("factorised encoder", 4),
                                         ("spatio temporal attention", 16),
                                         ("factorised self attention", 4),
                                         ("factorised dot product attention", 4)])
def test_vivit_modes_equal_jax(mode, tokens):
    """All four modes at the JAX test's dims (d 32, 2 heads, 4 frames of
    32 x 32: 4 patches a frame), two layers each, on normalised frames."""
    x = np.random.default_rng(3).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    kw = dict(model_name=mode, d_model=32, depth=2, temporal_depth=2, num_heads=2,
              max_tokens=64)
    ref, got = carried(jb.VideoVisionTransformer(**kw), tb.VideoVisionTransformer(**kw), x)
    assert got.shape == (2, tokens, 32)
    assert_close(got, ref)


def test_ast_equals_jax_at_the_raw_test_dims():
    """AST over (2, 64, 16) spectrograms: 14 patches + 2 tokens = 16, as
    JAX's (the 7 that tests/test_raw_multimodal.py's comment counts is
    not what flax builds)."""
    x = np.random.default_rng(4).normal(size=(2, 64, 16)).astype(np.float32)
    kw = dict(d_model=32, depth=2, num_heads=2, patch_size=16, frequency_stride=10,
              time_stride=10, max_tokens=256)
    ref, got = carried(jb.AudioSpectrogramTransformer(**kw),
                       tb.AudioSpectrogramTransformer(**kw), x)
    assert got.shape == (2, 16, 32)
    assert_close(got, ref)


def test_unknown_vivit_mode_raises():
    with pytest.raises(ValueError, match="unknown vivit mode"):
        tb.VivitEncoder("joint", 32, 1, 1, 2)


def test_twelve_heads_do_not_divide_512_in_either_package():
    """The JAX default of 12 heads for ViViT and AST does not divide d_model
    512: the attention's head reshape fails in JAX and in the port alike."""
    from multimodal_feature_learning_tpu_torch.config import Config

    cfg = Config()
    assert cfg.dvc.vivit.num_heads == cfg.dvc.ast.num_heads == 12
    x = np.zeros((1, 2, 16, 16, 3), np.float32)
    kw = dict(d_model=512, depth=1, temporal_depth=1, num_heads=12, max_tokens=8)
    with pytest.raises(TypeError):
        jax.eval_shape(jb.VideoVisionTransformer(**kw).init, jax.random.PRNGKey(0),
                       jnp.asarray(x))
    with pytest.raises(RuntimeError, match="shape"):
        tb.VideoVisionTransformer(**kw)(torch.from_numpy(x))
    spec = np.zeros((1, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="shape"):
        tb.AudioSpectrogramTransformer(512, 1, 12, max_tokens=8)(torch.from_numpy(spec))
