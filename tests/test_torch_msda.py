"""The port's plain MSDA core against the JAX package's.

The plain core (``ops/ms_deform_attn.py``) is the CPU path of the port and
the oracle of its CUDA kernel; here it is held against JAX's gather core and
against the Pallas kernel in interpret mode, on ragged level lengths with
locations out of [0, 1] and on exact integer coordinates. f32, atol 1e-5
(sums of 2 * L * P products, taken in another order)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu.ops import ms_deform_attn_core as jax_core
from multimodal_feature_learning_tpu.ops.pallas_msda import ms_deform_attn_pallas
from multimodal_feature_learning_tpu_torch.ops import msda
from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core

CASES = {
    # name: (B, Q, H, Dh, level lengths, P)
    "ragged": ((2, 5, 2, 4), (7, 4, 2, 1), 3),
    "single_token_level": ((1, 9, 3, 8), (12, 6, 3, 1), 4),
    "flagship_levels": ((1, 20, 2, 16), (300, 150, 75, 38), 4),
}


def make_inputs(dims, shapes, P, seed=0):
    B, Q, H, Dh = dims
    rng = np.random.default_rng(seed)
    S, L = sum(shapes), len(shapes)
    value = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(B, Q, H, L, P)).astype(np.float32)
    # exact integer coordinates: loc * T - 0.5 = k, including both ends
    for l, T in enumerate(shapes):
        ks = rng.integers(0, T, size=(B, Q, H))
        loc[:, :, :, l, 0] = ((ks + 0.5) / T).astype(np.float32)
        loc[:, 0, :, l, 1] = np.float32(0.5 / T)
        loc[:, -1, :, l, 1] = np.float32((T - 0.5) / T)
    aw = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    aw = aw / aw.reshape(B, Q, H, -1).sum(-1)[..., None, None]
    return value, loc, aw


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_core_matches_jax_gather_and_pallas(case):
    dims, shapes, P = CASES[case]
    value, loc, aw = make_inputs(dims, shapes, P)
    got = ms_deform_attn_core(torch.from_numpy(value), shapes,
                              torch.from_numpy(loc), torch.from_numpy(aw)).numpy()
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw))
    gather = np.asarray(jax_core(*args, backend="gather"))
    pallas = np.asarray(ms_deform_attn_pallas(*args, True))
    assert got.shape == gather.shape == (dims[0], dims[1], dims[2] * dims[3])
    np.testing.assert_allclose(got, gather, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


def test_plain_core_bf16_value_accumulates_in_f32():
    """A bf16 value is read exactly, summed in f32 and rounded once at the
    end: the result is the f32 result on the same values, rounded to bf16."""
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = make_inputs(dims, shapes, P, seed=1)
    v16 = torch.from_numpy(value).to(torch.bfloat16)
    got = ms_deform_attn_core(v16, shapes, torch.from_numpy(loc), torch.from_numpy(aw))
    ref = ms_deform_attn_core(v16.float(), shapes, torch.from_numpy(loc),
                              torch.from_numpy(aw))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_wrapper_takes_cpu_tensors_to_the_plain_core():
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = (torch.from_numpy(a) for a in make_inputs(dims, shapes, P, seed=2))
    before = msda.MSDA_FWD.launches
    out = msda.ms_deform_attn(value, shapes, loc, aw)
    assert torch.equal(out, ms_deform_attn_core(value, shapes, loc, aw))
    assert msda.MSDA_FWD.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors():
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = (torch.from_numpy(a) for a in make_inputs(dims, shapes, P))
    before = msda.MSDA_FWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        msda.MSDA_FWD(value, shapes, loc, aw)
    assert msda.MSDA_FWD.launches == before


def test_kernel_source_builds_for_hopper_into_an_ignored_directory():
    """The build is nvcc for sm_90a into build/, which git ignores, and the
    source names the TPU kernel it replaces."""
    from multimodal_feature_learning_tpu_torch.ops import build

    root = Path(__file__).resolve().parents[1]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    lib = build.library_path("msda_fwd.cu")
    assert lib.parent == root / "build" / "kernels"
    assert "build/" in (root / ".gitignore").read_text().split()
    src = (build.CSRC_DIR / "msda_fwd.cu").read_text()
    assert "ops/pallas_msda.py::_msda_fwd_kernel" in src
    assert 'extern "C" int msda_fwd_launch' in src


def test_wrapper_argtypes_match_the_launcher_signature():
    """ctypes passes every pointer and the stream as c_void_p and every int
    as c_int, in the order of the C signature."""
    src = (Path(msda.__file__).resolve().parents[1] / "csrc" / "msda_fwd.cu").read_text()
    sig = src[src.index("msda_fwd_launch("):src.index(")", src.index("msda_fwd_launch("))]
    params = [p.strip() for p in sig[len("msda_fwd_launch("):].split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    bound = ["int" if t is ctypes.c_int else "ptr" for t in msda.MsdaForwardKernel.argtypes]
    assert kinds == bound
