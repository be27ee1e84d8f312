"""The MSDA backward of the port against the JAX package's.

The plain backward (``ops/ms_deform_attn.py::ms_deform_attn_core_backward``)
is the CPU path of ``MSDeformAttnFunction`` and the oracle of the CUDA
kernel K2 (``csrc/msda_bwd.cu``). It is held against the JAX oracle
``_vjp_bwd_xla`` and the Pallas backward ``_bwd_pallas`` in interpret mode,
on ragged level lengths with locations out of [0, 1] and on exact integer
coordinates: dvalue, dloc and daw each within atol 1e-5 x max |ref| (sums of
Dh products and of up to Q * P scattered terms, taken in another order).
The Function's CPU backward is the plain backward exactly.

The strict-inside rule of dloc is decided on the coordinate rounded twice,
``fl(fl(loc * T) - 0.5)``, as the forward kernel K1 computes it. So does
``_vjp_bwd_xla``, and the port equals it on every tap. The Pallas backward
in interpret mode evaluates ``loc * T - 0.5`` without the intermediate
rounding. Where a tap sits on a token's centre, the two roundings can land
on either side of it: at the first token it sees a tiny positive
coordinate and calls the tap inside, and at an interior token it may take
the left neighbour. dloc jumps at exactly those points, so on those taps,
and only there, the Pallas dloc differs from both the XLA oracle's and the
port's; the test finds them from the inputs and checks that they are the
only differences."""

from __future__ import annotations

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_msda import CASES, make_inputs

from multimodal_feature_learning_tpu.ops.pallas_msda import _bwd_pallas, _vjp_bwd_xla
from multimodal_feature_learning_tpu_torch.models.msda_module import MSDeformAttn
from multimodal_feature_learning_tpu_torch.ops import msda
from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn_core, ms_deform_attn_core_backward,
)


def grad_out(dims, seed=3):
    B, Q, H, Dh = dims
    return np.random.default_rng(seed).normal(size=(B, Q, H * Dh)).astype(np.float32)


def assert_rel_close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30))


def rounding_moves_tap(loc, shapes):
    """(B, Q, H, L, P) bool: taps whose strict-inside test or left token
    differs between the twice-rounded f32 coordinate and the once-rounded
    one (the exact ``loc * T - 0.5``, which float64 holds for an f32 loc,
    rounded to f32). dloc is discontinuous there: it jumps at the clamp
    edges and at every whole-token coordinate."""
    differs = np.zeros(loc.shape, bool)
    for l, T in enumerate(shapes):
        twice = (loc[..., l, :] * np.float32(T)).astype(np.float32) - np.float32(0.5)
        once = (loc[..., l, :].astype(np.float64) * T - 0.5).astype(np.float32)
        inside = [(x > 0) & (x < T - 1) for x in (twice, once)]
        left = [np.floor(np.clip(x, 0, T - 1)) for x in (twice, once)]
        differs[..., l, :] = (inside[0] != inside[1]) | (left[0] != left[1])
    return differs


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_xla_and_pallas(case):
    dims, shapes, P = CASES[case]
    value, loc, aw = make_inputs(dims, shapes, P)
    g = grad_out(dims)
    got = ms_deform_attn_core_backward(torch.from_numpy(value), shapes,
                                       torch.from_numpy(loc), torch.from_numpy(aw),
                                       torch.from_numpy(g))
    jargs = tuple(jnp.asarray(a) for a in (value, loc, aw))
    xla = _vjp_bwd_xla(shapes, False, jargs, jnp.asarray(g))
    pallas = _bwd_pallas(jargs[0], shapes, jargs[1], jargs[2], jnp.asarray(g),
                         interpret=True)
    for name, t, x, p in zip(("dvalue", "dloc", "daw"), got, xla, pallas):
        assert t.shape == x.shape, name
        assert_rel_close(t.numpy(), x)
        if name != "dloc":
            assert_rel_close(t.numpy(), p)
    straddle = rounding_moves_tap(loc, shapes)
    assert straddle.any() and straddle.mean() < 0.1
    differs = np.abs(got[1].numpy() - np.asarray(pallas[1])) > 1e-5 * np.abs(pallas[1]).max()
    assert not (differs & ~straddle).any()
    np.testing.assert_allclose(got[1].numpy()[~straddle], np.asarray(pallas[1])[~straddle],
                               rtol=0, atol=1e-5 * float(np.abs(pallas[1]).max()))
    # the inputs reach every rule: taps clamped at both ends (dloc 0) and
    # taps strictly inside
    dloc = got[1].numpy()
    assert (dloc == 0).any() and (dloc != 0).any()


def bf16_values(a):
    """An f32 array rounded to bf16, as a bf16 tensor and a bf16 JAX array."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_bf16_matches_pallas(case):
    """value and the output gradient in bf16, loc and aw f32, as the bf16
    train step hands them to K2: the plain backward returns dvalue in bf16
    and dloc, daw in f32, as JAX's ``_bwd_pallas`` (interpret mode) does.
    Both widen to f32, sum in f32 and round dvalue once, so dvalue is held
    to one bf16 step at its largest magnitude (2^-7 x max |ref|: the f32
    sums, taken in another order, may round to either neighbour); dloc and
    daw to the f32 bound above, dloc away from the taps the Pallas kernel
    rounds to another side (``rounding_moves_tap``)."""
    dims, shapes, P = CASES[case]
    value, loc, aw = make_inputs(dims, shapes, P, seed=7)
    (tv, jv), (tg, jg) = bf16_values(value), bf16_values(grad_out(dims, seed=8))
    got = ms_deform_attn_core_backward(tv, shapes, torch.from_numpy(loc),
                                       torch.from_numpy(aw), tg)
    ref = _bwd_pallas(jv, shapes, jnp.asarray(loc), jnp.asarray(aw), jg, interpret=True)
    assert got[0].dtype == torch.bfloat16 and ref[0].dtype == jnp.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    assert_rel_close(got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)),
                     rel=2.0 ** -7)
    assert_rel_close(got[2].numpy(), ref[2])
    straddle = rounding_moves_tap(loc, shapes)
    np.testing.assert_allclose(got[1].numpy()[~straddle], np.asarray(ref[1])[~straddle],
                               rtol=0, atol=1e-5 * float(np.abs(ref[1]).max()))


def test_kernel_wrappers_refuse_dtypes_their_kernels_do_not_take():
    """K1 and K2 take value (and K2 the output gradient) in f32 or bf16:
    an f16 value raises TypeError before anything is launched, on any
    device; K2 takes an output gradient in value's dtype only."""
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = (torch.from_numpy(a) for a in make_inputs(dims, shapes, P))
    g = torch.from_numpy(grad_out(dims))
    before = msda.MSDA_FWD.launches, msda.MSDA_BWD.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        msda.MSDA_FWD(value.half(), shapes, loc, aw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        msda.MSDA_BWD(value.half(), shapes, loc, aw, g.half())
    with pytest.raises(TypeError, match="float"):
        msda.MSDA_FWD(value, shapes, loc.to(torch.int32), aw)
    assert (msda.MSDA_FWD.launches, msda.MSDA_BWD.launches) == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_backward_on_cpu_is_the_plain_backward(case):
    dims, shapes, P = CASES[case]
    value, loc, aw = (torch.from_numpy(a).requires_grad_()
                      for a in make_inputs(dims, shapes, P, seed=4))
    g = torch.from_numpy(grad_out(dims, seed=5))
    out = msda.ms_deform_attn(value, shapes, loc, aw)
    assert torch.equal(out.detach(), ms_deform_attn_core(value.detach(), shapes,
                                                         loc.detach(), aw.detach()))
    got = torch.autograd.grad(out, (value, loc, aw), g)
    ref = ms_deform_attn_core_backward(value.detach(), shapes, loc.detach(),
                                       aw.detach(), g)
    for t, r in zip(got, ref):
        assert torch.equal(t, r)


def test_plain_backward_matches_autograd_away_from_tap_boundaries():
    """Where no coordinate sits on a whole token or a clamp edge, the
    strict-inside rule and autograd through the plain core agree."""
    B, Q, H, Dh, shapes, P = 2, 6, 2, 8, (9, 5, 3), 3
    rng = np.random.default_rng(6)
    value = torch.from_numpy(rng.normal(size=(B, sum(shapes), H, Dh)).astype(np.float32))
    # coordinates x = loc * T - 0.5 kept at least 0.01 from every whole number
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, H, len(shapes), P))
    for l, T in enumerate(shapes):
        x = loc[:, :, :, l] * T - 0.5
        x = np.floor(x) + np.clip(x - np.floor(x), 0.01, 0.99)
        loc[:, :, :, l] = (x + 0.5) / T
    loc = torch.from_numpy(loc.astype(np.float32))
    aw = torch.from_numpy(rng.uniform(size=loc.shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, Q, H * Dh)).astype(np.float32))
    for l, T in enumerate(shapes):
        x = loc[:, :, :, l] * T - 0.5
        assert ((x - x.round()).abs() > 1e-3).all()
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    ref = torch.autograd.grad(ms_deform_attn_core(leaves[0], shapes, *leaves[1:]),
                              leaves, g)
    got = ms_deform_attn_core_backward(value, shapes, loc, aw, g)
    for t, r in zip(got, ref):
        torch.testing.assert_close(t, r, rtol=0, atol=1e-5 * float(r.abs().max()))


def test_module_gradients_reach_every_projection_on_cpu():
    """Through the Function, the loss reaches value_proj, sampling_offsets
    and attention_weights (a forward that cut the graph would leave them
    without gradient)."""
    torch.manual_seed(0)
    m = MSDeformAttn(16, 2, 2, 2)
    nn_init = torch.nn.init
    nn_init.normal_(m.sampling_offsets.weight, std=0.1)
    shapes = (6, 3)
    rng = np.random.default_rng(7)
    query = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(0.1, 0.9, size=(2, 4, 2, 1)).astype(np.float32))
    value_in = torch.from_numpy(rng.normal(size=(2, 9, 16)).astype(np.float32))
    out, _, _ = m(query, ref, value_in, shapes)
    out.square().sum().backward()
    for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        w = getattr(m, name).weight
        assert w.grad is not None and w.grad.abs().sum() > 0, name


def test_forward_kernel_refuses_inputs_that_need_a_graph():
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = (torch.from_numpy(a) for a in make_inputs(dims, shapes, P))
    value.requires_grad_()
    before = msda.MSDA_FWD.launches
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        msda.MSDA_FWD(value, shapes, loc, aw)
    assert msda.MSDA_FWD.launches == before


def test_backward_kernel_refuses_non_cuda_tensors():
    dims, shapes, P = CASES["ragged"]
    value, loc, aw = (torch.from_numpy(a) for a in make_inputs(dims, shapes, P))
    g = torch.from_numpy(grad_out(dims))
    before = msda.MSDA_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        msda.MSDA_BWD(value, shapes, loc, aw, g)
    assert msda.MSDA_BWD.launches == before


def test_backward_kernel_source_and_binding():
    """K2 is built with K1 (one nvcc each, sm_90a), names the TPU kernel it
    replaces, and its ctypes argtypes follow the C signature."""
    from multimodal_feature_learning_tpu_torch.ops import build

    assert "msda_bwd.cu" in build.KERNEL_SOURCES
    src = (build.CSRC_DIR / "msda_bwd.cu").read_text()
    assert "ops/pallas_msda.py::_msda_bwd_kernel" in src
    sig = src[src.index("msda_bwd_launch("):src.index(")", src.index("msda_bwd_launch("))]
    params = [p.strip() for p in sig[len("msda_bwd_launch("):].split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    bound = ["int" if t is ctypes.c_int else "ptr" for t in msda.MsdaBackwardKernel.argtypes]
    assert kinds == bound
    assert Path(build.library_path("msda_bwd.cu")).parent == build.BUILD_DIR
