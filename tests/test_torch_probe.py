"""K5, the kernel of the per-op overhead probe, and the port's probe.

``ops/probe_add.py::probe_add_plain`` against the JAX repository's own
``add_kernel`` (``tools/probe_op_overhead.py``, imported from its file and
left as it is) run through ``pl.pallas_call(..., interpret=True)``: bitwise
equal, f32 and bf16, at the probe's (160, 64) and at a ragged shape. On the
CPU the wrapper takes the plain version; the kernel itself, which has no
interpret mode, is held to the plain version on the card by
``chip_smoke.py``. Then the probe tool in eager mode on the CPU, at a tiny
chain length."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodal_feature_learning_tpu_torch.ops import build
from multimodal_feature_learning_tpu_torch.ops.probe_add import (
    PROBE_ADD, probe_add, probe_add_plain,
)
from multimodal_feature_learning_tpu_torch.tools import probe_op_overhead

ROOT = Path(__file__).resolve().parents[1]


def jax_probe_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_op_overhead", ROOT / "tools" / "probe_op_overhead.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values with the low 16 bits cleared: exact in bf16, so both
    frameworks convert them alike."""
    return (a.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("shape", [(160, 64), (1_000_003,)], ids=["probe", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_is_bitwise_jax_add_kernel(shape, dtype):
    rng = np.random.default_rng(0)
    # magnitudes up to 1e3, where adding 1 rounds in bf16
    x = bf16_exact(rng.normal(size=shape) * np.exp(rng.uniform(-3, 7, size=shape)))
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(jdtype)
    ref = pl.pallas_call(jax_probe_tool().add_kernel,
                         out_shape=jax.ShapeDtypeStruct(jx.shape, jx.dtype),
                         interpret=True)(jx)
    got = probe_add_plain(torch.from_numpy(x).to(tdtype))
    assert got.shape == shape and got.dtype == tdtype
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(bits(got.view(view).numpy()),
                                  bits(np.asarray(ref.view(jnp.uint16 if dtype == "bfloat16"
                                                           else jnp.uint32))))
    assert not np.array_equal(bits(got.view(view).numpy()), bits(np.asarray(jx.view(
        jnp.uint16 if dtype == "bfloat16" else jnp.uint32))))


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(160, 64).to(torch.bfloat16)
    PROBE_ADD.launches = 0
    assert torch.equal(probe_add(x), probe_add_plain(x))
    assert PROBE_ADD.launches == 0
    # the kernel's own wrapper takes CUDA tensors only: it raises, it does not fall back
    with pytest.raises(ValueError, match="CUDA"):
        PROBE_ADD(x)
    assert "probe_add.cu" in build.KERNEL_SOURCES
    assert (build.CSRC_DIR / PROBE_ADD.source).is_file()


def test_probe_runs_every_row_eagerly_on_the_cpu():
    result = probe_op_overhead.run("cpu", modes=("eager",), n1=2, n2=4, reps=1, iters=1)
    assert result["device"] == "cpu" and result["chain_lengths"] == [2, 4]
    assert set(result["eager"]) == set(probe_op_overhead.ROWS)
    assert all(math.isfinite(v) for v in result["eager"].values())
    assert result["probe_add_launches"] == {"eager": 0}  # the plain version on the CPU


def test_probe_rows_are_chained_on_their_carry():
    rows = probe_op_overhead.make_rows(torch.device("cpu"))
    for name, (body, x) in rows.items():
        out = body(body(x))
        assert out.shape == x.shape and out.dtype == x.dtype, name
    body, x = rows["probe_add_us_per_launch"]
    assert float(body(body(x)).float().max()) == 2.0


def test_graph_mode_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        probe_op_overhead.run("cpu", modes=("graph",))
    body, x = probe_op_overhead.make_rows(torch.device("cpu"))["add_us_per_op"]
    with pytest.raises(ValueError, match="CUDA"):
        probe_op_overhead.graph_ms(body, x, 2, 1, 1)
    with pytest.raises(ValueError, match="mode"):
        probe_op_overhead.run("cpu", modes=("jit",))


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_wrapper_raises_off_the_card_and_on_a_strided_tensor(layout):
    """The wrapper takes CUDA tensors only and contiguous ones only; a CPU
    tensor, strided or not, is refused before any launch."""
    x = torch.randn(64, 160).to(torch.bfloat16)
    if layout == "strided":
        x = x.t()
        assert not x.is_contiguous()
    PROBE_ADD.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        PROBE_ADD(x)
    assert PROBE_ADD.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_bitwise_on_a_misaligned_view(dtype):
    """x[1:] of 1,000,004 elements starts 4 (f32) or 2 (bf16) bytes past a
    16-byte boundary, as the kernel's scalar path sees it on the card."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(bf16_exact(rng.normal(size=1_000_004) * 1e3)).to(dtype)
    x = full[1:]
    assert x.is_contiguous() and x.storage_offset() == 1
    got = probe_add_plain(x)
    ref = probe_add_plain(x.clone())
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), ref.view(view))
    assert torch.equal(got.float(), (x.float() + 1).to(dtype).float())
