"""The port's on-card tools, run on the CPU at tiny widths: each ``run()``
returns its named rows, and each refuses the default device on a host
without CUDA. Their numbers on the CPU mean nothing; on the card they are
taken by ``chip_smoke.py``'s ``tools`` phase."""

from __future__ import annotations

import copy
import math

import pytest
import torch

from test_torch_common import VOCAB_SIZE, jax_small_cfg, torch_cfg_like

from multimodal_feature_learning_tpu_torch.tools import (
    bench_fused_decode, onchip_decode_parity, probe_op_overhead, profile_decode, profile_msda,
)


@pytest.fixture(scope="module")
def cfg():
    return torch_cfg_like(jax_small_cfg())


def finite(v):
    return isinstance(v, float) and math.isfinite(v)


def test_profile_msda_rows():
    result = profile_msda.run("cpu", iters=1, B=1, H=2, Dh=8, P=2, shapes=(6, 3),
                              cases=(("encoder", 9), ("decoder", 2)))
    rows = result["rows"]
    assert [(r["case"], r["backend"]) for r in rows] == [
        ("encoder", "plain"), ("encoder", "kernel"), ("decoder", "plain"), ("decoder", "kernel")]
    assert all(finite(r["fwd_ms"]) and finite(r["fwd_bwd_ms"]) for r in rows)
    table = profile_msda.markdown(result)
    assert table.count("| backend | fwd ms | fwd+bwd ms |") == 2


def test_profile_msda_backends_agree_on_the_cpu():
    """The kernel backend's Function takes the plain core on the CPU, so
    both backends give the same forward and gradients there."""
    value, loc, aw = profile_msda.inputs(1, 4, 2, 8, (6, 3), 2, torch.device("cpu"))
    plain = [f() for f in profile_msda.backend_fns("plain", value, (6, 3), loc, aw)]
    kernel = [f() for f in profile_msda.backend_fns("kernel", value, (6, 3), loc, aw)]
    torch.testing.assert_close(kernel[0], plain[0])
    for a, b in zip(kernel[1], plain[1]):
        torch.testing.assert_close(a, b)


def test_profile_decode_rows(cfg):
    result = profile_decode.run("cpu", cfg=cfg, vocab_size=VOCAB_SIZE, batch=2, lcs=(8, 4),
                                depths=(2, 1), n=1, reps=1)
    rows = result["rows"]
    for name in ("serve_Lc8_d2_ms", "proposal_only_ms", "decode_Lc8_d2_ms", "serve_Lc4_d2_ms",
                 "ms_per_decode_token_d2", "serve_Lc8_d1_ms", "serve_Lc4_d1_ms",
                 "ms_per_decode_token_d1", "ms_per_token_per_layer",
                 "ms_per_token_depth_independent"):
        assert name in rows, name
    assert finite(rows["serve_Lc8_d2_ms"]) and finite(rows["proposal_only_ms"])
    assert set(result["decode_steps"]) == {"Lc8_d2", "Lc4_d2", "Lc8_d1", "Lc4_d1"}
    assert result["decode_impl"] == "xla"


def test_bench_fused_decode_rows(cfg):
    rows = bench_fused_decode.run("cpu", batch=2, iters=1, n_batches=1, cfg=cfg,
                                  vocab_size=VOCAB_SIZE)
    for arm in bench_fused_decode.ARMS:
        assert finite(rows[f"{arm}_videos_per_s"]) and finite(rows[f"{arm}_step_ms"]), arm
    # the bf16 trunk runs (it raised before the port had one); an unknown dtype raises
    bf16 = bench_fused_decode.run("cpu", arms=("xla", "fusedb_int8"), batch=2, iters=1,
                                  n_batches=1, dtype="bfloat16", cfg=cfg,
                                  vocab_size=VOCAB_SIZE)
    assert bf16["dtype"] == "bfloat16" and finite(bf16["fusedb_int8_step_ms"])
    assert cfg.compute_dtype == "float32"  # the caller's config is left as it was
    with pytest.raises(ValueError, match="float16"):
        bench_fused_decode.run("cpu", dtype="float16", cfg=cfg, vocab_size=VOCAB_SIZE)
    with pytest.raises(ValueError, match="arm"):
        bench_fused_decode.arm_settings("fusedc")


def test_onchip_decode_parity_rows(cfg):
    rows = onchip_decode_parity.run("cpu", n_videos=2, batch=2, snapshot=None,
                                    cfg=copy.deepcopy(cfg), vocab_size=VOCAB_SIZE)
    assert rows["n_videos"] == 2 and rows["checkpoint"] == "random weights (seed 0)"
    G = cfg.dataset.activity_net.max_gt_target_segments
    for arm in onchip_decode_parity.ARMS:
        assert rows[f"{arm}_events"] == 2 * G
        assert rows[f"{arm}_seg_max_delta"] == 0.0  # the proposal stack is untouched
        assert 0.0 <= rows[f"{arm}_event_exact_pct"] <= 100.0
        assert 0.0 <= rows[f"{arm}_token_agree_pct"] <= 100.0


@pytest.mark.parametrize("tool", [probe_op_overhead, profile_msda, profile_decode,
                                  bench_fused_decode, onchip_decode_parity],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_raises_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.run()
