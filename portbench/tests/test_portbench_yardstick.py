"""The frozen bounds and model-FLOP counts against hand counts at one small
shape each."""

import math

import torch

from portbench.yardstick import (PEAK_BYTES_PER_S, PEAK_F32_FLOPS, PEAK_TF32_FLOPS,
                                 decode_step_model_flops, fused_decode_bound_ms,
                                 fused_decode_meta_inputs, memory_kv_model_flops,
                                 msda_bound_ms, msda_bwd_bound_ms, msda_value_rows)


def msda_case():
    """B 1, one level of T 4, H 1, Dh 2, Q 2, P 2: taps at x = loc * 4 - 0.5
    of 0.0 (row 0 alone), 1.5 (rows 1, 2), 3.0 (row 3 alone) and 0.0 again."""
    shapes = (4,)
    x = torch.tensor([[0.0, 1.5], [3.0, 0.0]])
    loc = ((x + 0.5) / 4).view(1, 2, 1, 1, 2)
    aw = torch.full((1, 2, 1, 1, 2), 0.5)
    value = torch.zeros(1, 4, 1, 2)
    out = torch.zeros(1, 2, 2)
    return value, shapes, loc, aw, out


def test_msda_value_rows_counts_each_touched_row_once():
    value, shapes, loc, aw, out = msda_case()
    assert msda_value_rows(shapes, loc) == 4


def test_msda_bounds_by_hand():
    value, shapes, loc, aw, out = msda_case()
    # forward: 4 rows x 2 channels x 4 bytes, loc 16, aw 16, out 16 bytes;
    # 4 taps x (5 x 2 + 8) operations
    nbytes, flops = 4 * 2 * 4 + 16 + 16 + 16, 4 * 18
    ms, by, _ = msda_bound_ms(value, shapes, loc, aw, out)
    assert math.isclose(ms, 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS))
    assert by == "bytes"
    g = torch.zeros(1, 2, 2)
    # backward: the rows 32, g 16, loc 16, aw 16, dvalue 32, dloc and daw 2 x 16
    nbytes, flops = 32 + 16 + 16 + 16 + 32 + 32, 4 * (8 * 2 + 15)
    ms, _, counted = msda_bwd_bound_ms(value, shapes, loc, aw, g)
    assert counted == nbytes
    assert math.isclose(ms, 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS))


def test_fused_decode_bound_by_hand():
    B, G, D, H, depth, Tc, S, F = 1, 1, 4, 1, 1, 3, 5, 8
    dims = (B, G, D, H, depth, Tc, S, F)
    inp = fused_decode_meta_inputs(dims)
    Sp = 128
    # two attentions (4 matrices and 4 biases each), the MLP, 3 LayerNorms
    weights = 4 * (2 * (4 * D * D + 4 * D) + D * F + F + F * D + D + 6 * D)
    memory = 2 * Sp * D * 4
    masks = 2 * Sp + 2 * 4
    x = 2 * (2 * D * 4)
    valid = 2
    caches = 2 * (valid - 1) * D * 4 + 2 * D * 4
    nbytes = weights + memory + masks + x + caches
    M = 2
    macs = M * D * D * 4 + 2 * D * D + 2 * M * D * F + 2 * M * valid * D + 2 * M * Sp * D
    ms, _, counted, flops, _ = fused_decode_bound_ms(inp, dims, valid)
    assert counted == nbytes and flops == 2 * macs
    assert math.isclose(ms, 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                                      3 * flops / PEAK_TF32_FLOPS))


def test_model_flops_by_hand():
    # G 2 rows, D 4, one layer, F 8, S 5 memory tokens, V 7 words, step 3:
    # q k v o 4 x 16, own keys 2 x 3 x 4, q o 2 x 16, memory 2 x 5 x 4,
    # MLP 2 x 4 x 8 multiply-adds a layer; head 4 x 7
    per_row = (64 + 24 + 32 + 40 + 64) + 28
    assert decode_step_model_flops(2, 4, 1, 8, 5, 7, 3) == 2 * 2 * per_row
    # K and V of 5 tokens through 2 layers: 2 x 2 x 5 x 16 multiply-adds
    assert memory_kv_model_flops(4, 2, 5) == 2 * 2 * 2 * 5 * 16
