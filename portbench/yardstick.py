"""The benchmark's yardstick: the card's peaks, the least time each
hand-written kernel of the port could take on its inputs (its bound), and
the model FLOPs of a serving dispatch.

``msda_value_rows``, ``msda_bound_ms``, ``msda_bwd_bound_ms`` and
``fused_decode_bound_ms`` are frozen copies of the functions of the same
names in the repository's ``chip_smoke.py``: a later change to the program
does not move them. ``fused_decode_bound_ms`` reads only the shapes and
element sizes of its inputs, so ``fused_decode_meta_inputs`` gives it
tensors on the meta device, built from a configuration's sizes.
"""

from __future__ import annotations

# f32 peak outside the tensor cores, dense TF32 and bf16 tensor-core peaks
# and memory rate of an H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the layer weights of one fused decode step, in the kernel's order
FUSED_W_ORDER = (
    "sa_wq", "sa_bq", "sa_wk", "sa_bk", "sa_wv", "sa_bv", "sa_wo", "sa_bo",
    "ca_wq", "ca_bq", "ca_wk", "ca_bk", "ca_wv", "ca_bv", "ca_wo", "ca_bo",
    "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2",
    "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b",
)
KV_PAD = 128  # the fused decode pads the memory's S to a multiple of this


def padded_len(S: int) -> int:
    return -(-S // KV_PAD) * KV_PAD


def msda_value_rows(shapes, loc):
    """Distinct value rows (b, s, h) the function needs on these locations:
    for each tap the row at floor(x) and, where x is not a whole number, the
    row after it (x = clip(loc * T - 0.5, 0, T - 1), as the plain core has
    it)."""
    import torch

    B, Q, H, L, P = loc.shape
    needed = torch.zeros((B, sum(shapes), H), dtype=torch.bool, device=loc.device)
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1).expand(B, Q, H, P)
    h = torch.arange(H, device=loc.device).view(1, 1, H, 1).expand(B, Q, H, P)
    start = 0
    for l, T in enumerate(shapes):
        x = (loc[:, :, :, l, :] * T - 0.5).clamp(0, T - 1)
        i0 = x.floor()
        inside = x > i0
        i0 = i0.long()
        needed[b, start + i0, h] = True
        i1 = (i0 + 1).clamp(max=T - 1)
        needed[b[inside], start + i1[inside], h[inside]] = True
        start += T
    return int(needed.sum())


def msda_bound_ms(value, shapes, loc, aw, out):
    """Least time for the function on these inputs: the value rows that
    these locations touch read once, loc and aw read once, the output
    written once; 5 f32 operations per tap and channel (two products and a
    sum for the lerp, one product and one sum to accumulate) plus 8 per tap
    for its coordinate and weights."""
    Dh = value.shape[3]
    value_bytes = msda_value_rows(shapes, loc) * Dh * value.element_size()
    nbytes = value_bytes + sum(t.numel() * t.element_size() for t in (loc, aw, out))
    taps = loc.numel()
    flops = taps * (5 * Dh + 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            value_bytes)


def msda_bwd_bound_ms(value, shapes, loc, aw, g):
    """Least time for the backward on these inputs: the value rows that
    these locations touch and g, loc and aw read once; dvalue (all of it),
    dloc and daw written once; 8 f32 operations per tap and channel (two
    products and two sums for g0 and g1, two products and two sums into
    dvalue) plus 15 per tap (coordinate, weights, dloc, daw)."""
    Dh = value.shape[3]
    value_bytes = msda_value_rows(shapes, loc) * Dh * value.element_size()
    nbytes = value_bytes + sum(t.numel() * t.element_size() for t in (g, loc, aw)) \
        + value.numel() * value.element_size() + 2 * loc.numel() * 4
    flops = loc.numel() * (8 * Dh + 15)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes)


def fused_decode_bound_ms(inp, dims, valid_len: int):
    """Least time for one step on these inputs, on the kernel's route: every
    weight, the memory K/V (and scales), mask, log_m and x read once, the
    cache rows of positions < step read once, x_out and the committed rows
    written once, at 3.35 TB/s; against the operations of the products (two
    per multiply-add: per layer the q, k, v (commit rows), o, q', o'
    projections, the MLP, and both attentions over the keys each row reads,
    valid_len own-event keys and Sp memory columns): in f32 done three times
    over, as 3xTF32 does, at the TF32 tensor-core peak; in bf16 once, at the
    bf16 tensor-core peak. Returns (bound ms, what bounds it, bytes, flops,
    and for the record the bound of the same operations once in f32 on the
    CUDA cores)."""
    B, G, D, H, depth, Tc, S, F = dims
    R, Sp = 2 * G, inp["mem_k"].shape[2]
    M = B * R

    def size(t):
        return t.numel() * t.element_size() if t is not None else 0

    nbytes = sum(size(t) for t in inp["weights"].values())
    nbytes += sum(size(inp[k]) for k in ("mem_k", "mem_v", "k_scales", "v_scales",
                                          "mask_i8", "log_m"))
    nbytes += 2 * size(inp["x"])
    row = D * inp["k_caches"].element_size()
    nbytes += 2 * depth * B * (valid_len - 1) * G * row  # cache rows read
    nbytes += 2 * depth * B * G * row                    # committed rows written
    macs = M * D * D * 4 + 2 * B * G * D * D + 2 * M * D * F \
        + 2 * M * valid_len * D + 2 * M * Sp * D
    flops = 2 * depth * macs
    bf16 = inp["x"].element_size() == 2
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS if bf16 else 3 * flops / PEAK_TF32_FLOPS
    f32_simt_ms = 1e3 * max(t_bytes, flops / PEAK_F32_FLOPS)
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes, flops, f32_simt_ms)


def fused_decode_meta_inputs(dims, dtype_bytes: int = 4):
    """The inputs of one fused decode step at ``dims`` (B, G, D, H, depth,
    Tc, S, F) as meta tensors (shapes and element sizes, no storage): dense
    memory K/V, no scales, the kernel's layouts (``ops/fused_decode.py``)."""
    import torch

    B, G, D, H, depth, Tc, S, F = dims
    dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    Sp = padded_len(S)

    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    weights = {}
    for name in FUSED_W_ORDER:
        width = F if name in ("mlp_w1", "mlp_b1") else D
        if "_w" in name:
            weights[name] = meta(depth, F if name == "mlp_w2" else D, width)
        else:
            weights[name] = meta(depth, 1, width)
    return {"x": meta(B, 2 * G, D), "k_caches": meta(depth, B, Tc * G, D),
            "v_caches": meta(depth, B, Tc * G, D), "mem_k": meta(depth, B, Sp, D),
            "mem_v": meta(depth, B, Sp, D), "k_scales": None, "v_scales": None,
            "mask_i8": meta(B, 2 * G, Sp, dt=torch.int8),
            "log_m": meta(B, 2 * G, 1, dt=torch.float32), "weights": weights}


def decode_step_model_flops(G: int, D: int, depth: int, F: int, S: int, V: int, t: int):
    """Model FLOPs of one greedy decode step at position ``t`` (1-based) of
    one video's ``G`` event rows, two per multiply-add, each token counted
    once: per layer the self-attention's q, k, v, o projections and its
    products over the ``t`` keys so far, the cross-attention's q and o
    projections and its products over the memory's ``S`` tokens, the MLP;
    then the vocabulary head."""
    per_layer = 4 * D * D + 2 * t * D + 2 * D * D + 2 * S * D + 2 * D * F
    return 2 * G * (depth * per_layer + D * V)


def memory_kv_model_flops(D: int, depth: int, S: int):
    """Model FLOPs of projecting one video's memory (``S`` tokens) to every
    caption layer's cross-attention K and V, once a dispatch."""
    return 2 * depth * 2 * S * D * D
