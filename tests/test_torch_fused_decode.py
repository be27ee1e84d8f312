"""The port's fused decode step (``ops/fused_decode.py``) and the greedy
decode through it, against the JAX package's.

At the dims of ``tests/test_fused_decode.py`` (B=2, G=4, S=40, D=64, depth
2, H=2, vocab 50, LC=8), f32 on the CPU. The flax caption decoder's params,
perturbed from a numpy seed, are carried into the port's module; inputs come
from numpy. The JAX side runs ``fused_decode_step`` in Pallas interpret mode.
On the CPU the port's wrapper takes its plain version, which the card's
kernel is held to by ``chip_smoke.py``. Tolerances: stacked weights and
masks exact, memory K/V 1e-6 of their largest value (einsums summed in
another order), one step 1e-5 (f32 products summed in another order
through two layers), greedy tokens exact in f32."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import flatten_params, perturb

from multimodal_feature_learning_tpu.models import caption_decoder as jcd
from multimodal_feature_learning_tpu.ops import fused_decode as jfd
from multimodal_feature_learning_tpu_torch.config import Config, check_decode_options
from multimodal_feature_learning_tpu_torch.models import caption_decoder as tcd
from multimodal_feature_learning_tpu_torch.ops import fused_decode as tfd
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

PAD, BOS, EOS = 1, 2, 3
B, G, S, D, DEPTH, H, VOCAB, LC = 2, 4, 40, 64, 2, 2, 50, 8
R, SP = 2 * G, 128


@pytest.fixture(scope="module")
def setup():
    """(flax module, params, port module, memory, pad, zeroed) as numpy."""
    jmod = jcd.UnimodalCaptionDecoder(vocab_size=VOCAB, seq_len=LC, d_model=D,
                                      depth=DEPTH, num_heads=H)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((B * G, LC), jnp.int32),
                       jnp.zeros((B * G, S, D)))
    params = jax.tree_util.tree_map(jnp.asarray, perturb(params, seed=1, scale=0.05))
    tmod = tcd.UnimodalCaptionDecoder(VOCAB, D, DEPTH, H)
    load_flax_params(tmod, flatten_params(params))
    rng = np.random.default_rng(0)
    memory = rng.normal(size=(B, S, D)).astype(np.float32)
    pad = rng.random((B * G, S)) < 0.3
    zeroed = rng.random((B * G, S)) < 0.4
    return jmod, params, tmod.eval(), memory, pad, zeroed


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def jax_masks(pad, zeroed):
    """The mask inputs as JAX ``_greedy_decode_fused`` builds them
    (``models/caption_decoder.py:440-456``)."""
    p = jnp.asarray(pad).reshape(B, G, S)
    if zeroed is not None:
        z = jnp.asarray(zeroed).reshape(B, G, S)
        block = p | z
        m = jnp.sum(~p & z, axis=2).astype(jnp.float32)
        log_m = jnp.where(m > 0, jnp.log(jnp.maximum(m, 1.0)), -1e20)
    else:
        block = p
        log_m = jnp.zeros((B, G), jnp.float32)
    mask_i8 = jnp.pad(block, ((0, 0), (0, 0), (0, SP - S)), constant_values=True)
    mask_i8 = jnp.tile(mask_i8.astype(jnp.int8), (1, 2, 1))
    return mask_i8, jnp.tile(log_m, (1, 2))[..., None]


def step_inputs(setup, step, kv_mode, bias_col, seed=0, pad=None, dtype="float32"):
    """Numpy inputs of one step, the memory K/V from JAX's stacking; with
    ``dtype`` "bfloat16" the weights, memory, x and caches are rounded to
    bf16 (held as f32 arrays, which both sides cast back exactly) and the
    memory K/V are stacked in bf16, as JAX's bf16 decode stacks them."""
    _, params, _, memory, pad0, zeroed = setup
    rng = np.random.default_rng(seed)
    ct = jnp.dtype(dtype)
    w = {k: v.astype(ct) for k, v in jfd.extract_decoder_weights(params).items()}
    mem_k, mem_v = jfd.stack_memory_kv(w, jnp.asarray(memory).astype(ct), SP)
    ks = vs = None
    if kv_mode == "int8":
        mem_k, ks = jfd.quantize_kv_int8(mem_k)
        mem_v, vs = jfd.quantize_kv_int8(mem_v)
    mask_i8, log_m = jax_masks(pad0 if pad is None else pad, zeroed if bias_col else None)
    kc = np.zeros((DEPTH, B, LC * G, D), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :step * G] = rng.normal(size=(DEPTH, B, step * G, D))
    vc[:, :, :step * G] = rng.normal(size=(DEPTH, B, step * G, D))
    x = rng.normal(size=(B, R, D)).astype(np.float32)

    def held(a):  # ct values as an f32 array (int8 and f32 arrays as they are)
        a = np.asarray(a)
        return a if a.dtype in (np.int8, np.float32, bool) else a.astype(np.float32)

    kc, vc, x = (np.asarray(jnp.asarray(a).astype(ct).astype(jnp.float32)) for a in (kc, vc, x))
    return [held(a) if a is not None else None
            for a in (x, kc, vc, mem_k, mem_v, ks, vs, mask_i8, log_m)], w


def run_both(setup, step, kv_mode, bias_col, grid, pad=None, dtype="float32"):
    """One step on both sides; returns ([x, k caches, v caches] of JAX,
    those of the port) as f32 numpy arrays."""
    (x, kc, vc, mk, mv, ks, vs, mask, log_m), w = step_inputs(setup, step, kv_mode,
                                                              bias_col, pad=pad, dtype=dtype)
    ct, tt = jnp.dtype(dtype), getattr(torch, dtype)

    def jx(a):  # the K/V keep int8; the rest go in ct
        return jnp.asarray(a) if a.dtype == np.int8 else jnp.asarray(a).astype(ct)

    def tx(a):
        return t(a) if a.dtype == np.int8 else t(a).to(tt)

    ref = jfd.fused_decode_step(
        jx(x), jx(kc), jx(vc), jnp.int32(step), jnp.int32(step + 1), jx(mk), jx(mv),
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        jnp.asarray(mask), jnp.asarray(log_m), w, G=G, num_heads=H,
        has_bias_col=bias_col, grid_mode=grid, interpret=True)
    tw = {k: v.to(tt) for k, v in tfd.extract_decoder_weights(setup[2]).items()}
    got = tfd.fused_decode_step(
        tx(x), tx(kc), tx(vc), step, step + 1, tx(mk), tx(mv),
        None if ks is None else t(ks), None if vs is None else t(vs), t(mask), t(log_m),
        tw, G=G, num_heads=H, has_bias_col=bias_col, grid_mode=grid)
    assert all(a.dtype == tt for a in got)
    return ([np.asarray(a.astype(jnp.float32)) for a in ref],
            [a.float().numpy() for a in got])


def test_extract_decoder_weights_matches_jax(setup):
    _, params, tmod, *_ = setup
    ref = jfd.extract_decoder_weights(params)
    got = tfd.extract_decoder_weights(tmod)
    assert tuple(got) == tfd.W_ORDER and set(ref) == set(tfd.W_ORDER)
    for name in tfd.W_ORDER:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)


def test_stack_memory_kv_matches_jax(setup):
    _, params, tmod, memory, *_ = setup
    ref = jfd.stack_memory_kv(jfd.extract_decoder_weights(params), jnp.asarray(memory), SP)
    got = tfd.stack_memory_kv(tfd.extract_decoder_weights(tmod), t(memory), tfd.padded_len(S))
    for a, b in zip(got, ref):
        assert a.shape == (DEPTH, B, SP, D)
        ref = np.asarray(b)
        assert np.abs(a.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        assert not a[:, :, S:].any()


def test_quantize_kv_int8_matches_jax(setup):
    _, params, _, memory, *_ = setup
    mem_k, _ = jfd.stack_memory_kv(jfd.extract_decoder_weights(params), jnp.asarray(memory), SP)
    ref_q, ref_s = jfd.quantize_kv_int8(mem_k)
    got_q, got_s = tfd.quantize_kv_int8(t(mem_k))
    assert got_q.dtype == torch.int8 and got_s.shape == (DEPTH, B, 1, SP)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-7)
    # a value on a half step rounds to even, as jnp.round does
    half = torch.tensor([[[[127.0, 2.5, -0.5, 1.5]]]])
    np.testing.assert_array_equal(tfd.quantize_kv_int8(half)[0].numpy(),
                                  np.asarray(jfd.quantize_kv_int8(jnp.asarray(half.numpy()))[0]))


@pytest.mark.parametrize("bias_col", [False, True])
def test_decode_masks_match_jax(setup, bias_col):
    *_, pad, zeroed = setup
    ref_mask, ref_logm = jax_masks(pad, zeroed if bias_col else None)
    mask, log_m = tfd.decode_masks(t(pad), t(zeroed) if bias_col else None, B, G, SP)
    assert mask.dtype == torch.int8 and log_m.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(log_m.numpy(), np.asarray(ref_logm))


@pytest.mark.parametrize("step", [0, 4])
@pytest.mark.parametrize("kv_mode", ["dense", "int8"])
@pytest.mark.parametrize("bias_col", [False, True])
@pytest.mark.parametrize("grid", ["video", "batch"])
def test_fused_step_matches_jax(setup, grid, bias_col, kv_mode, step):
    (rx, rkc, rvc), (gx, gkc, gvc) = run_both(setup, step, kv_mode, bias_col, grid)
    np.testing.assert_allclose(gx, rx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gkc, rkc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gvc, rvc, rtol=0, atol=1e-5)
    rows = slice(step * G, (step + 1) * G)
    assert np.abs(gkc[:, :, rows]).min() > 0  # the commit rows were written


# bf16: both sides round where JAX's kernel writes ``.astype(ct)``, but the
# interpret-mode kernel is one XLA program on the CPU, whose compiler may
# keep a bf16 intermediate in f32 (excess precision: gelu's -x*sqrt(1/2)
# before the f32 erfc is one such), so a few of the hidden state's values
# land one bf16 step apart and move on through the LayerNorms. The step is
# held to 1/64 of the largest value, two bf16 steps at that magnitude.
BF16_STEP_REL = 1 / 64


@pytest.mark.parametrize("kv_mode", ["dense", "int8"])
@pytest.mark.parametrize("bias_col", [False, True])
@pytest.mark.parametrize("grid", ["video", "batch"])
def test_fused_step_bf16_matches_jax(setup, grid, bias_col, kv_mode):
    """The step in bf16 (weights, x, caches and dense memory K/V), step 4:
    the port's plain version returns bf16 and stays within BF16_STEP_REL of
    JAX's kernel in interpret mode; the rows that are not committed stay
    exactly as they were."""
    (rx, rkc, rvc), (gx, gkc, gvc) = run_both(setup, 4, kv_mode, bias_col, grid,
                                              dtype="bfloat16")
    for got, ref in ((gx, rx), (gkc, rkc), (gvc, rvc)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_STEP_REL * np.abs(ref).max())
    rows = slice(4 * G, 5 * G)
    assert np.abs(gkc[:, :, rows]).min() > 0
    keep = np.ones(gkc.shape[2], bool)
    keep[rows] = False
    np.testing.assert_array_equal(gkc[:, :, keep], rkc[:, :, keep])


def _decode_both(setup, zeroed_on, faster_eval, grid, kv_mode="dense"):
    jmod, params, tmod, memory, pad, zeroed = setup
    z = zeroed if zeroed_on else None
    ref = jcd.greedy_decode(
        jmod, params, jnp.asarray(memory), jnp.asarray(pad), LC, BOS, EOS, PAD,
        faster_eval=faster_eval, groups=G, zeroed_mask=None if z is None else jnp.asarray(z),
        decode_impl="fused", kv_mode=kv_mode, fused_grid=grid, fused_interpret=True)
    with torch.no_grad():
        got = tcd.greedy_decode(
            tmod, t(memory), t(pad), LC, BOS, EOS, PAD, faster_eval=faster_eval,
            groups=G, zeroed_mask=None if z is None else t(z), decode_impl="fused",
            kv_mode=kv_mode, fused_grid=grid)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("grid", ["video", "batch"])
@pytest.mark.parametrize("zeroed_on", [False, True])
@pytest.mark.parametrize("faster_eval", [False, True])
def test_greedy_decode_fused_matches_jax(setup, faster_eval, zeroed_on, grid):
    ref, got = _decode_both(setup, zeroed_on, faster_eval, grid)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("grid", ["video", "batch"])
@pytest.mark.parametrize("zeroed_on", [False, True])
@pytest.mark.parametrize("faster_eval", [False, True])
def test_fused_decode_matches_plain_op_decode(setup, faster_eval, zeroed_on, grid):
    """The port's two decode paths agree token for token in f32, as JAX pins
    for its own two (``tests/test_fused_decode.py``)."""
    _, _, tmod, memory, pad, zeroed = setup
    z = t(zeroed) if zeroed_on else None
    with torch.no_grad():
        plain = tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD,
                                  faster_eval=faster_eval, groups=G, zeroed_mask=z)
        fused = tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD,
                                  faster_eval=faster_eval, groups=G, zeroed_mask=z,
                                  decode_impl="fused", fused_grid=grid)
    assert len({tuple(r) for r in plain.tolist()}) > 1  # not a degenerate decode
    assert torch.equal(fused, plain)


@pytest.mark.parametrize("grid", ["video", "batch"])
def test_int8_kv_mostly_agrees_with_plain_op_decode(setup, grid):
    _, _, tmod, memory, pad, zeroed = setup
    with torch.no_grad():
        plain = tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD, groups=G,
                                  zeroed_mask=t(zeroed))
        int8 = tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD, groups=G,
                                 zeroed_mask=t(zeroed), decode_impl="fused", kv_mode="int8",
                                 fused_grid=grid)
    assert int8.shape == plain.shape and bool(((int8 >= 0) & (int8 < VOCAB)).all())
    agree = (int8 == plain).float().mean().item()
    assert agree >= 0.9, f"int8 token agreement {agree:.3f}"


@pytest.mark.parametrize("bias_col", [False, True])
def test_fully_blocked_row_follows_the_fused_kernel(setup, bias_col):
    """A row whose every memory position is blocked averages V over the Sp
    padded columns in the TPU kernel of grid "video", over the S columns in
    JAX's XLA path, and over the Bt·Sp columns of its batch tile in the
    kernel of grid "batch". The port follows the "video" kernel in both
    grids."""
    jmod, params, tmod, memory, pad, zeroed = setup
    pad = pad.copy()
    pad[3] = True  # event 3 of video 0: rows 3 (commit) and 3 + G (predict)
    (rx, _, _), (gx, _, _) = run_both(setup, 0, "dense", bias_col, "video", pad=pad)
    np.testing.assert_allclose(gx, rx, rtol=0, atol=1e-5)
    (bx, _, _), (gbx, _, _) = run_both(setup, 0, "dense", bias_col, "batch", pad=pad)
    np.testing.assert_allclose(gbx, rx, rtol=0, atol=1e-5)
    batch_gap = np.abs(bx - rx).max(axis=-1)  # JAX's two kernels
    assert batch_gap[0, 3] > 1e-2 and batch_gap[0, 3 + G] > 1e-2, batch_gap
    batch_gap[0, [3, 3 + G]] = 0
    assert batch_gap.max() < 1e-5, batch_gap

    # the gap to JAX's XLA path: logits of the predict rows after one step
    z = jnp.asarray(zeroed) if bias_col else None
    prev = jnp.full((B * G,), BOS, jnp.int32)
    pad_tok = jnp.full((B * G,), PAD, jnp.int32)
    mem_kv = jmod.apply(params, jnp.asarray(memory),
                        method=jcd.UnimodalCaptionDecoder.precompute_memory_kv)
    caches = jnp.zeros((DEPTH, B * G, LC, D))
    xla_logits, _, _ = jmod.apply(params, prev, pad_tok, 0, caches, caches, mem_kv,
                                  jnp.asarray(pad), G, z,
                                  method=jcd.UnimodalCaptionDecoder.decode_pair)
    with torch.no_grad():
        pad_t = t(pad)
        mem_k, mem_v = tfd.stack_memory_kv(tfd.extract_decoder_weights(tmod), t(memory), SP)
        mask, log_m = tfd.decode_masks(pad_t, t(zeroed) if bias_col else None, B, G, SP)
        x = torch.cat([tmod.embed_at(t(np.asarray(prev)).long(), 0)[:, 0].reshape(B, G, D),
                       tmod.embed_at(t(np.asarray(pad_tok)).long(), 1)[:, 0].reshape(B, G, D)],
                      dim=1)
        kc = torch.zeros((DEPTH, B, LC * G, D))
        x_out, _, _ = tfd.fused_decode_step(
            x, kc, kc.clone(), 0, 1, mem_k, mem_v, None, None, mask, log_m,
            tfd.extract_decoder_weights(tmod), G=G, num_heads=H, has_bias_col=bias_col)
        fused_logits = tmod.head(x_out[:, G:].reshape(B * G, D)).numpy()
    gap = np.abs(fused_logits - np.asarray(xla_logits)).max(axis=1)
    assert gap[3] > 1e-2, gap  # the blocked row: the two JAX paths differ
    assert np.delete(gap, 3).max() < 1e-4, gap  # every other row: they agree


def test_cpu_tensors_take_the_plain_version(setup):
    _, _, tmod, memory, pad, zeroed = setup
    for kernel in tfd.FUSED_DECODE.values():
        kernel.launches = 0
    with torch.no_grad():
        for grid in ("video", "batch"):
            tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD, groups=G,
                              zeroed_mask=t(zeroed), decode_impl="fused", fused_grid=grid)
    assert [k.launches for k in tfd.FUSED_DECODE.values()] == [0, 0]
    # the kernel's own wrapper takes CUDA tensors only: it raises, it does not fall back
    (x, kc, vc, mk, mv, ks, vs, mask, log_m), _ = step_inputs(setup, 0, "dense", False)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.FUSED_DECODE["video"](t(x), t(kc), t(vc), 0, 1, t(mk), t(mv), None, None,
                                  t(mask), t(log_m), tfd.extract_decoder_weights(tmod),
                                  G=G, num_heads=H, has_bias_col=False)


def test_kernel_wrapper_refuses_dtypes_it_does_not_take(setup):
    """The kernel takes x in f32 or bf16, with the caches, the weights and
    dense memory K/V in x's dtype: anything else raises TypeError before a
    launch, on any device."""
    (x, kc, vc, mk, mv, ks, vs, mask, log_m), _ = step_inputs(setup, 0, "dense", False)
    w = tfd.extract_decoder_weights(setup[2])
    kernel = tfd.FUSED_DECODE["video"]
    before = kernel.launches
    args = dict(G=G, num_heads=H, has_bias_col=False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel(t(x).half(), t(kc).half(), t(vc).half(), 0, 1, t(mk).half(), t(mv).half(),
               None, None, t(mask), t(log_m), {k: v.half() for k, v in w.items()}, **args)
    with pytest.raises(TypeError, match="k_caches must be torch.bfloat16"):
        kernel(t(x).bfloat16(), t(kc), t(vc), 0, 1, t(mk), t(mv), None, None, t(mask),
               t(log_m), w, **args)
    with pytest.raises(TypeError, match="sa_wq must be torch.float32"):
        kernel(t(x), t(kc), t(vc), 0, 1, t(mk), t(mv), None, None, t(mask), t(log_m),
               {k: v.bfloat16() for k, v in w.items()}, **args)
    assert kernel.launches == before


def test_fused_decode_needs_groups(setup):
    _, _, tmod, memory, pad, _ = setup
    with pytest.raises(ValueError, match="groups"):
        tcd.greedy_decode(tmod, t(memory[:1]), t(pad[:1]), LC, BOS, EOS, PAD, groups=1,
                          decode_impl="fused")


@pytest.mark.parametrize("knob, value", [("decode_impl", "pallas"), ("decode_kv", "bf16"),
                                         ("decode_fused_grid", "tile")])
def test_unknown_decode_options_raise(setup, knob, value):
    _, _, tmod, memory, pad, _ = setup
    with pytest.raises(ValueError, match=knob):
        check_decode_options(**{knob: value})
    kw = {"decode_impl": "fused", "kv_mode": "dense", "fused_grid": "video"}
    kw[{"decode_impl": "decode_impl", "decode_kv": "kv_mode",
        "decode_fused_grid": "fused_grid"}[knob]] = value
    with pytest.raises(ValueError, match=knob):
        tcd.greedy_decode(tmod, t(memory), t(pad), LC, BOS, EOS, PAD, groups=G, **kw)
    from multimodal_feature_learning_tpu_torch.models.dvc import UnimodalDVC

    cfg = Config()
    setattr(cfg, knob, value)
    with pytest.raises(ValueError, match=knob):
        UnimodalDVC(cfg, VOCAB)


def test_config_defaults_are_jax_defaults():
    from multimodal_feature_learning_tpu.config import load_config

    jcfg, cfg = load_config(), Config()
    for knob in ("decode_impl", "decode_kv", "decode_fused_grid"):
        assert getattr(cfg, knob) == jcfg[knob]


# --------------------------------------------------------------------------
# the kernel's arithmetic in plain form: the 3xTF32 split of its products and
# the chunked combine of its cross-attention (csrc/fused_decode.cu)
# --------------------------------------------------------------------------


def tf32_operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, size=4096))
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 * 2.0 ** -12 + 1, 0.0, -0.0])
    return torch.from_numpy(np.concatenate([a, ties]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_parts_have_ten_mantissa_bits(seed):
    hi, lo = tfd.split_tf32(tf32_operands(seed))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # round to nearest, ties away from zero, as cvt.rna.tf32.f32
    np.testing.assert_array_equal(hi[-5:-2].numpy(), np.float32([1 + 2.0 ** -10,
                                                                  -(1 + 2.0 ** -10),
                                                                  1 + 2.0 ** -10]))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_reconstructs_f32(seed):
    x = tf32_operands(seed)
    hi, lo = tfd.split_tf32(x)
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("m, k, n", [(320, 512, 2048), (320, 2048, 512)],
                         ids=["mlp1", "mlp2"])
def test_three_pass_tf32_product_keeps_f32_accuracy(m, k, n):
    """lo*hi + hi*lo + hi*hi, each product of two TF32 values exact in f32,
    at the step's widest shapes: within 1e-6 of max |ref| of the f64
    product, where one pass would not be."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = tfd.split_tf32(torch.from_numpy(a)), tfd.split_tf32(torch.from_numpy(b))
    three = ((al @ bh + ah @ bl) + ah @ bh).double().numpy()
    one = (ah @ bh).double().numpy()
    tol = 1e-6 * np.abs(ref).max()
    assert np.abs(three - ref).max() <= tol
    assert np.abs(one - ref).max() > 10 * tol


def chunked_cross_attention(qc, mem_k, mem_v, k_scales, v_scales, blocked, log_m, kb, vb,
                            *, num_heads, has_bias_col, chunk=tfd.CHUNK):
    """The kernel's cross-attention: per chunk of `chunk` columns its max
    m_c, its sum l_c of exp(logit - m_c) and its unnormalised weighted sum
    of V; then the combine in chunk order, weighed by exp(m_c - max) over
    sum_c exp(m_c - max) l_c + exp(bias - max), with the bias column once."""
    B, R, D = qc.shape
    H, Sp = num_heads, mem_k.shape[1]
    Dh = D // H
    scale = Dh ** -0.5
    kv_int8 = mem_k.dtype == torch.int8

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, Dh).transpose(1, 2)

    q, kh, vh = heads(qc), heads(mem_k.float()), heads(mem_v.float())
    ms, ls, outs = [], [], []
    for c0 in range(0, Sp, chunk):
        cols = slice(c0, c0 + chunk)
        lg = q @ kh[:, :, cols].transpose(-1, -2)
        if kv_int8:
            lg = lg * k_scales[:, None, :, cols]
        lg = lg.masked_fill(blocked[..., cols], tfd.NEG_MASK) * scale
        m = lg.amax(dim=-1, keepdim=True)
        e = torch.exp(lg - m)
        ls.append(e.sum(dim=-1, keepdim=True))
        if kv_int8:
            e = e * v_scales[:, None, :, cols]
        outs.append(e @ vh[:, :, cols])
        ms.append(m)
    mx = torch.stack(ms).amax(dim=0)
    bias_logit = None
    if has_bias_col:
        bias_logit = (q * kb.reshape(H, 1, Dh)).sum(dim=-1, keepdim=True) * scale \
            + log_m[:, None]
        mx = torch.maximum(mx, bias_logit)
    ws = [torch.exp(m - mx) for m in ms]
    denom = sum(w * l for w, l in zip(ws, ls))
    e_bias = torch.exp(bias_logit - mx) if has_bias_col else torch.zeros_like(mx)
    denom = denom + e_bias
    out = sum(w * o for w, o in zip(ws, outs)) / denom
    if has_bias_col:
        out = out + (e_bias / denom) * vb.reshape(H, 1, Dh)
    return out


@pytest.mark.parametrize("kv_mode", ["dense", "int8"])
@pytest.mark.parametrize("bias_col", [False, True])
def test_chunked_combine_matches_plain_cross_attention(bias_col, kv_mode):
    """Five chunks of 128 columns (S=563, Sp=640) at the flagship's head
    width, with event 0 of video 0 blocked at every position: the combine
    rule the kernel follows gives the plain cross-attention within 1e-6 of
    its largest value, the fully blocked rows (the mean of V over all Sp
    columns) included."""
    Bc, Gc, Sc, Dc, Hc = 2, 10, 563, 512, 8
    rng = np.random.default_rng(7)
    Spc = tfd.padded_len(Sc)
    assert Spc // tfd.CHUNK == 5
    qc = torch.from_numpy(rng.normal(size=(Bc, 2 * Gc, Dc)).astype(np.float32))
    mem_k = torch.from_numpy(rng.normal(size=(Bc, Spc, Dc)).astype(np.float32))
    mem_v = torch.from_numpy(rng.normal(size=(Bc, Spc, Dc)).astype(np.float32))
    mem_k[:, Sc:] = mem_v[:, Sc:] = 0
    ks = vs = None
    if kv_mode == "int8":
        (mem_k, ks), (mem_v, vs) = (tfd.quantize_kv_int8(t[None]) for t in (mem_k, mem_v))
        mem_k, mem_v, ks, vs = mem_k[0], mem_v[0], ks[0], vs[0]
    pad = torch.from_numpy(rng.random((Bc * Gc, Sc)) < 0.5)
    pad[0] = True
    zeroed = torch.from_numpy(rng.random((Bc * Gc, Sc)) < 0.3) if bias_col else None
    mask_i8, log_m = tfd.decode_masks(pad, zeroed, Bc, Gc, Spc)
    blocked = (mask_i8 != 0)[:, None]
    kb = torch.from_numpy(rng.normal(size=Dc).astype(np.float32))
    vb = torch.from_numpy(rng.normal(size=Dc).astype(np.float32))
    kw = dict(num_heads=Hc, has_bias_col=bias_col)
    ref = tfd.cross_attention_plain(qc, mem_k, mem_v, ks, vs, blocked, log_m, kb, vb, **kw)
    got = chunked_cross_attention(qc, mem_k, mem_v, ks, vs, blocked, log_m, kb, vb, **kw)
    tol = 1e-6 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    if not bias_col:  # the blocked rows average V over all Sp columns
        v = mem_v.float() * (vs[0, 0, :, None] if kv_mode == "int8" else 1.0)
        mean_v = v[0].mean(dim=0).reshape(Hc, 1, Dc // Hc)
        for r in (0, Gc):
            assert (got[0, :, r:r + 1] - mean_v).abs().max().item() <= tol



# --------------------------------------------------------------------------
# the kernel's contract beyond the flagship's widths: other shapes against
# JAX's Pallas kernel in interpret mode, and the wrapper's stated limits
# --------------------------------------------------------------------------

# (G, S, D, depth, H, mlp_ratio) of each narrow shape, B = 2, LC_OTHER
# caption tokens: Sp 768 (S 700, six chunks of the kernel's cross-attention
# where the flagship has five), G 20 (40 rows: two row tiles), mlp_ratio 2
# (two partials of the W2 product), Dh 16 (4 heads of 16) and depth 3
OTHER_SHAPES = {
    "sp768": (4, 700, 64, 2, 2, 4.0),
    "g20": (20, 40, 64, 2, 2, 4.0),
    "mlp_ratio2": (4, 40, 64, 2, 2, 2.0),
    "dh16": (4, 40, 64, 2, 4, 4.0),
    "depth3": (4, 40, 64, 3, 2, 4.0),
}
LC_OTHER = 4


def other_shape_setup(name):
    """(flax module, params, port module, memory, pad, zeroed) at
    OTHER_SHAPES[name]: weights drawn with numpy (kernels N(0, 1/fan_in),
    biases and embeddings N(0, 0.05^2) and 1, LayerNorm scales 1 + N(0,
    0.05^2)) into the tree JAX's init would make, so no JAX init runs; the
    memory N(0, 9), so that attention over a long one is not flat."""
    G, S, D, depth, H, ratio = OTHER_SHAPES[name]
    jmod = jcd.UnimodalCaptionDecoder(vocab_size=VOCAB, seq_len=LC_OTHER, d_model=D,
                                      depth=depth, num_heads=H, mlp_ratio=ratio)
    tree = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                          jnp.zeros((B * G, LC_OTHER), jnp.int32), jnp.zeros((B * G, S, D)))
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(path, leaf):
        key = str(path[-1].key)
        if key == "kernel":
            return rng.normal(0, leaf.shape[0] ** -0.5, leaf.shape).astype(np.float32)
        if key == "scale":
            return (1 + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        scale = 1.0 if key == "embedding" else 0.05
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, tree)
    tmod = tcd.UnimodalCaptionDecoder(VOCAB, D, depth, H, mlp_ratio=ratio)
    load_flax_params(tmod, flatten_params(params))
    memory = rng.normal(0, 3, size=(B, S, D)).astype(np.float32)
    pad = rng.random((B * G, S)) < 0.3
    zeroed = rng.random((B * G, S)) < 0.4
    return jmod, jax.tree_util.tree_map(jnp.asarray, params), tmod.eval(), memory, pad, zeroed


@pytest.mark.parametrize("name, grid, kv_mode", [
    ("sp768", "video", "dense"), ("g20", "batch", "dense"), ("mlp_ratio2", "video", "int8"),
    ("dh16", "batch", "int8"), ("depth3", "video", "dense")])
def test_other_shapes_step_matches_jax(name, grid, kv_mode):
    """At each shape of OTHER_SHAPES, with the bias column: one fused step
    (step 2) of the port's plain version against JAX's Pallas kernel in
    interpret mode, within the step's 1e-5."""
    _, params, tmod, memory, pad, zeroed = other_shape_setup(name)
    G, S, D, depth, H, _ = OTHER_SHAPES[name]
    Sp, step = tfd.padded_len(S), 2
    rng = np.random.default_rng(1)
    w = jfd.extract_decoder_weights(params)
    mem_k, mem_v = jfd.stack_memory_kv(w, jnp.asarray(memory), Sp)
    ks = vs = None
    if kv_mode == "int8":
        mem_k, ks = jfd.quantize_kv_int8(mem_k)
        mem_v, vs = jfd.quantize_kv_int8(mem_v)
    mask, log_m = tfd.decode_masks(t(pad), t(zeroed), B, G, Sp)
    kc = np.zeros((depth, B, LC_OTHER * G, D), np.float32)
    kc[:, :, :step * G] = rng.normal(size=(depth, B, step * G, D))
    vc = np.zeros_like(kc)
    vc[:, :, :step * G] = rng.normal(size=(depth, B, step * G, D))
    x = rng.normal(size=(B, 2 * G, D)).astype(np.float32)
    ref = jfd.fused_decode_step(
        jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(step), jnp.int32(step + 1),
        mem_k, mem_v, ks, vs, jnp.asarray(mask.numpy()), jnp.asarray(log_m.numpy()), w, G=G,
        num_heads=H, has_bias_col=True, grid_mode=grid, interpret=True)
    got = tfd.fused_decode_step(
        t(x), t(kc), t(vc), step, step + 1, t(mem_k), t(mem_v),
        None if ks is None else t(ks), None if vs is None else t(vs), mask, log_m,
        tfd.extract_decoder_weights(tmod), G=G, num_heads=H, has_bias_col=True, grid_mode=grid)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["sp768", "g20"])
def test_other_shapes_greedy_decode_matches_jax(name):
    """The greedy fused decode (bias column on) at the shapes that take the
    kernel's new paths in the decode loop itself, more than five chunks and
    more than 32 rows, equal to JAX's in interpret mode token for token;
    the decode is not degenerate."""
    jmod, params, tmod, memory, pad, zeroed = other_shape_setup(name)
    G = OTHER_SHAPES[name][0]
    jtok = jcd.greedy_decode(
        jmod, params, jnp.asarray(memory), jnp.asarray(pad), LC_OTHER, BOS, EOS, PAD, groups=G,
        zeroed_mask=jnp.asarray(zeroed), decode_impl="fused", fused_grid="video",
        fused_interpret=True)
    with torch.no_grad():
        ttok = tcd.greedy_decode(tmod, t(memory), t(pad), LC_OTHER, BOS, EOS, PAD, groups=G,
                                 zeroed_mask=t(zeroed), decode_impl="fused", fused_grid="video")
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert len({tuple(r) for r in ttok.tolist()}) > 1


def kernel_args(D=64, H=2, F=256, G=4, Tc=8, S=40, depth=1):
    """Inputs of one kernel call on the CPU at these widths (zeros)."""
    Sp = tfd.padded_len(S)
    w = {}
    for n in tfd.W_ORDER:
        rows = F if n == "mlp_w2" else D
        cols = F if n in ("mlp_w1", "mlp_b1") else D
        w[n] = torch.zeros((depth, rows, cols) if "_w" in n else (depth, 1, cols))
    kc = torch.zeros((depth, 1, Tc * G, D))
    mask, log_m = tfd.decode_masks(torch.zeros((G, S), dtype=torch.bool), None, 1, G, Sp)
    mem = torch.zeros((depth, 1, Sp, D))
    return (torch.zeros((1, 2 * G, D)), kc, kc.clone(), 0, 1, mem, mem.clone(), None, None,
            mask, log_m, w), dict(G=G, num_heads=H, has_bias_col=False)


@pytest.mark.parametrize("widths, limit", [
    (dict(D=64, H=8), "multiple of 16 up to 128"),                # Dh 8
    (dict(D=144, H=1, F=576), "multiple of 16 up to 128"),        # Dh 144
    (dict(D=96, H=2, F=200), "MLP width F that is a multiple of 16"),
    (dict(D=1024, H=8, F=4096, G=200), "shared-memory plan needs"),  # 400 rows at Dh 128
])
def test_kernel_raises_beyond_its_stated_limits(widths, limit):
    """A shape beyond the wrapper's stated limits raises ValueError naming
    the limit before any launch, on any device; the wrapper computes
    nothing in its place (no fallback to the plain version)."""
    args, kw = kernel_args(**widths)
    for kernel in tfd.FUSED_DECODE.values():
        before = kernel.launches
        with pytest.raises(ValueError, match=limit):
            kernel(*args, **kw)
        assert kernel.launches == before


def test_shared_memory_plan_fits_the_stated_shapes():
    """The general schedule's plan (``smem_plan``, the mirror of the
    kernel's) fits one H100 block at every D = H Dh up to 1024 with Dh 16 to
    128, G up to 32, Sp up to 4096, captions of 8 to 200 tokens, f32 and
    bf16, dense and int8 K/V; at the flagship's widths the GEMM tiles read
    the whole W slab and the combine keeps every chunk in one group, and at
    f32 D = 1024 they read it in chunks."""
    for Dh in range(16, 129, 16):
        for D in range(Dh, 1025, Dh):
            if D % 64 and D > 128:
                continue  # a sample of the widths: every multiple of 64, and the narrow ones
            for G, Sp, Tc, bf16, int8 in itertools.product(
                    (1, 10, 32), (128, 640, 4096), (8, 200), (False, True), (False, True)):
                plan = tfd.smem_plan(D, Dh, G, Tc, Sp, bf16, int8)
                assert plan["bytes"] <= tfd.SMEM_MAX, (D, Dh, G, Sp, Tc, bf16, int8, plan)
    flagship = tfd.smem_plan(512, 64, 10, 20, 640, False, False)
    assert (flagship["kc"], flagship["cg"], flagship["ca_nbuf"], flagship["sa_eg"]) \
        == (512, 5, 2, 10)
    assert tfd.smem_plan(1024, 64, 10, 20, 640, False, False)["kc"] < 1024
    assert tfd.width_flags(512, 64) == ()
    assert tfd.width_flags(768, 64) == ("-DFD_D=768", "-DFD_DH=64")
