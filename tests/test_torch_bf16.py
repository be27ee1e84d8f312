"""The port's bf16 mixed-precision policy (``compute_dtype="bfloat16"``)
against the JAX package's, at ``_small_cfg`` dims on the CPU.

Both sides run the same flax params (perturbed from a numpy seed, carried
into the port by ``utils.weights``) on the same numpy inputs. The port
rounds to bf16 where JAX does: each dense layer's product, then its bias
sum (``layers.Linear``), exact GELU step by step (``layers.gelu``), f32
logits, softmaxes and LayerNorm statistics; JAX's ``forward_eval`` run
eagerly (as its own bf16 tests and the port's other tests call it) then
gives the same bf16 trunk as the port. Inside a compiled XLA program bf16
rounds in other places (XLA may keep a bf16 intermediate in f32, its
"excess precision"; its f32 exp and its sums differ in the last bits), and
the small model's perturbed weights carry a last-bit difference far. JAX's
``forward_serve`` (its fused decode kernel in interpret mode) and its train
loss run compiled, the serve without excess precision, which saves half a
minute of eager dispatch a call. So the results are held by agreement rates
and bf16 tolerances:

- ``forward_eval`` in teacher_forcing: matched indices equal; the
  teacher-forced log-probabilities and the segments within 0.05, the bound
  JAX holds its own bf16 trunk to f32 at (``tests/test_bf16.py``); the
  argmax captions agree on at least 90% of tokens;
- ``forward_serve``, plain-op and fused (grid "video" dense, grid "batch"
  int8): ``k`` and ``valid`` equal, segments within 0.05 of the duration,
  greedy tokens agree on at least 90%;
- a bf16 train step: finite, every gradient f32 on its f32 master, the loss
  within 2% of JAX's jitted bf16 loss (0.25% measured; a bf16 step is
  2^-8 = 0.4% relative, and the loss sums terms of the bf16 trunk);
- the boundary: the memory and query features bf16, everything the matcher
  and the criterion read f32, the masters f32 after every forward.

The f32 path is the identity of the policy: with ``compute_dtype``
"float32" the params are used as they are and the split-bias layers are
torch's own, bit for bit (the other ``test_torch_*`` files hold that path
against JAX as before)."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_common import (
    PAD, VOCAB_SIZE, build_jax_model, build_port_model, jax_small_cfg, serve_inputs,
    torch_cfg_like,
)

from multimodal_feature_learning_tpu.models.criterion import SetCriterion as JaxCriterion
from multimodal_feature_learning_tpu.models.criterion import build_weight_dict as jax_weights
from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device, forward_loss
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
from multimodal_feature_learning_tpu_torch.models.dvc import UnimodalDVC
from multimodal_feature_learning_tpu_torch.models.layers import Linear, gelu
from multimodal_feature_learning_tpu_torch.utils.precision import (
    cast_floating, params_in, resolve_dtype,
)

ATOL = 0.05
AGREE = 0.9
LOSS_REL = 0.02


def bf16_cfg(**over):
    jcfg = jax_small_cfg()
    jcfg.compute_dtype = "bfloat16"
    for k, v in over.items():
        jcfg[k] = v
    return jcfg


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, flax params, port model, numpy batch, port batch)."""
    jcfg = bf16_cfg()
    jmodel, params = build_jax_model(jcfg)
    batch = next(synthetic_batches(torch_cfg_like(jcfg), 2, VOCAB_SIZE, seed=0))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    return jcfg, jmodel, params, build_port_model(jcfg, params), batch, \
        batch_to_device(batch, "cpu")


def agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a == b).mean())


def test_boundary_dtypes_and_f32_masters(pair):
    *_, tmodel, _, tb = pair
    assert tmodel.compute_dtype == torch.bfloat16 and tmodel.kv_dtype == torch.bfloat16
    with torch.no_grad(), params_in(tmodel, tmodel.compute_dtype):
        assert tmodel.caption.head.weight.dtype == torch.bfloat16
        out = tmodel._propose(tb["video_tensor"], tb["video_mask"], tb["durations"],
                              with_enc_aux=True)
    assert out["memory"].dtype == out["query_features"].dtype == torch.bfloat16
    for key in ("pred_segments", "pred_count", "outputs_segment_all", "outputs_count_all",
                "backbone_mask_prediction", "sampling_locations_enc", "attn_weights_dec"):
        assert out[key].dtype == torch.float32, key
    for aux in out["aux_outputs_enc"]:
        assert aux["pred_segments"].dtype == aux["pred_count"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


def test_forward_eval_teacher_forcing_matches_jax(pair):
    _, jmodel, params, tmodel, batch, tb = pair
    rout, rcap, ridx, raux, _ = jmodel.forward_eval(params, batch, "teacher_forcing")
    gout, gcap, gidx, gaux, _ = tmodel.forward_eval(tb, "teacher_forcing")
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux))
    assert gout["pred_captions"].dtype == torch.float32
    np.testing.assert_allclose(gout["pred_captions"].numpy(),
                               np.asarray(rout["pred_captions"]), rtol=0, atol=ATOL)
    for g, r in zip(gout["aux_outputs_caption"], rout["aux_outputs_caption"]):
        np.testing.assert_allclose(g["pred_captions"].numpy(), np.asarray(r["pred_captions"]),
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(gout["pred_segments"].numpy(),
                               np.asarray(rout["pred_segments"]), rtol=0, atol=ATOL)
    assert agreement(gcap.numpy(), rcap) >= AGREE
    assert len(np.unique(gcap.numpy())) > 2  # not a degenerate argmax


@pytest.fixture(scope="module")
def serve_pair(pair):
    """The same weights with the fused decode on both sides."""
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
    from test_torch_common import BOS, EOS

    jcfg, _, params, _, _, _ = pair
    jcfg = bf16_cfg(decode_impl="fused")
    jmodel = jax_build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    return jcfg, jmodel, params, build_port_model(jcfg, params)


@pytest.mark.parametrize("impl, kv, grid", [("xla", "dense", "video"),
                                            ("fused", "dense", "video"),
                                            ("fused", "int8", "batch")])
def test_forward_serve_matches_jax(serve_pair, monkeypatch, impl, kv, grid):
    import multimodal_feature_learning_tpu.ops.fused_decode as jfd

    jcfg, jmodel, params, tmodel = serve_pair
    for m in (jmodel, tmodel):
        m.decode_impl, m.decode_kv, m.decode_fused_grid = impl, kv, grid
    orig = jfd.fused_decode_step
    monkeypatch.setattr(jfd, "fused_decode_step",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    video, mask, durations = serve_inputs(jcfg)
    # compiled, without XLA's excess precision: seconds, not half a minute
    ref = jax.jit(jmodel.forward_serve).lower(params, video, mask, durations).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, video, mask, durations)
    got = tmodel.forward_serve(torch.from_numpy(video), torch.from_numpy(mask),
                               torch.from_numpy(durations))
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    dur = durations[:, None, None]
    np.testing.assert_allclose(got["segments"].numpy() / dur,
                               np.asarray(ref["segments"]) / dur, rtol=0, atol=ATOL)
    assert got["captions"].dtype == torch.long
    assert agreement(got["captions"].numpy(), ref["captions"]) >= AGREE


def test_decode_paths_agree_in_bf16(serve_pair):
    """The port's plain-op and fused decodes (dense and int8 K/V) of one bf16
    model: the greedy tokens agree on at least 90%, as the card's check
    holds the kernel to the plain-op decode."""
    jcfg, _, _, tmodel = serve_pair
    video, mask, durations = (torch.from_numpy(a) for a in serve_inputs(jcfg, seed=1))
    caps = {}
    for impl, kv in (("xla", "dense"), ("fused", "dense"), ("fused", "int8")):
        tmodel.decode_impl, tmodel.decode_kv, tmodel.decode_fused_grid = impl, kv, "video"
        caps[impl, kv] = tmodel.forward_serve(video, mask, durations)["captions"].numpy()
    for key in (("fused", "dense"), ("fused", "int8")):
        assert agreement(caps[key], caps["xla", "dense"]) >= AGREE, key


def test_train_step_bf16_gives_f32_grads_and_jax_loss(pair):
    """One bf16 forward and backward with f32 masters, dropout off: a finite
    loss within LOSS_REL of JAX's (its loss function jitted, as its train
    step runs it), f32 gradients on every f32 master, and the masters left
    f32."""
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
    from test_torch_common import BOS, EOS, no_dropout

    _, _, params, _, batch, tb = pair
    jcfg = no_dropout(bf16_cfg())
    jmodel = jax_build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    weight_dict = jax_weights(jcfg)
    crit = JaxCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=weight_dict,
                        losses=list(jcfg.dvc.losses), pad_idx=PAD,
                        smoothing=jcfg.dvc.smoothing)

    def loss_fn(p, b):
        out, idx, idx_aux, mm = jmodel.forward_train(p, b, jax.random.PRNGKey(0))
        losses = crit(out, b, idx, idx_aux, mm)
        return sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)

    ref = float(jax.jit(loss_fn)(params, batch))
    tmodel = build_port_model(jcfg, params)
    tcfg = torch_cfg_like(jcfg)
    criterion, tweights = build_criterion(tcfg, PAD)
    create_train_state(tcfg, tmodel, 10)
    tmodel.train()
    total, losses = forward_loss(tmodel, criterion, tweights, tb)
    total.backward()
    assert total.dtype == torch.float32 and all(v.dtype == torch.float32
                                                for v in losses.values())
    assert np.isfinite(float(total))
    assert abs(float(total) - ref) <= LOSS_REL * abs(ref), (float(total), ref)
    grads = [p.grad for p in tmodel.parameters() if p.grad is not None]
    assert len(grads) > 0.9 * len(list(tmodel.parameters()))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert all(g.dtype == torch.float32 for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("val_mode", ["one_by_one", "teacher_forcing", "beam", "serve"])
def test_eval_step_bf16_in_every_val_mode(pair, val_mode):
    """``make_eval_step`` on the bf16 model: f32 losses, all finite, and
    captions of the mode's shape."""
    jcfg, _, _, tmodel, _, tb = pair
    criterion, weight_dict = build_criterion(torch_cfg_like(jcfg), PAD)
    captions, denorm, losses = make_eval_step(tmodel, criterion, weight_dict, val_mode,
                                              beam_size=2)(tb)
    Lc = jcfg.dataset.activity_net.max_caption_len_all
    N = tb["gt_mask"].numel()
    assert captions.shape == (N, Lc - 1 if val_mode == "teacher_forcing" else Lc + 1)
    assert denorm.dtype == torch.float32
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in losses.values())


def test_serving_casts_the_weights_once(pair):
    """Without gradients the bf16 copies of the masters are kept and reused
    while the masters do not change; an in-place update of a master makes
    a new copy of it."""
    jcfg, *_ = pair
    tmodel = copy.deepcopy(pair[3])
    video, mask, durations = (torch.from_numpy(a) for a in serve_inputs(jcfg))
    tmodel.forward_serve(video, mask, durations)
    copies = dict(tmodel._compute_dtype_copies)
    assert len(copies) == sum(1 for p in tmodel.parameters() if p.is_floating_point())
    tmodel.forward_serve(video, mask, durations)
    assert all(tmodel._compute_dtype_copies[k][2] is v[2] for k, v in copies.items())
    with torch.no_grad():
        tmodel.caption.head.bias.add_(1.0)
    tmodel.forward_serve(video, mask, durations)
    changed = [k for k, v in copies.items() if tmodel._compute_dtype_copies[k][2] is not v[2]]
    assert len(changed) == 1


def test_the_f32_policy_is_the_identity():
    lin = Linear(8, 5)
    x = torch.randn(3, 8)
    assert torch.equal(lin(x), torch.nn.functional.linear(x, lin.weight, lin.bias))
    z = torch.randn(1000) * 4
    assert torch.equal(gelu(z), F.gelu(z))
    params = [p for p in lin.parameters()]
    with params_in(lin, torch.float32):
        assert [lin.weight, lin.bias] == params and lin.weight is params[0]
    with params_in(lin, torch.bfloat16):
        assert lin.weight.dtype == torch.bfloat16 and lin(x.bfloat16()).dtype == torch.bfloat16
    assert lin.weight is params[0] and lin.weight.dtype == torch.float32
    sd = cast_floating({"w": lin.weight.detach(), "n": torch.tensor(3),
                        "s": [torch.ones(2)]}, torch.bfloat16)
    assert sd["w"].dtype == sd["s"][0].dtype == torch.bfloat16 and sd["n"].dtype == torch.long


def test_bf16_rounds_where_flax_does():
    """A bf16 dense layer rounds after the product and after the bias sum
    (flax's Dense: dot, then + bias), not once at the end of a fused addmm;
    bf16 GELU rounds each step as jax.nn.gelu does."""
    import flax.linen as fnn
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((16, 64), (64, 32), (32,)))
    lin = Linear(64, 32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    lin = lin.to(torch.bfloat16)
    with torch.no_grad():
        got = lin(torch.from_numpy(x).bfloat16()).float().numpy()
    bf = jnp.bfloat16
    ref = fnn.Dense(32).apply({"params": {"kernel": jnp.asarray(w).astype(bf),
                                          "bias": jnp.asarray(b).astype(bf)}},
                              jnp.asarray(x).astype(bf))
    np.testing.assert_array_equal(got, np.asarray(ref.astype(jnp.float32)))
    z = rng.normal(size=4096).astype(np.float32) * 3
    np.testing.assert_array_equal(
        gelu(torch.from_numpy(z).bfloat16()).float().numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(z).astype(bf), approximate=False)
                   .astype(jnp.float32)))


@pytest.mark.parametrize("field", ["compute_dtype", "master_dtype"])
def test_unknown_dtypes_raise(field):
    assert resolve_dtype("bfloat16") == torch.bfloat16
    cfg = Config()
    setattr(cfg, field, "float16")
    with pytest.raises(ValueError, match="float16"):
        model = UnimodalDVC(cfg, VOCAB_SIZE)
        create_train_state(cfg, model, 1)
