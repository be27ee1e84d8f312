"""Training of the port against the JAX package's ``make_train_step``.

Both sides start from the same flax params (carried into the port by
``utils.weights``, compared back under flax names by
``export_flax_params``) and take two steps on the same synthetic batch (numpy
seed 0, ``data.anet.synthetic_batches``) at ``_small_cfg`` dims, f32 on the
CPU, every dropout rate 0, with and without the differentiable context
mask. Held to:

- matcher indices, final and auxiliary: equal;
- every loss term of both steps: rel 1e-5 (atol 1e-6);
- every gradient leaf at the shared start: atol 2e-4 x max |g_leaf| + 1e-8.
  f32 sums in another order set this floor: the port's own gradients move
  by up to 1.6e-5 x max |g_leaf| when only the CPU thread count changes, and
  JAX's and the port's differ by up to 9.7e-5 x max |g_leaf| (flax's
  LayerNorm takes E[x^2] - E[x]^2, torch's the two-pass variance; the loss
  sums terms of gradient norm ~1600 before the clip). The key biases of
  attention have an exact gradient of 0 (softmax ignores a shift shared by
  all keys), so both sides' values there are rounding noise: each is held
  under 1e-5 x max |g| of the same projection's kernel;
- params after the first step: within 1e-6 + 2 lr x min(1, dg / |g|), and
  within 1.01 lr, with dg the gradient tolerance above (2e-4 x max |g_leaf|,
  or twice the noise bound of a key bias). Adam's first update is
  lr x g / (|g| + eps), which moves by at most 2 lr |dg| / |g| when g moves
  by dg, so where |g| is small against the leaf the update is as uncertain
  as the gradient's sign;
- params after the second step: within 1.01 lr per step.

The port's ``make_train_multistep`` takes the same two steps as one
dispatch of K = 2 over the batch stacked twice, from the same params: its
matchings of each step equal JAX's, its loss terms of each step and its
params after the two steps held as above.

Then, on the port alone: with dropout on, one seed gives one loss and
another seed another; a step after torch.save -> torch.load equals the
uninterrupted step; ``train_one_epoch`` runs over the synthetic batches."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (
    PAD, VOCAB_SIZE, build_jax_model, build_port_model, flatten_params, jax_small_cfg,
    no_dropout, torch_cfg_like,
)

from multimodal_feature_learning_tpu.engine.state import create_train_state as jax_state
from multimodal_feature_learning_tpu.engine.state import make_optimizer as jax_optimizer
from multimodal_feature_learning_tpu.engine.train import make_train_step as jax_train_step
from multimodal_feature_learning_tpu.models.criterion import SetCriterion as JaxCriterion
from multimodal_feature_learning_tpu.models.criterion import build_weight_dict as jax_weights
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.engine.state import (
    create_train_state, load_checkpoint, save_checkpoint,
)
from multimodal_feature_learning_tpu_torch.engine.train import (
    batch_to_device, forward_loss, make_train_multistep, make_train_step, stack_batches,
    train_one_epoch,
)
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

STEPS = 2
STEPS_PER_EPOCH = 10


def jax_run(jcfg, params, batch):
    """Indices of the first forward, gradients and metrics of every step,
    and the params after every step, through the JAX package's own step."""
    jmodel = jcfg._model
    weight_dict = jax_weights(jcfg)
    crit = JaxCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=weight_dict,
                        losses=list(jcfg.dvc.losses), pad_idx=PAD,
                        smoothing=jcfg.dvc.smoothing)
    rng = jax.random.PRNGKey(0)

    def loss_fn(p, batch):
        out, indices, indices_aux, memory_mask = jmodel.forward_train(p, batch, rng)
        losses = crit(out, batch, indices, indices_aux, memory_mask)
        total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        return total, (indices, indices_aux)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    tx = jax_optimizer(jcfg, STEPS_PER_EPOCH)
    step = jax_train_step(jmodel, crit, weight_dict, tx)
    state = jax_state(jax.tree_util.tree_map(np.array, params), tx)
    run = {"grads": [], "metrics": [], "params": []}
    for _ in range(STEPS):
        grads, (indices, indices_aux) = grad_fn(state.params, batch)
        if not run["grads"]:
            run["indices"] = (np.asarray(indices), np.asarray(indices_aux))
        run.setdefault("step_indices", []).append((np.asarray(indices), np.asarray(indices_aux)))
        run["grads"].append(flatten_params(grads))
        state, metrics, _ = step(state, batch, rng)
        run["metrics"].append({k: float(v) for k, v in jax.device_get(metrics).items()})
        run["params"].append(flatten_params(state.params))
    return run


def port_run(jcfg, params, batch):
    tcfg = torch_cfg_like(jcfg)
    model = build_port_model(jcfg, params)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    state = create_train_state(tcfg, model, STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=0)
    tb = batch_to_device(batch, "cpu")
    run = {"grads": [], "metrics": [], "params": []}
    for _ in range(STEPS):
        model.zero_grad(set_to_none=True)
        model.train()
        total, _ = forward_loss(model, criterion, weight_dict, tb)
        total.backward()
        run["grads"].append(export_flax_params(
            {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}))
        if "indices" not in run:
            out = model.forward_train(tb)
            run["indices"] = (out[1].numpy(), out[2].numpy())
        run["metrics"].append({k: float(v) for k, v in step(state, tb).items()})
        run["params"].append(export_flax_params(model))
    run["lr"] = tcfg.lr
    run["multistep"] = port_multistep_run(jcfg, params, batch)
    return run


def port_multistep_run(jcfg, params, batch):
    """The STEPS steps as one ``make_train_multistep`` dispatch over the
    batch stacked STEPS times: each step's matchings and metrics, and the
    params after the last."""
    tcfg = torch_cfg_like(jcfg)
    model = build_port_model(jcfg, params)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    state = create_train_state(tcfg, model, STEPS_PER_EPOCH)
    indices = []
    forward_train = model.forward_train

    def recording(tb):
        out = forward_train(tb)
        indices.append((out[1].numpy().copy(), out[2].numpy().copy()))
        return out

    model.forward_train = recording
    stacked = batch_to_device(stack_batches([batch] * STEPS), "cpu")
    metrics = make_train_multistep(criterion, weight_dict, seed=0)(state, stacked)
    return {"indices": indices,
            "metrics": [{k: float(v[i]) for k, v in metrics.items() if k != "lr"}
                        for i in range(STEPS)],
            "params": export_flax_params(model)}


@pytest.fixture(scope="module", params=[True, False], ids=["ctxmask", "cropmask"])
def runs(request):
    jcfg = no_dropout(jax_small_cfg(use_differentiable_mask=request.param))
    jmodel, params = build_jax_model(jcfg)
    jcfg._model = jmodel
    batch = next(synthetic_batches(torch_cfg_like(jcfg), 4, VOCAB_SIZE, seed=0))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    return jax_run(jcfg, params, batch), port_run(jcfg, params, batch)


def test_matcher_indices_equal_jax(runs):
    ref, got = runs
    for r, g in zip(ref["indices"], got["indices"]):
        np.testing.assert_array_equal(g, r)


def test_loss_terms_match_jax_for_two_steps(runs):
    ref, got = runs
    for step, (r, g) in enumerate(zip(ref["metrics"], got["metrics"])):
        terms = [k for k in r if k.startswith("loss")]
        assert set(terms) <= set(g), sorted(set(terms) - set(g))
        assert len(terms) > 10
        for k in terms:
            assert abs(g[k] - r[k]) <= max(1e-5 * abs(r[k]), 1e-6), (step, k, g[k], r[k])


GRAD_REL = 2e-4
SHIFT_FREE = "k_linear||bias"  # exact gradient 0


def test_gradients_match_jax(runs):
    ref, got = runs
    r, g = ref["grads"][0], got["grads"][0]
    assert set(r) == set(g)
    nonzero = 0
    for k in r:
        if k.endswith(SHIFT_FREE):
            kernel = float(np.abs(r[k.replace("bias", "kernel")]).max())
            assert float(np.abs(r[k]).max()) <= 1e-5 * kernel, k
            assert float(np.abs(g[k]).max()) <= 1e-5 * kernel, k
            continue
        scale = float(np.abs(r[k]).max())
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=GRAD_REL * scale + 1e-8,
                                   err_msg=k)
        nonzero += scale > 0
    assert nonzero > 0.9 * len(r)


def test_updated_params_match_jax(runs):
    ref, got = runs
    lr = got["lr"]
    r, g, grads = ref["params"][0], got["params"][0], ref["grads"][0]
    assert set(r) == set(g)
    for k in r:
        dg = GRAD_REL * float(np.abs(grads[k]).max())
        if k.endswith(SHIFT_FREE):  # both gradients are noise under this
            dg = 2e-5 * float(np.abs(grads[k.replace("bias", "kernel")]).max())
        ratio = np.minimum(1.0, dg / np.maximum(np.abs(grads[k]), 1e-30))
        bound = np.minimum(1e-6 + 2 * lr * ratio, 1.01 * lr)
        assert (np.abs(g[k] - r[k]) <= bound).all(), k
    r, g = ref["params"][1], got["params"][1]
    for k in r:
        assert float(np.abs(g[k] - r[k]).max()) <= 2 * 1.01 * lr, k


def test_multistep_matches_jax_step_by_step(runs):
    ref, got = runs
    multi = got["multistep"]
    assert len(multi["indices"]) == len(ref["step_indices"]) == STEPS
    for (r, ra), (g, ga) in zip(ref["step_indices"], multi["indices"]):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(ga, ra)
    for step, (r, g) in enumerate(zip(ref["metrics"], multi["metrics"])):
        terms = [k for k in r if k.startswith("loss")]
        assert len(terms) > 10 and set(terms) <= set(g)
        for k in terms:
            assert abs(g[k] - r[k]) <= max(1e-5 * abs(r[k]), 1e-6), (step, k, g[k], r[k])
    r, g = ref["params"][-1], multi["params"]
    assert set(r) == set(g)
    for k in r:
        assert float(np.abs(g[k] - r[k]).max()) <= STEPS * 1.01 * got["lr"], k


# -- the port alone ----------------------------------------------------------


@pytest.fixture(scope="module")
def port_setup():
    """A small port model with its config's dropout rates (0.1), its
    criterion and one synthetic batch."""
    jcfg = jax_small_cfg(use_differentiable_mask=True)
    _, params = build_jax_model(jcfg)
    tcfg = torch_cfg_like(jcfg)
    model = build_port_model(jcfg, params)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    batch = batch_to_device(next(synthetic_batches(tcfg, 4, VOCAB_SIZE, seed=1)), "cpu")
    return tcfg, model, criterion, weight_dict, batch


def one_step(tcfg, model, criterion, weight_dict, batch, seed):
    state = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    return make_train_step(criterion, weight_dict, seed=seed)(state, batch), state


def test_dropout_follows_the_seed(port_setup):
    tcfg, model, criterion, weight_dict, batch = port_setup
    assert tcfg.dvc.detr.transformer_dropout_prob == 0.1
    a, _ = one_step(tcfg, model, criterion, weight_dict, batch, seed=0)
    b, _ = one_step(tcfg, model, criterion, weight_dict, batch, seed=0)
    c, _ = one_step(tcfg, model, criterion, weight_dict, batch, seed=1)
    assert float(a["loss"]) == float(b["loss"])
    assert float(a["loss"]) != float(c["loss"])
    model.eval()
    with torch.no_grad():
        clean, _ = forward_loss(model, criterion, weight_dict, batch)
    assert float(clean) != float(a["loss"])


def test_a_step_after_save_and_load_equals_the_uninterrupted_step(port_setup, tmp_path):
    tcfg, model, criterion, weight_dict, batch = port_setup
    step = make_train_step(criterion, weight_dict, seed=3)
    straight = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    step(straight, batch)
    m2 = step(straight, batch)

    first = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    step(first, batch)
    path = save_checkpoint(str(tmp_path / "ckpt.pt"), first, epoch=0)
    resumed = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    assert load_checkpoint(path, resumed) == 0 and resumed.step == 1
    m2r = step(resumed, batch)
    assert float(m2["loss"]) == float(m2r["loss"])
    for (n, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n


def test_step_logger_gets_the_filtered_log(port_setup):
    """The step logger gets the metrics the epoch averages, without the
    auxiliary ``_0`` .. ``_enc_`` terms the step computes (JAX
    ``engine/train.py`` hands its logger the same filtered ``log``)."""
    tcfg, model, criterion, weight_dict, _ = port_setup
    state = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=0)
    computed, logged = [], []

    def recording_step(state, batch, **kw):
        metrics = step(state, batch, **kw)
        computed.append(set(metrics))
        return metrics

    batches = synthetic_batches(tcfg, 2, VOCAB_SIZE, seed=2, num_batches=2)
    _, stats = train_one_epoch(recording_step, state, batches, epoch=0, print_freq=0,
                               step_logger=lambda log, step: logged.append((step, log)))
    aux = {k for k in computed[0] if any(f"_{i}" in k for i in range(10)) or "_enc_" in k}
    assert {"loss_caption_0", "loss_bbox_enc_0"} <= aux
    assert [s for s, _ in logged] == [1, 2]
    for _, log in logged:
        assert set(log) == computed[0] - aux == set(stats)
        assert all(isinstance(v, float) for v in log.values())


def test_bf16_transfer_rounds_only_the_float_arrays(port_setup):
    """``transfer_dtype`` bfloat16: the float arrays arrive as f32 holding
    their bf16 roundings, the others unchanged."""
    tcfg = port_setup[0]
    batch = next(synthetic_batches(tcfg, 2, VOCAB_SIZE, seed=3))
    plain = batch_to_device(batch, "cpu")
    sent = batch_to_device(batch, "cpu", torch.bfloat16)
    assert set(sent) == set(plain)
    for k, v in plain.items():
        assert sent[k].dtype == v.dtype, k
        want = v.to(torch.bfloat16).float() if v.is_floating_point() else v
        assert torch.equal(sent[k], want), k
    assert not torch.equal(sent["video_tensor"], plain["video_tensor"])


def test_train_one_epoch_over_synthetic_batches(port_setup):
    tcfg, model, criterion, weight_dict, _ = port_setup
    state = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=0)
    batches = synthetic_batches(tcfg, 2, VOCAB_SIZE, seed=2, num_batches=2)
    state, stats = train_one_epoch(step, state, batches, epoch=0, print_freq=0)
    assert state.step == 2
    assert np.isfinite(stats["loss"]) and stats["lr"] == tcfg.lr
    assert "loss_caption" in stats and not any(k.endswith("_0") for k in stats)
