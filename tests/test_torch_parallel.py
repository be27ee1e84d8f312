"""The port's ``parallel/`` over ``torch.distributed`` (gloo, CPU processes)
against JAX's sharded step and against the port's own one-process runs.

The ranks run ``tests/torch_parallel_worker.py``, each layout spawned once
for the module: 2 data x 2 model ranks, then 2 data ranks. Dims are
``__graft_entry__._small_cfg``'s, the weights are JAX's init perturbed from
a numpy seed and carried with ``load_flax_params``, the batches come from
``synthetic_batches`` (numpy seed) at 8 rows, 4 a data rank. Held to:

- the port's step at DP 2 x model 2 with the decoder's value tokens split
  over "model" (dropout off) against JAX's step on its 4 x 2 mesh with
  ``shard_tokens_axis="model"`` (``tests/test_sharding.py``): the loss
  rel 1e-5; every parameter after the step within 2e-4 rel, 2e-5 abs
  (JAX's own bounds) plus two Adam steps where its gradient is tiny
  against its leaf (the bound of ``tests/test_torch_train.py``: Adam's
  first update is lr * g / |g|, so a gradient at rounding noise flips its
  sign);
- the token split's gradients (summed over the ranks) against the
  unsplit one-process gradients at 2e-4 x max |g| of each leaf;
- DP 2 with dropout on against one process over the same global batch:
  matchings equal, loss and terms rel 1e-5, parameters after 2 steps at 2e-4
  rel, 2e-5 abs; the same 2 steps as one multi-step dispatch too;
- DP 2 x TP 2 (with the token split): the teacher-forced eval forward and 2
  train steps with dropout on against one process, at the same bounds;
- resharding: the checkpoint written by rank 0 under DP 2 x TP 2 after the
  first step, unsharded, resumed under DP 2 and in one process: the second
  step's loss and parameters equal the uninterrupted run's;
- the loader's rank shards are disjoint, cover the epoch and give every rank
  as many batches; the evaluation loop's gathered submission equals one
  process's at twice the batch, key for key; the training CLI under
  ``torch.distributed.run`` with 2 processes writes one log and one
  checkpoint, which one process resumes."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import (
    PAD, array_batch, assert_grads_match, build_jax_model, flatten_params, jax_small_cfg, no_dropout,
    torch_cfg_like,
)

from multimodal_feature_learning_tpu_torch.data.anet import collate_fixed
from multimodal_feature_learning_tpu_torch.data.loader import ARRAY_KEYS, DataLoader
from multimodal_feature_learning_tpu_torch.engine.state import (
    create_train_state, load_checkpoint,
)
from multimodal_feature_learning_tpu_torch.engine.train import (
    batch_to_device, forward_loss, make_train_step,
)
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
from multimodal_feature_learning_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch, split_sizes,
)
from multimodal_feature_learning_tpu_torch.parallel.tp import tp_param_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
STEPS_PER_EPOCH, B = 10, 8
LR = 1e-4
TINY = [
    "dvc.d_model=64", "dvc.num_queries=6",
    "dvc.detr.feature_dim=64", "dvc.detr.d_model=64", "dvc.detr.num_heads=2",
    "dvc.detr.enc_layers=2", "dvc.detr.dec_layers=2",
    "dvc.detr.transformer_ff_dim=128", "dvc.detr.video_rescale_len=24",
    "dvc.detr.num_feature_levels=3",
    "dvc.caption.d_model=64", "dvc.caption.depth=2", "dvc.caption.num_heads=2",
    "dataset.activity_net.video_rescale_len=24",
    "dataset.activity_net.max_caption_len_all=8",
    "dataset.activity_net.max_gt_target_segments=4",
]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def spawn(layout: str, world: int, workdir: str):
    port = free_port()
    return [subprocess.Popen([sys.executable, WORKER, layout, workdir],
                             env=rank_env(r, world, port), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs, timeout=240):
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def one_process_run(tcfg, weights, batches, state=None, steps=(0, 1)):
    """Loss terms, final matchings and parameters of the one-process steps
    of ``steps`` over the global ``batches``."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    if state is None:
        model = build_model(tcfg, 40, PAD, 2, 3, device="cpu")
        load_flax_params(model, weights)
        state = create_train_state(tcfg, model, STEPS_PER_EPOCH)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    seen = []
    forward_train = state.model.forward_train
    state.model.forward_train = lambda b: (lambda o: (seen.append(o[1].clone()), o)[1])(
        forward_train(b))
    step = make_train_step(criterion, weight_dict, seed=0)
    metrics = [step(state, batch_to_device(batches[i], "cpu")) for i in steps]
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    return metrics, seen, params, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the inputs, spawns the 4-rank and the 2-rank layouts (the
    latter waits for the former's checkpoint to resume it) and, while they
    run, computes the one-process references and JAX's 4 x 2 step."""
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
    from multimodal_feature_learning_tpu_torch.main import make_synthetic_world

    workdir = str(tmp_path_factory.mktemp("parallel"))
    jcfg = jax_small_cfg()
    jmodel, params = build_jax_model(jcfg)
    weights = flatten_params(params)
    np.savez(os.path.join(workdir, "weights.npz"), **weights)
    tcfg_drop = torch_cfg_like(jcfg)
    jcfg_nodrop = no_dropout(jax_small_cfg())
    tcfg_nodrop = torch_cfg_like(jcfg_nodrop)
    batches = [array_batch(tcfg_drop, B, seed=s) for s in (0, 1)]
    np.savez(os.path.join(workdir, "batches.npz"),
             **{f"b{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    wcfg = torch_cfg_like(jcfg)
    wcfg.save_submission = False
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        make_synthetic_world(wcfg, os.path.join(workdir, "world"))
        build_dataset("train", wcfg)  # writes the world's vocab before the ranks read it
    finally:
        os.chdir(cwd)
    with open(os.path.join(workdir, "cfgs.pkl"), "wb") as f:
        pickle.dump({"drop": tcfg_drop, "nodrop": tcfg_nodrop, "world": wcfg,
                     "variants": variant_cfgs()}, f)

    procs = spawn("dp2x2", 4, workdir) + spawn("dp2", 2, workdir)
    ref = {"workdir": workdir, "weights": weights, "batches": batches}
    try:
        ref["jax"] = jax_dp_sp_step(jcfg_nodrop, params, batches[0])
        ref["drop"] = one_process_run(tcfg_drop, weights, batches)
        ref["nodrop"] = one_process_run(tcfg_nodrop, weights, batches, steps=(0,))
        ref["sp_grads"] = one_process_grads(tcfg_nodrop, weights, batches[0])
        ref["eval"] = one_process_eval(tcfg_drop, weights, batches[0])
        ref["world_eval"] = one_process_world_eval(wcfg)
        ref["dp2x2"] = wait(procs[:4])
        ref["dp2"] = wait(procs[4:])
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for layout, n in (("dp2x2", 4), ("dp2", 2)):
        ref[layout] = [torch.load(os.path.join(workdir, f"{layout}_rank{r}.pt"),
                                  weights_only=False) for r in range(n)]
    return ref


def variant_cfgs() -> dict:
    """The port's configs of the other families (``family_cfg``) and of the
    bf16 fold (compute and master dtype bfloat16), dropout on."""
    from test_torch_common import family_cfg

    cfgs = {name: torch_cfg_like(family_cfg(name)) for name in ("dense", "mm")}
    cfgs["bf16"] = torch_cfg_like(jax_small_cfg())
    cfgs["bf16"].compute_dtype = cfgs["bf16"].master_dtype = "bfloat16"
    return cfgs


def jax_dp_sp_step(jcfg, params, batch):
    """JAX's step on its 4 data x 2 model mesh, the encoder memory
    constrained over "model" (``tests/test_sharding.py``): loss, params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_feature_learning_tpu.engine.state import (
        create_train_state as jax_state, make_optimizer as jax_optimizer,
    )
    from multimodal_feature_learning_tpu.engine.train import make_train_step as jax_step
    from multimodal_feature_learning_tpu.models.criterion import (
        SetCriterion, build_weight_dict,
    )
    from multimodal_feature_learning_tpu.parallel.mesh import (
        make_mesh as jax_mesh, replicate_params,
    )

    jmodel, _ = build_jax_model(jcfg)
    object.__setattr__(jmodel, "proposal_net",
                       jmodel.proposal_net.clone(shard_tokens_axis="model"))
    weight_dict = build_weight_dict(jcfg)
    crit = SetCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=weight_dict,
                        losses=list(jcfg.dvc.losses), pad_idx=PAD,
                        smoothing=jcfg.dvc.smoothing)
    tx = jax_optimizer(jcfg, STEPS_PER_EPOCH)
    mesh = jax_mesh(num_data=4, num_model=2)
    with jax.set_mesh(mesh):
        state = jax_state(replicate_params(jax.tree.map(jnp.asarray, params), mesh), tx)
        sharded = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                   for k, v in batch.items()}
        state, metrics, _ = jax_step(jmodel, crit, weight_dict, tx)(
            state, sharded, jax.random.PRNGKey(0))
        return float(metrics["loss"]), flatten_params(jax.device_get(state.params))


def one_process_grads(tcfg, weights, batch):
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model = build_model(tcfg, 40, PAD, 2, 3, device="cpu")
    load_flax_params(model, weights)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    model.train()
    total, _ = forward_loss(model, criterion, weight_dict, batch_to_device(batch, "cpu"))
    total.backward()
    return {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def one_process_eval(tcfg, weights, batch):
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model = build_model(tcfg, 40, PAD, 2, 3, device="cpu")
    load_flax_params(model, weights)
    model.eval()
    with torch.no_grad():
        out, _, indices, _, _ = model.forward_eval(batch_to_device(batch, "cpu"),
                                                   "teacher_forcing")
    res = {k: out[k] for k in ("pred_segments", "pred_count", "pred_captions")}
    res["indices"] = indices
    return res


def one_process_world_eval(wcfg):
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
    from multimodal_feature_learning_tpu_torch.engine.evaluate import evaluate, make_eval_step
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion

    val_ds, vocab = build_dataset("val", wcfg)
    loader = DataLoader(val_ds, 8, vocab.pad_idx, video_rescale_len=24, max_gt=4,
                        max_caption_len=8, shuffle=False)
    model, criterion, weight_dict = build_model_and_criterion(wcfg, vocab, device="cpu", seed=0)
    eval_step = make_eval_step(model, criterion, weight_dict, "one_by_one")
    stats, submission, _ = evaluate(eval_step, loader, vocab, wcfg, device="cpu")
    return {"stats": stats, "submission": submission}


def rows(parts, key, model_rank=0):
    """A per-rank result's rows over the data ranks, in rank order (the
    ranks of model index ``model_rank``)."""
    return torch.cat([p[key] if not isinstance(key, tuple) else p[key[0]][key[1]]
                      for p in parts if p["mesh"][1] == model_rank])


def assert_terms(ref: dict, got: dict, rel=1e-5, atol=1e-6, grad_norm_rel=1e-4):
    """Every loss term within ``rel``; the gradient's global norm (a sum of
    squares over every leaf, taken in another order) within
    ``grad_norm_rel``."""
    ref = {k: float(v) for k, v in ref.items() if k != "lr" and isinstance(v, torch.Tensor)}
    got = {k: float(v) for k, v in got.items() if k != "lr" and isinstance(v, torch.Tensor)}
    assert set(ref) == set(got) and len(ref) >= 10
    for k in ref:
        tol = max((grad_norm_rel if k == "grad_norm" else rel) * abs(ref[k]), atol)
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def assert_params(ref: dict, got: dict):
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_dp_sp_step_matches_jax_mesh_step(runs):
    """DP 2 x model 2 with the token split against JAX's 4 x 2 DP x SP step."""
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    jax_loss, jax_params = runs["jax"]
    parts = runs["dp2x2"]
    for p in parts:
        assert abs(float(p["sp_metrics"]["loss"]) - jax_loss) <= 1e-5 * abs(jax_loss)
    got = export_flax_params(parts[0]["sp_params"])
    grads = export_flax_params(parts[0]["sp_grads"])
    assert set(got) == set(jax_params)
    loose = 0
    for k, ref in jax_params.items():
        tol = 2e-5 + 2e-4 * np.abs(ref)
        gap = np.abs(got[k] - ref)
        # Adam's first update, lr * g / (|g| + eps): where g is rounding noise
        # against its leaf it may flip sign on either side (test_torch_train.py)
        noise = np.abs(grads[k]) <= 2e-4 * np.abs(grads[k]).max() + 1e-12
        assert np.all((gap <= tol) | (noise & (gap <= 2.02 * LR))), k
        loose += int(np.sum(noise & (gap > tol)))
    assert loose <= 0.01 * sum(v.size for v in jax_params.values())


def test_token_split_gradients_equal_unsplit(runs):
    """Every leaf within 2e-4 x its max |g|; the attention key biases, whose
    exact gradient is 0, under 1e-5 x their kernel's on both sides."""
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    ref = export_flax_params(runs["sp_grads"])
    for p in runs["dp2x2"]:
        assert assert_grads_match(ref, export_flax_params(p["sp_grads"])) >= 50


def test_token_split_step_matches_one_process(runs):
    metrics, _, params, _ = runs["nodrop"]
    for p in runs["dp2x2"]:
        assert_terms(metrics[0], p["sp_metrics"])
        assert_params(params, p["sp_params"])


def test_dp_step_with_dropout_matches_one_process(runs):
    metrics, seen, params, _ = runs["drop"]
    # dropout is on: the masks move the loss
    assert abs(float(metrics[0]["loss"]) - float(runs["nodrop"][0][0]["loss"])) > 1e-3
    parts = runs["dp2"]
    for i in range(2):
        assert torch.equal(torch.cat([p["dp_indices"][i] for p in parts]), seen[i])
        for p in parts:
            assert_terms(metrics[i], p["dp_metrics"][i])
    for p in parts:
        assert_params(params, p["dp_params"])


def test_dp_multistep_matches_single_steps(runs):
    metrics, _, params, _ = runs["drop"]
    for p in runs["dp2"]:
        for i in range(2):
            assert_terms(metrics[i], {k: v[i] for k, v in p["multi_metrics"].items()
                                      if k != "lr"})
        assert_params(params, p["multi_params"])


@pytest.mark.parametrize("name,rel", [("dense", 1e-5), ("mm", 1e-5), ("bf16", 4e-3)])
def test_dp_step_matches_one_process_for_family(runs, name, rel):
    """DP 2 of the dense and the multimodal families, and of the bf16 fold,
    one step with dropout: matchings equal, terms within 1e-5 (bf16: 2^-8,
    one rounding of a bf16 sum; its grad norm is taken over bf16
    gradients summed in another order)."""
    from torch_parallel_worker import variant_step

    ref = variant_step(variant_cfgs()[name])
    parts = [p[f"variant_{name}"] for p in runs["dp2"]]
    assert torch.equal(torch.cat([p["indices"] for p in parts]), ref["indices"])
    for p in parts:
        assert_terms(ref["metrics"], p["metrics"], rel=rel, grad_norm_rel=max(rel, 1e-4))


def test_tp_eval_forward_matches_one_process(runs):
    ref = runs["eval"]
    parts = runs["dp2x2"]
    assert parts[0]["n_col"] >= 10 and parts[0]["n_row"] >= 5
    # every feed-forward block is a column-row pair: its hidden features stay split
    assert parts[0]["ffn_gather"] and not any(parts[0]["ffn_gather"].values())
    for m in (0, 1):
        assert torch.equal(rows(parts, ("tp_eval", "indices"), m), ref["indices"])
        for key in ("pred_segments", "pred_count", "pred_captions"):
            np.testing.assert_allclose(rows(parts, ("tp_eval", key), m).numpy(),
                                       ref[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)


def test_tp_train_steps_match_one_process(runs):
    metrics, seen, params, _ = runs["drop"]
    parts = runs["dp2x2"]
    for i in range(2):
        for m in (0, 1):
            got = torch.cat([p["tp_indices"][i] for p in parts if p["mesh"][1] == m])
            assert torch.equal(got, seen[i])
        for p in parts:
            assert_terms(metrics[i], p["tp_metrics"][i])
    for p in parts:
        assert_params(params, p["tp_params"])
    # the ranks hold slices: the caption head's 40 words over 2
    shapes = parts[1]["tp_local_shapes"]
    assert shapes["caption.head.weight"][0] == 20
    assert shapes["caption.decoder.0.mlp.fully_connected_2.weight"][1] == 128


def test_checkpoint_written_once_unsharded(runs):
    parts = runs["dp2x2"]
    path = os.path.join(runs["workdir"], "ckpt_tp")
    assert parts[0]["ckpt"] == path and all(p["ckpt"] is None for p in parts[1:])
    ckpt = torch.load(path, weights_only=True)
    full = runs["drop"][2]
    assert {k: tuple(v.shape) for k, v in ckpt["model"].items()} == \
        {k: tuple(v.shape) for k, v in full.items()}
    named = [n for n, p in runs["drop"][3].model.named_parameters() if p.requires_grad]
    for idx, st in ckpt["optimizer"]["state"].items():
        assert tuple(st["exp_avg"].shape) == tuple(full[named[idx]].shape), named[idx]
    assert ckpt["step"] == 1 and ckpt["epoch"] == 0


def test_reshard_restore_dp_and_one_process(runs):
    """Saved under DP 2 x TP 2 after step 1; step 2 resumed under DP 2 and in
    one process equals the uninterrupted DP x TP step 2."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model

    parts = runs["dp2x2"]
    ref_metrics, ref_params = parts[0]["tp_metrics"][1], parts[0]["tp_params"]
    for p in runs["dp2"]:
        assert p["restored_epoch"] == 0
        assert_terms(ref_metrics, p["restored_metrics"])
        assert_params(ref_params, p["restored_params"])
    with open(os.path.join(runs["workdir"], "cfgs.pkl"), "rb") as f:
        tcfg = pickle.load(f)["drop"]
    model = build_model(tcfg, 40, PAD, 2, 3, device="cpu")
    state = create_train_state(tcfg, model, STEPS_PER_EPOCH)
    assert load_checkpoint(os.path.join(runs["workdir"], "ckpt_tp"), state) == 0
    metrics, _, params, _ = one_process_run(tcfg, None, runs["batches"], state=state,
                                            steps=(1,))
    assert_terms(ref_metrics, metrics[0])
    assert_params(ref_params, params)


def test_gathered_submission_equals_one_process(runs):
    ref = runs["world_eval"]
    for p in runs["dp2"]:
        got = p["eval"]
        assert got["batches"] == 4
        assert set(got["submission"]["results"]) == set(ref["submission"]["results"])
        for key, events in ref["submission"]["results"].items():
            other = got["submission"]["results"][key]
            assert [e["sentence"] for e in other] == [e["sentence"] for e in events], key
            np.testing.assert_allclose([e["timestamp"] for e in other],
                                       [e["timestamp"] for e in events], rtol=1e-5, atol=1e-4)
        for k, v in ref["stats"].items():
            assert abs(got["stats"][k] - v) <= 1e-5 * abs(v) + 1e-6, k


def test_rss_restart_stops_every_rank_together(runs):
    """``main.rss_over_limit`` over the two-rank group: the largest rank's
    reading decides on every rank (rank 1 alone reads 5 GB against a limit
    of 1), nothing under a limit of 8, and a limit of 0 is off."""
    assert [p["rss_over_limit"] for p in runs["dp2"]] == [(5.0, 0.0, 0.0)] * 2


class TinyDataset:
    """``n`` one-event videos of 3 frames; with ``long_first`` video 0 (the
    sample a short rank's dummy row is collated from) has 6."""

    def __init__(self, n, long_first=False):
        self.n, self.long_first = n, long_first

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        t = 6 if self.long_first and i == 0 else 3
        return {"key": f"k{i}", "video_feature": np.full((t, 4), i, np.float32),
                "duration": 10.0, "gt_timestamps": [[1.0, 2.0]], "action_labels": [0],
                "caption_tokens": [[2, 5, 3]], "raw_captions": ["x"]}


@pytest.mark.parametrize("n,world,shuffle", [(32, 2, False), (33, 2, True), (9, 4, True),
                                             (3, 4, False)])
def test_loader_rank_shards_cover_the_epoch(n, world, shuffle):
    """order[rank::world]: disjoint, covering the epoch, the same number of
    batches on every rank (a short rank's last row a dummy)."""
    ds = TinyDataset(n)
    loaders = [DataLoader(ds, 4, PAD, video_rescale_len=8, max_gt=3, max_caption_len=5,
                          shuffle=shuffle, seed=3, rank=r, world=world) for r in range(world)]
    for lo in loaders:
        lo.set_epoch(2)
    keys = [[k for b in lo for k in b["keys"]] for lo in loaders]
    valid = [sum(int(b["batch_valid"].sum()) for b in lo) for lo in loaders]
    counts = [sum(1 for _ in lo) for lo in loaders]
    assert len(set(counts)) == 1 and counts[0] == len(loaders[0])
    flat = [k for ks in keys for k in ks]
    assert len(flat) == len(set(flat)) == n == sum(valid)
    one = DataLoader(ds, 4, PAD, video_rescale_len=8, max_gt=3, max_caption_len=5,
                     shuffle=shuffle, seed=3)
    one.set_epoch(2)
    order = [k for b in one for k in b["keys"]]
    for r in range(world):
        assert keys[r] == order[r::world]


@pytest.mark.parametrize("n,world,pad_batches,own_collate", [
    (11, 2, True, False), (11, 2, False, False), (11, 2, False, True), (3, 4, True, False)])
def test_loader_dummy_row_is_a_padding_row(n, world, pad_batches, own_collate):
    """When the epoch does not split evenly, the short rank's last batch
    equals its real samples collated with collate_fixed's padding rows, so
    the dummy row adds no caption token, ground truth or valid row to a
    loss term or a global normaliser. (11, 2): the last batch of rank 1 is
    video 9 and the dummy; (3, 4): rank 3 has no video, one dummy row.
    ``own_collate``: a collate_fn that pads nothing, as the raw one."""
    kw = dict(video_rescale_len=8, max_gt=3, max_caption_len=5)
    ds = TinyDataset(n, long_first=not own_collate)
    collate = (lambda s: collate_fixed(s, PAD, **kw)) if own_collate else None
    lo = DataLoader(ds, 4, PAD, shuffle=False, rank=world - 1, world=world,
                    pad_batches=pad_batches, collate_fn=collate, **kw)
    last = list(lo)[-1]
    real = [ds[int(k[1:])] for k in last["keys"]]
    rows = len(last["batch_valid"])
    assert rows == (4 if pad_batches else len(real) + 1)
    assert int(last["batch_valid"].sum()) == int(last["gt_mask"].sum()) == len(real)
    assert int((last["cap_tokens"][..., 1:] != PAD).sum()) == 2 * len(real)
    if not real:
        assert (last["video_tensor"] == 0).all() and not last["video_mask"].any()
        return
    ref = collate_fixed(real, PAD, pad_to_batch=rows, **kw)
    assert set(last) == set(ref) and last["keys"] == ref["keys"]
    for k in ARRAY_KEYS:
        if k in ref:
            np.testing.assert_array_equal(last[k], ref[k], err_msg=k)


def test_shard_batch_and_rules():
    batch = {"a": np.arange(8 * 3).reshape(8, 3), "s": np.zeros((2, 8)), "keys": ["x"]}
    assert make_mesh() is None
    assert set(shard_batch(batch, None)) == {"a", "s"}
    assert split_sizes(6563, 2) == [3282, 3281] and split_sizes(8, 4) == [2] * 4
    from torch.distributed.tensor import Replicate

    from test_torch_common import build_port_model

    jcfg = jax_small_cfg()
    _, params = build_jax_model(jcfg)
    specs = tp_param_specs(build_port_model(jcfg, params))
    sharded = {k: v for k, v in specs.items() if v != Replicate()}
    assert len(sharded) >= 10
    assert "caption.head.weight" in sharded and "caption.head.bias" in sharded
    assert not any("value_proj" in k or "sampling_offsets" in k for k in sharded)
    assert all(not k.endswith("bias") or "linear2" not in k for k in sharded)


def test_cli_under_two_processes_then_resume(tmp_path):
    """torch.distributed.run with 2 gloo processes trains an epoch: one
    train_log.txt line, one checkpoint; one process resumes it."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    common = ["--synthetic", "--device", "cpu", "--batch-size", "8", "--output-dir", "run",
              "--config-overrides", *TINY, "eval_rate=1", "checkpoint_rate=0",
              "print_freq=100", "dataset.activity_net.val_subset=8",
              "dataset.activity_net.train_subset=32"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(free_port()), "-m",
           "multimodal_feature_learning_tpu_torch.main", "--epochs", "1", *common]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "backend gloo" in out.stdout
    run = tmp_path / "run"
    assert sorted(os.listdir(run)) == ["checkpoint", "submission", "train_log.txt",
                                       "val_log.txt"]
    assert len((run / "train_log.txt").read_text().splitlines()) == 1
    assert len(os.listdir(run / "submission")) == 1
    ckpt = torch.load(run / "checkpoint", weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 2  # 32 videos, 8 a rank, 2 ranks
    cmd = [sys.executable, "-m", "multimodal_feature_learning_tpu_torch.main", "--epochs",
           "2", "--resume", "run/checkpoint", *common]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = (run / "train_log.txt").read_text().splitlines()
    assert len(lines) == 2 and '"epoch": 1' in lines[1]
    assert torch.load(run / "checkpoint", weights_only=True)["step"] == 2 + 4
