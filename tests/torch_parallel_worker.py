"""One rank of the port's multi-process runs for ``tests/test_torch_parallel.py``
(not collected: no ``test_`` prefix).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py <layout> <workdir>

``layout`` "dp2x2" (4 ranks: 2 data x 2 model) runs the token-split step
(dropout off), then the tensor-parallel eval forward and two train steps
(dropout on, the token split too), checkpointing after the first; "dp2" (2
data ranks) runs two steps with dropout on, the same two as one multi-step
dispatch, the second step again from the tensor-parallel checkpoint, one
step of the dense and the multimodal families and of the bf16 fold, and
the evaluation loop over the synthetic world; it waits for the 4-rank
layout's checkpoint before resuming it. The inputs (configs, flax
weights, global batches, the world) are in ``workdir``, written by the
test; each rank writes ``<layout>_rank<r>.pt`` there."""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_feature_learning_tpu_torch.engine.state import (  # noqa: E402
    create_train_state, full_state_dicts, load_checkpoint, save_checkpoint, shard_state,
)
from multimodal_feature_learning_tpu_torch.engine.train import (  # noqa: E402
    batch_to_device, forward_loss, make_train_multistep, make_train_step, reduce_metrics,
    stack_batches,
)
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion  # noqa: E402
from multimodal_feature_learning_tpu_torch.models.dvc import build_model  # noqa: E402
from multimodal_feature_learning_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel, make_mesh, maybe_initialize_distributed, replicate_params, shard_batch,
    sync_grads,
)
from multimodal_feature_learning_tpu_torch.utils.weights import (  # noqa: E402
    load_flax_params, load_npz,
)

VOCAB_SIZE, PAD, BOS, EOS = 40, 1, 2, 3
STEPS_PER_EPOCH = 10


def load_inputs(workdir):
    with open(os.path.join(workdir, "cfgs.pkl"), "rb") as f:
        cfgs = pickle.load(f)
    weights = load_npz(os.path.join(workdir, "weights.npz"))
    with np.load(os.path.join(workdir, "batches.npz")) as z:
        batches = [{k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(f"b{i}/")}
                   for i in range(2)]
    return cfgs, weights, batches


def port_model(cfg, weights):
    model = build_model(cfg, VOCAB_SIZE, PAD, BOS, EOS, device="cpu")
    load_flax_params(model, weights)
    return model


def recording(model):
    """Record the final matching of every ``forward_train`` call."""
    seen = []
    forward_train = model.forward_train

    def wrapped(batch):
        out = forward_train(batch)
        seen.append(out[1].clone())
        return out

    model.forward_train = wrapped
    return seen


def params_of(state):
    return {k: v.clone() for k, v in full_state_dicts(state)[0].items()}


def run_dp2x2(workdir, cfgs, weights, batches, mesh):
    res = {}
    local = [batch_to_device(shard_batch(b, mesh), "cpu") for b in batches]
    # the token split alone, dropout off: gradients, then one step
    cfg = cfgs["nodrop"]
    model = replicate_params(port_model(cfg, weights), mesh).shard_tokens_axis(mesh)
    criterion, weight_dict = build_criterion(cfg, PAD)
    model.train()
    with data_parallel(mesh):
        total, _ = forward_loss(model, criterion, weight_dict, local[0])
    total.backward()
    sync_grads(model.parameters(), mesh)
    res["sp_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=0, mesh=mesh)
    res["sp_metrics"] = reduce_metrics(step(state, local[0]), mesh)
    res["sp_params"] = params_of(state)

    # tensor parallel with the token split, dropout on
    cfg = cfgs["drop"]
    model = replicate_params(port_model(cfg, weights), mesh)
    criterion, weight_dict = build_criterion(cfg, PAD)
    state = shard_state(create_train_state(cfg, model, STEPS_PER_EPOCH), mesh, tp_axis="model")
    model.shard_tokens_axis(mesh)
    res["n_col"] = sum(type(m).__name__ == "ColumnParallelLinear" for m in model.modules())
    res["n_row"] = sum(type(m).__name__ == "RowParallelLinear" for m in model.modules())
    res["ffn_gather"] = {n: m.gather for n, m in model.named_modules()
                         if n.endswith(("linear1", "fully_connected_1"))}
    model.eval()
    with torch.no_grad(), data_parallel(mesh):
        out, captions, indices, _, _ = model.forward_eval(local[0], "teacher_forcing")
    res["tp_eval"] = {k: out[k].clone() for k in ("pred_segments", "pred_count",
                                                  "pred_captions")}
    res["tp_eval"]["indices"] = indices.clone()
    seen = recording(model)
    step = make_train_step(criterion, weight_dict, seed=0, mesh=mesh)
    res["tp_metrics"] = [reduce_metrics(step(state, local[0]), mesh)]
    res["ckpt"] = save_checkpoint(workdir, state, epoch=0, name="ckpt_tp")
    if res["ckpt"] is not None:
        open(res["ckpt"] + ".done", "w").close()
    res["tp_metrics"].append(reduce_metrics(step(state, local[1]), mesh))
    res["tp_indices"] = seen
    res["tp_params"] = params_of(state)
    res["tp_local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return res


def variant_step(cfg, mesh=None):
    """One step with dropout of ``cfg``'s family from weights drawn from
    seed 0 on ``synthetic_batches``' first batch of 8 (numpy seed 0): the
    global metrics and the final matching of this rank's rows."""
    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_common import small_vocab

    model, criterion, weight_dict = build_model_and_criterion(cfg, small_vocab(), device="cpu",
                                                              seed=0)
    replicate_params(model, mesh)
    seen = recording(model)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    batch = next(synthetic_batches(cfg, 8, VOCAB_SIZE, seed=0))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    step = make_train_step(criterion, weight_dict, seed=0, mesh=mesh)
    metrics = reduce_metrics(step(state, batch_to_device(shard_batch(batch, mesh), "cpu")), mesh)
    return {"metrics": metrics, "indices": seen[0]}


def run_dp2(workdir, cfgs, weights, batches, mesh):
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.engine.evaluate import evaluate, make_eval_step
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
    from multimodal_feature_learning_tpu_torch.parallel.mesh import axis_rank_size

    res = {}
    local = [batch_to_device(shard_batch(b, mesh), "cpu") for b in batches]
    cfg = cfgs["drop"]
    model = replicate_params(port_model(cfg, weights), mesh)
    criterion, weight_dict = build_criterion(cfg, PAD)
    seen = recording(model)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=0, mesh=mesh)
    res["dp_metrics"] = [reduce_metrics(step(state, b), mesh) for b in local]
    res["dp_indices"] = seen
    res["dp_params"] = params_of(state)

    model = replicate_params(port_model(cfg, weights), mesh)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    multi = make_train_multistep(criterion, weight_dict, seed=0, mesh=mesh)
    res["multi_metrics"] = reduce_metrics(multi(state, stack_batches(local)), mesh)
    res["multi_params"] = params_of(state)

    # the second step again, from the checkpoint written under DP x TP
    done = os.path.join(workdir, "ckpt_tp.done")
    for _ in range(2400):
        if os.path.exists(done):
            break
        time.sleep(0.1)
    model = port_model(cfg, weights)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH)
    res["restored_epoch"] = load_checkpoint(os.path.join(workdir, "ckpt_tp"), state)
    shard_state(state, mesh)
    res["restored_metrics"] = reduce_metrics(step(state, local[1]), mesh)
    res["restored_params"] = params_of(state)

    # one step of the other families and of the bf16 fold
    for name, vcfg in cfgs["variants"].items():
        res[f"variant_{name}"] = variant_step(vcfg, mesh)

    # the evaluation loop over the synthetic world, each rank its shard
    wcfg = cfgs["world"]
    val_ds, vocab = build_dataset("val", wcfg)
    rank, world = axis_rank_size(mesh)
    loader = DataLoader(val_ds, 4, vocab.pad_idx, video_rescale_len=24, max_gt=4,
                        max_caption_len=8, shuffle=False, rank=rank, world=world)
    model, criterion, weight_dict = build_model_and_criterion(wcfg, vocab, device="cpu", seed=0)
    replicate_params(model, mesh)
    eval_step = make_eval_step(model, criterion, weight_dict, "one_by_one", mesh=mesh)
    stats, submission, scores = evaluate(eval_step, loader, vocab, wcfg, device="cpu",
                                         mesh=mesh)
    res["eval"] = {"stats": stats, "submission": submission, "batches": len(loader)}

    # the training CLI's rss_restart_gb over the group: rank 1 alone over the
    # limit of 1 GB (its reading replaced), so both ranks must see its 5 GB
    from multimodal_feature_learning_tpu_torch import main as train_main

    train_main.host_rss_gb = lambda: 5.0 if rank == 1 else 0.5
    res["rss_over_limit"] = (train_main.rss_over_limit(1), train_main.rss_over_limit(8),
                             train_main.rss_over_limit(0))
    return res


def main():
    layout, workdir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    maybe_initialize_distributed("cpu")
    cfgs, weights, batches = load_inputs(workdir)
    if layout == "dp2x2":
        mesh = make_mesh(2, 2)
        res = run_dp2x2(workdir, cfgs, weights, batches, mesh)
    else:
        mesh = make_mesh(2, 1)
        res = run_dp2(workdir, cfgs, weights, batches, mesh)
    res["mesh"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    torch.save(res, os.path.join(workdir, f"{layout}_rank{os.environ['RANK']}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
