"""The comparison's own checks at the CPU tests' size. The control (the
plain reference in the program's place, with its products rounded to TF32)
comes out not correct under a serving cell's limits, where the program
comes out correct; in training the narrow model feels TF32 less than the
cells' full widths do, so there the control has to read a hundred times
the program's gap on one number or more (on the card, at the cells' size,
it fails the limits: ``python3 -m portbench.control``, and the ``card``
test on one seed). With the timed path broken underneath, a whole run (all
but the look for a card) comes out not correct, once for each fault a cell
can have."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import check, control, serve_cell, train_cell
from portbench.run import ROOT, run_cell
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SERVE = dict(batch_size=2, outstanding=4, pool=8, check_requests=4)
TRAIN = dict(batch_size=2, pool=3)


@pytest.mark.parametrize("workload", ["sparse_dvc.serve_backlog", "sparse_dvc.serve_poisson"])
def test_serving_control_fails_where_the_program_passes(workload):
    cell = tiny_cell(ROOT, workload, **SERVE, rate_per_s=20.0)
    env = serve_cell.setup(cell, 5, CPU)
    run = serve_cell.window(env, cell.traffic, 5, 1.0, False, CPU)
    serve_cell.free(env)
    numbers = serve_cell.correctness(cell, env, run, 5, CPU)
    assert check.judge(numbers, cell.limits)[0]
    assert not check.judge(control.serve_control(cell, numbers, CPU), cell.limits)[0]


@pytest.mark.parametrize("workload", ["sparse_dvc.train_b64", "mm_dvc.train_b64"])
def test_training_control_fails_where_the_program_passes(workload):
    cell = tiny_cell(ROOT, workload, **TRAIN)
    env = train_cell.setup(cell, 5, CPU, trace=False)
    train_cell.free(env)
    numbers = train_cell.correctness(cell, env, 5, CPU)
    assert check.judge(numbers, cell.limits)[0]
    low = train_cell.reference_steps(cell, env, 5, CPU, precision="tf32")
    control = check.train_numbers(low, numbers["_ref"], env.p0)
    assert any(control[k] >= 100 * max(numbers[k], 1e-9) for k in cell.limits)


def _broken_run(workload, monkeypatch, target, replacement, **traffic):
    cell = tiny_cell(ROOT, workload, **traffic)
    monkeypatch.setattr(target[0], target[1], replacement)
    return run_cell(cell, 9, 1.0, False, CPU, time.monotonic())


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from multimodal_feature_learning_tpu_torch.engine import state

    def no_update(self, step):
        return torch.zeros(()), self.lr_schedule(step)

    result = _broken_run("sparse_dvc.train_b64", monkeypatch, (state.ClippedAdamW, "step"),
                         no_update, **TRAIN)
    assert result["correct"] is False


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from multimodal_feature_learning_tpu_torch.engine import train

    orig = train.batch_to_device

    def half(batch, device, transfer_dtype=None):
        out = orig(batch, device, transfer_dtype)
        return {k: v[:len(v) // 2] for k, v in out.items()}

    result = _broken_run("mm_dvc.train_b64", monkeypatch, (train, "batch_to_device"), half,
                         **TRAIN)
    assert result["correct"] is False


@pytest.mark.parametrize("what", ["token", "segment"])
def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch, what):
    from multimodal_feature_learning_tpu_torch.serve import DVCServer

    orig = DVCServer._events

    def altered(self, i, k, caption_rows, segments, scores):
        events = orig(self, i, k, caption_rows, segments, scores)
        if what == "token":
            events[0]["caption"][1] = (events[0]["caption"][1] + 1) % 50
        else:
            s, e = events[0]["segment"]
            events[0]["segment"] = (s + 1.0, e + 1.0)
        return events

    result = _broken_run("sparse_dvc.serve_backlog", monkeypatch, (DVCServer, "_events"),
                         altered, **SERVE)
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", ["sparse_dvc.serve_backlog", "sparse_dvc.train_b64"])
def test_control_on_the_card_at_the_cells_size(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", workload,
                          "--seeds", "2147483701"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    # the trainer logs its steps to standard output too
    line = json.loads(next(l for l in out.stdout.splitlines() if l.startswith('{"seed"')))
    limits = json.load(open(os.path.join(ROOT, "portbench", "limits", f"{workload}.json")))
    assert check.judge(line["program"], limits)[0]
    assert not check.judge(line["control"], limits)[0]
