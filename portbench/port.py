"""The benchmark's one door into the system under test, the PyTorch/CUDA
port ``multimodal_feature_learning_tpu_torch``: its configuration, its model
on the card, its static server, its trainer, and its kernel launch counters.
No other module of the harness imports the port, and nothing here imports
the JAX package.

A configuration file (``configs/<name>.json``) holds ``config``, the port's
configuration as it is run (every field, nested as ``config/defaults.py``
nests it), and ``weights``: ``{"kind": "snapshot", "path": ...}`` (a flat
flax ``.npz`` in the checkout, loaded strictly) or ``{"kind": "seeded"}``
(drawn on the card from the run's seed, ``weights.fill_seeded``).
"""

from __future__ import annotations

import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def apply_config(cfg, tree: dict, prefix: str = ""):
    """Set every leaf of ``tree`` on the dataclass tree ``cfg``; a key that
    the configuration does not have raises."""
    for key, value in tree.items():
        if not hasattr(cfg, key):
            raise KeyError(f"the configuration has no field {prefix}{key}")
        if isinstance(value, dict):
            apply_config(getattr(cfg, key), value, f"{prefix}{key}.")
        else:
            setattr(cfg, key, list(value) if isinstance(value, list) else value)
    return cfg


def port_config(tree: dict):
    from multimodal_feature_learning_tpu_torch.config import load_config

    return apply_config(load_config(), tree)


def build_model(spec: dict, device, seed: int):
    """The port's model of configuration ``spec`` on ``device`` in eval
    mode, built on the device, carrying the configuration's weights.
    Returns (cfg, model)."""
    from multimodal_feature_learning_tpu_torch.device import set_f32_numerics
    from multimodal_feature_learning_tpu_torch.models.dvc import UnimodalDVC
    from multimodal_feature_learning_tpu_torch.models.multimodal import MultimodalDVC
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params, load_npz

    from .weights import fill_seeded

    cfg = port_config(spec["config"])
    cls = MultimodalDVC if len(cfg.dvc.input_modalities) == 2 else UnimodalDVC
    set_f32_numerics(torch.device(device))
    with torch.device(device):
        model = cls(cfg, spec["vocab_size"])
    model = model.to(device).eval()
    if spec["weights"]["kind"] == "snapshot":
        load_flax_params(model, load_npz(os.path.join(ROOT, spec["weights"]["path"])))
    else:
        fill_seeded(model, seed)
    return cfg, model


def make_server(model, mix: dict):
    """The port's static micro-batching server (``serve.py::DVCServer``) at
    the mix's batch size and wait; its constructor warms a full batch up."""
    from multimodal_feature_learning_tpu_torch.serve import DVCServer

    return DVCServer(model, batch_size=mix["batch_size"], max_wait_ms=mix["max_wait_ms"])


def make_trainer(cfg, model, seed: int):
    """(state, train_step, train_one_epoch): the port's train state at step
    0 (clip + AdamW), its train step with its dropout seeded from ``seed``,
    and its epoch loop (``engine/train.py``)."""
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (make_train_step,
                                                                   train_one_epoch)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion

    criterion, weight_dict = build_criterion(cfg, pad_idx=1)
    state = create_train_state(cfg, model, steps_per_epoch=1 << 30)
    return state, make_train_step(criterion, weight_dict, seed=seed), train_one_epoch


def adam_first_moments(state) -> dict:
    """{parameter name: AdamW's first moment} of the port's optimizer."""
    moments = state.optimizer.adamw.state
    return {n: moments[p]["exp_avg"] for n, p in state.model.named_parameters()
            if p in moments}


def launches() -> dict:
    """Every kernel of the port by name with its launch count so far."""
    from multimodal_feature_learning_tpu_torch.ops import fused_decode, msda
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN

    return {"msda_fwd": msda.MSDA_FWD.launches, "msda_bwd": msda.MSDA_BWD.launches,
            "fused_decode": fused_decode.FUSED_DECODE["video"].launches
            + fused_decode.FUSED_DECODE["batch"].launches,
            "hungarian": HUNGARIAN.launches}


def build_kernels() -> None:
    """Compile every kernel of the port into its build directory inside the
    checkout, all at once (a no-op once built)."""
    from multimodal_feature_learning_tpu_torch.ops import build

    build.build()


class recording_msda_calls:
    """Within the block, each MSDA call of the port's model keeps its value
    shape, level lengths, locations, weights and (after the backward) the
    gradient of its output, on the card: the inputs of the kernels' bounds."""

    def __enter__(self):
        from multimodal_feature_learning_tpu_torch.models import msda_module

        self.module, self.orig, records = msda_module, msda_module.ms_deform_attn, []

        def recording(value, shapes, loc, aw):
            out = self.orig(value, shapes, loc, aw)
            rec = {"value": value.detach(), "shapes": tuple(int(s) for s in shapes),
                   "loc": loc.detach(), "aw": aw.detach(), "out": out.detach()}
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))
            records.append(rec)
            return out

        msda_module.ms_deform_attn = recording
        return records

    def __exit__(self, *exc):
        self.module.ms_deform_attn = self.orig

