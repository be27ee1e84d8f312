"""Export a checkpoint of the port's training CLI as a reference-loadable
``.pth``; counterpart of the JAX package's root
``tools/export_to_reference.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.export_to_reference \\
        --resume run/checkpoint --out reference_checkpoint.pth [--synthetic] \\
        [--device cuda|cpu] [--config-overrides a.b=value ...]

The reverse of ``--from-reference-checkpoint``: the flagship model of the
checkpoint (``engine/state.py`` format) in the reference's state_dict
naming (``utils/ref_bridge.py::reference_state_dict``), saved as
``{'model': state_dict, 'epoch': N}`` with the checkpoint's epoch, as the
reference's own ``main.py`` saves, so the reference resumes it. The
config flags must be the ones the checkpoint was trained with (as for
``inference --resume``). The model is built in f32, as JAX's tool restores
onto an f32 template: a checkpoint with bf16 masters comes out as f32
tensors holding its bf16 values.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Writes the ``.pth`` and prints JAX's summary line; returns {"out",
    "epoch", "tensors", "params"}."""
    import torch

    from ..config import apply_overrides, load_config, recompute_losses
    from ..data.anet import build_dataset
    from ..device import resolve_device
    from ..engine.state import load_model_weights
    from ..main import make_synthetic_world
    from ..models.dvc import build_model
    from ..utils.ref_bridge import reference_state_dict

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resume", required=True, help="a checkpoint of the port's training CLI")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config-overrides", nargs="*", default=[])
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(), args.config_overrides)
    if args.synthetic:
        cfg = make_synthetic_world(cfg)
    recompute_losses(cfg)
    _, vocab = build_dataset("val", cfg)
    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device=dev, seed=cfg.seed)
    epoch = load_model_weights(args.resume, model)
    sd = reference_state_dict(model, cfg)
    torch.save({"model": sd, "epoch": epoch}, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"exported {args.resume} (epoch {epoch}) -> {args.out}: "
          f"{len(sd)} tensors, {n / 1e6:.2f} M params")
    return {"out": args.out, "epoch": epoch, "tensors": len(sd), "params": n}


if __name__ == "__main__":
    main()
