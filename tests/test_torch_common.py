"""Shared set-up of the parity tests between the JAX package and its PyTorch
port (``multimodal_feature_learning_tpu_torch``). Holds no tests itself.

Both sides get the same small configuration (``__graft_entry__._small_cfg``
dims), the same weights (flax params, perturbed from a numpy seed so that no
head is all zeros, carried into the port by ``utils.weights``) and the same
inputs (made with numpy). The port runs with ``device="cpu"``."""

from __future__ import annotations

import numpy as np

from multimodal_feature_learning_tpu_torch.config import Config

VOCAB_SIZE = 40
PAD, BOS, EOS = 1, 2, 3


def jax_small_cfg(use_differentiable_mask: bool = True):
    from __graft_entry__ import _small_cfg

    from multimodal_feature_learning_tpu.config import recompute_losses

    cfg = _small_cfg(batch_size=4)
    cfg.use_differentiable_mask = use_differentiable_mask
    recompute_losses(cfg)
    return cfg


def torch_cfg_like(jcfg) -> Config:
    """The port's config with every field it reads copied from a JAX config."""
    cfg = Config()
    for name in ("seed", "lr", "lr_drop", "weight_decay", "clip_max_norm",
                 "epochs", "use_differentiable_mask", "compute_dtype", "decode_impl",
                 "decode_kv", "decode_fused_grid"):
        setattr(cfg, name, jcfg[name])
    for name in vars(cfg.dvc.detr):
        setattr(cfg.dvc.detr, name, jcfg.dvc.detr[name])
    for name in vars(cfg.dvc.caption):
        setattr(cfg.dvc.caption, name, jcfg.dvc.caption[name])
    for name in vars(cfg.dvc.matcher):
        setattr(cfg.dvc.matcher, name, jcfg.dvc.matcher[name])
    for name in vars(cfg.dvc):
        if name not in ("detr", "caption", "matcher"):
            value = jcfg.dvc[name]
            setattr(cfg.dvc, name, list(value) if name == "losses" else value)
    for name in vars(cfg.dataset.activity_net):
        setattr(cfg.dataset.activity_net, name, jcfg.dataset.activity_net[name])
    return cfg


def no_dropout(jcfg):
    """Every dropout rate of a JAX config set to 0, in place."""
    jcfg.dvc.detr.transformer_dropout_prob = 0.0
    for name in ("positional_embedding_dropout", "attention_dropout", "projection_dropout",
                 "bridge_dropout", "mlp_dropout_1", "mlp_dropout_2"):
        jcfg.dvc.caption[name] = 0.0
    return jcfg


def flatten_params(params) -> dict:
    """Flax params tree -> {"a||b||c": np.ndarray}, as tools/snapshot_ckpt.py
    writes snapshots."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "||".join(str(p.key) if hasattr(p, "key") else str(p) for p in path)
        out[name] = np.asarray(leaf)
    return out


def perturb(params, seed: int = 0, scale: float = 0.2):
    """Every float leaf plus N(0, scale^2) noise from a numpy seed."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, scale, np.shape(a)).astype(np.float32),
        params)


def build_jax_model(jcfg, seed: int = 0):
    """(model, params) of the JAX UnimodalDVC at jcfg, perturbed from ``seed``."""
    import jax

    from multimodal_feature_learning_tpu.models.dvc import build_model

    model = build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    anet = jcfg.dataset.activity_net
    B, T, G, Lc = 2, anet.video_rescale_len, anet.max_gt_target_segments, anet.max_caption_len_all
    batch = {
        "video_tensor": np.zeros((B, T, jcfg.dvc.detr.feature_dim), np.float32),
        "video_mask": np.zeros((B, T), bool),
        "durations": np.ones((B,), np.float32),
        "gt_segments": np.zeros((B, G, 2), np.float32),
        "gt_mask": np.zeros((B, G), bool),
        "cap_tokens": np.full((B, G, Lc), PAD, np.int32),
    }
    params = model.init(jax.random.PRNGKey(seed), batch)
    return model, perturb(params, seed)


def build_port_model(jcfg, params):
    """The port's UnimodalDVC on the CPU carrying the flax ``params``."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model = build_model(torch_cfg_like(jcfg), VOCAB_SIZE, PAD, BOS, EOS, device="cpu")
    load_flax_params(model, flatten_params(params))
    return model


def serve_inputs(jcfg, B: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    T = jcfg.dataset.activity_net.video_rescale_len
    video = rng.normal(size=(B, T, jcfg.dvc.detr.feature_dim)).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[-1, T - 5:] = True  # one video with a padded tail
    durations = rng.uniform(10, 180, size=(B,)).astype(np.float32)
    return video, mask, durations
