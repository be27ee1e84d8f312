"""Shared set-up of the parity tests between the JAX package and its PyTorch
port (``multimodal_feature_learning_tpu_torch``). Holds no tests itself.

Both sides get the same small configuration (``__graft_entry__._small_cfg``
dims), the same weights (flax params, perturbed from a numpy seed so that no
head is all zeros, carried into the port by ``utils.weights``) and the same
inputs (made with numpy). The port runs with ``device="cpu"``."""

from __future__ import annotations

import os

import numpy as np
import torch

from multimodal_feature_learning_tpu_torch.config import Config

# The tier-1 command runs the tests in six processes on the machine's cores
# (every process imports this module when it collects the port's tests).
# torch's default of a thread per core in each of them oversubscribes the
# cores, and its spinning thread pools then run the port's many small
# operations tens of times slower than one thread does: one thread a
# process, and for the processes the tests start.
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

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
                 "decode_kv", "decode_fused_grid", "use_raw_videos"):
        setattr(cfg, name, jcfg[name])
    groups = ("detr", "caption", "matcher", "decoder", "vivit", "ast")
    for group in groups:
        for name in vars(getattr(cfg.dvc, group)):
            setattr(getattr(cfg.dvc, group), name, jcfg.dvc[group][name])
    for name in vars(cfg.dvc):
        if name not in groups:
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


def family_cfg(family: str, use_differentiable_mask: bool = True,
               bimodal: bool = False):
    """A JAX config at ``_small_cfg`` dims of ``family``: "sparse", "dense"
    (use_deformable_detr), "mm" (video + audio, sparse) or "mm_dense"
    (video + audio, dense); audio_rescale_len 12, as
    ``tests/test_multimodal.py::mm_cfg``."""
    from multimodal_feature_learning_tpu.config import recompute_losses

    jcfg = jax_small_cfg(use_differentiable_mask)
    jcfg.dvc.use_sparse_detr = family in ("sparse", "mm")
    jcfg.dvc.use_deformable_detr = not jcfg.dvc.use_sparse_detr
    if family.startswith("mm"):
        jcfg.dvc.input_modalities = ["video", "audio"]
        jcfg.dataset.activity_net.audio_rescale_len = 12
        jcfg.dvc.use_bimodal_encoder = bimodal
    recompute_losses(jcfg)
    return jcfg


def build_jax_family(jcfg, seed: int = 0):
    """(model, params) of the JAX family that ``jcfg`` names, its params
    perturbed from ``seed``, as ``build_jax_model``."""
    import jax

    from multimodal_feature_learning_tpu.models.multimodal import build_multimodal_model

    if len(jcfg.dvc.input_modalities) == 1:
        return build_jax_model(jcfg, seed)
    model = build_multimodal_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    anet = jcfg.dataset.activity_net
    B, T, Ta = 2, anet.video_rescale_len, anet.audio_rescale_len
    G, Lc, F = anet.max_gt_target_segments, anet.max_caption_len_all, jcfg.dvc.detr.feature_dim
    batch = {
        "video_tensor": np.zeros((B, T, F), np.float32),
        "video_mask": np.zeros((B, T), bool),
        "audio_tensor": np.zeros((B, Ta, F), np.float32),
        "audio_mask": np.zeros((B, Ta), bool),
        "durations": np.ones((B,), np.float32),
        "gt_segments": np.zeros((B, G, 2), np.float32),
        "gt_mask": np.zeros((B, G), bool),
        "cap_tokens": np.full((B, G, Lc), PAD, np.int32),
    }
    params = model.init(jax.random.PRNGKey(seed), batch)
    return model, perturb(params, seed)


def small_vocab():
    """A port Vocab of VOCAB_SIZE entries (the specials at PAD, BOS, EOS)."""
    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    return Vocab(["<unk>", "<pad>", "<bos>", "<eos>"]
                 + [f"w{i}" for i in range(VOCAB_SIZE - 4)])


def build_port_family(jcfg, params):
    """(model, criterion, weight_dict) of the port's family builder on the
    CPU, the model carrying the flax ``params``."""
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model, criterion, weight_dict = build_model_and_criterion(
        torch_cfg_like(jcfg), small_vocab(), device="cpu")
    load_flax_params(model, flatten_params(params))
    return model, criterion, weight_dict


def array_batch(tcfg, B: int, seed: int = 0) -> dict:
    """The numpy arrays of one ``synthetic_batches`` batch (audio included
    for two modalities)."""
    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches

    batch = next(synthetic_batches(tcfg, B, VOCAB_SIZE, seed=seed))
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


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


# -- training and evaluation against JAX, shared by the family files ------------

# the tolerances of tests/test_torch_train.py and tests/test_torch_eval.py
LOSS_REL, LOSS_ATOL = 1e-5, 1e-6
GRAD_REL = 2e-4
SHIFT_FREE = "k_linear||bias"  # exact gradient 0
LOGP_ATOL = 1e-4


def jax_losses_and_grads(jcfg, jmodel, params, batch):
    """(indices, indices_aux, loss terms, gradients) of JAX's train forward,
    compiled."""
    import jax

    from multimodal_feature_learning_tpu.models.criterion import SetCriterion as JaxCriterion
    from multimodal_feature_learning_tpu.models.criterion import build_weight_dict as jax_weights

    weight_dict = jax_weights(jcfg)
    crit = JaxCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=weight_dict,
                        losses=list(jcfg.dvc.losses), pad_idx=PAD, smoothing=jcfg.dvc.smoothing)

    def loss_fn(p, b):
        out, indices, indices_aux, memory_mask = jmodel.forward_train(
            p, b, jax.random.PRNGKey(0))
        losses = crit(out, b, indices, indices_aux, memory_mask)
        total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        return total, (losses, indices, indices_aux)

    (total, (losses, idx, idx_aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    losses = {k: float(v) for k, v in losses.items()}
    losses["loss"] = float(total)
    return np.asarray(idx), np.asarray(idx_aux), losses, flatten_params(grads)


def port_losses_and_grads(model, criterion, weight_dict, tb):
    """The same from the port's model (left in eval mode, gradients
    cleared)."""
    import torch

    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    model.zero_grad(set_to_none=True)
    model.train()
    out = model.forward_train(tb)
    losses = criterion(out[0], tb, out[1], out[2], out[3])
    total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
    total.backward()
    grads = export_flax_params({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    model.eval()
    losses = {k: float(v.detach()) for k, v in losses.items()}
    losses["loss"] = float(total.detach())
    return out[1].numpy(), out[2].numpy(), losses, grads


def assert_losses_match(ref, got, min_terms: int = 10):
    """Every loss term within LOSS_REL (atol LOSS_ATOL); at least
    ``min_terms`` of them (a one-layer model has no auxiliary terms)."""
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))
    assert len(ref) >= min_terms
    for k in ref:
        assert abs(got[k] - ref[k]) <= max(LOSS_REL * abs(ref[k]), LOSS_ATOL), (k, got[k], ref[k])


def assert_grads_match(ref, got, shift_free=(SHIFT_FREE,)):
    """Every leaf within GRAD_REL x its max |g|, except the biases whose
    exact gradient is 0 (``shift_free`` suffixes), which both sides must
    keep under 1e-5 x their kernel's; returns how many are not all zero."""
    assert set(ref) == set(got)
    nonzero = 0
    for k in ref:
        if k.endswith(tuple(shift_free)):
            kernel = float(np.abs(ref[k.replace("bias", "kernel")]).max())
            assert float(np.abs(ref[k]).max()) <= 1e-5 * kernel, k
            assert float(np.abs(got[k]).max()) <= 1e-5 * kernel, k
            continue
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=GRAD_REL * scale + 1e-8,
                                   err_msg=k)
        nonzero += scale > 0
    return nonzero
