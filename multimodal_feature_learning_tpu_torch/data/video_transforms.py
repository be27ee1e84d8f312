"""Raw-frame preprocessing; the port's copy of the JAX package's
``data/video_transforms.py``.

Frames are channels-last tensors (..., H, W, C). ``normalize`` runs inside
the models, on the card, after the uint8 frames were copied there: the
batch travels as uint8, a quarter of its f32 bytes. ``resize_bilinear`` is
``jax.image.resize(method="bilinear")``: a triangle kernel, widened by the
scale when it shrinks (antialiasing), its weights normalised per output
pixel, applied as one weight matrix per spatial axis.
``temporal_resample_nearest`` runs on numpy in the host loader.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _weight_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of JAX's ``compute_weight_mat`` for a
    resize (scale n_out / n_in, no translation, antialiased)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]) \
        .abs() / kernel_scale
    w = (1.0 - x.abs()).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """frames (..., H, W, C) -> (..., out_h, out_w, C) f32; an axis whose
    size does not change is left as it is, as in JAX."""
    x = frames.float()
    H, W = x.shape[-3], x.shape[-2]
    if H != out_h:
        x = torch.einsum("...hwc,ho->...owc", x, _weight_matrix(H, out_h, x.device))
    if W != out_w:
        x = torch.einsum("...hwc,wo->...hoc", x, _weight_matrix(W, out_w, x.device))
    return x


def resize_short_side(frames: torch.Tensor, size: int = 256) -> torch.Tensor:
    """Resize so that the short spatial side is ``size``."""
    H, W = frames.shape[-3], frames.shape[-2]
    if H <= W:
        out_h, out_w = size, int(round(W * size / H))
    else:
        out_h, out_w = int(round(H * size / W)), size
    return resize_bilinear(frames, out_h, out_w)


def center_crop(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    H, W = frames.shape[-3], frames.shape[-2]
    top, left = (H - size) // 2, (W - size) // 2
    return frames[..., top:top + size, left:left + size, :]


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (or float in [0, 255]) -> ImageNet-normalised f32."""
    x = frames.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def random_hflip(frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                 p: float = 0.5) -> torch.Tensor:
    """The whole clip flipped left-right with probability ``p``, drawn from
    ``generator`` (training augmentation)."""
    if float(torch.rand((), generator=generator)) < p:
        return frames.flip(-2)
    return frames


def preprocess_clip(frames: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None, resize_size: int = 256,
                    crop_size: int = 224) -> torch.Tensor:
    """(T, H, W, C) uint8 -> resize the short side, centre crop, normalise,
    and in training a random flip."""
    x = normalize(center_crop(resize_short_side(frames, resize_size), crop_size))
    if train:
        x = random_hflip(x, generator)
    return x


def temporal_resample_nearest(frames: np.ndarray, num_out: int) -> np.ndarray:
    """``num_out`` frames picked at round(i (T - 1) / (num_out - 1)), as
    JAX's: the quotient in f32, rounded half to even."""
    T = frames.shape[0]
    pos = (np.arange(num_out) * (T - 1)).astype(np.float32) / np.float32(max(num_out - 1, 1))
    idx = np.clip(np.round(pos), 0, T - 1)
    return frames[idx.astype(np.int32)]
