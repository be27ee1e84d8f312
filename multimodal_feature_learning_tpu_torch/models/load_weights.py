"""Pretrained-weight surgery and the GloVe embedding matrix; counterpart of
the JAX ``models/load_weights.py``.

``build_word_embedding_matrix`` reads a GloVe text file into a (vocab, dim)
matrix for the caption decoder's embedding (``models/embeddings.py::
VocabularyEmbedder``), with JAX's pickle cache. The surgery functions work
on numpy arrays in the layouts JAX's do (a timm ViT exported to an npz:
``patch_embed.proj.weight`` (D, C, ph, pw), ``patch_embed.proj.bias``,
``pos_embed`` (1, P + 1, D)); ``transplant_vit_to_vivit`` writes their
results into the port's ViViT (``models/backbones.py::
VideoVisionTransformer``) where JAX's writes into the flax params tree.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

# what a pickled numpy array needs, and nothing else: a crafted cache file
# cannot name any other callable
_ARRAY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct")}


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ARRAY_GLOBALS:
            raise pickle.UnpicklingError(f"{module}.{name} is not part of a numpy array")
        return super().find_class(module, name)


def build_word_embedding_matrix(glove_file_path: str, vocab, pretrained_word_embed_dim: int,
                                cache_path: str = "", seed: int = 0) -> np.ndarray:
    """(len(vocab), dim) f32: a word's GloVe vector where the file has it,
    else N(0, 0.1) from numpy's ``default_rng(seed)``, as JAX's. A matrix of
    that shape in ``cache_path`` (a pickle) is returned as it is; a new one
    is written there."""
    if cache_path:
        try:
            with open(cache_path, "rb") as f:
                mat = _ArrayUnpickler(f).load()
            if mat.shape == (len(vocab), pretrained_word_embed_dim):
                return mat
        except (OSError, pickle.PickleError, AttributeError):
            pass

    embedding_index = {}
    with open(glove_file_path) as f:
        for line in f:
            data = line.rstrip("\n").split(" ")
            embedding_index[data[0]] = np.asarray(data[1:], dtype=np.float32)

    rng = np.random.default_rng(seed)
    matrix = rng.normal(0, 0.1, (len(vocab), pretrained_word_embed_dim)).astype(np.float32)
    for i, word in enumerate(vocab.get_itos()):
        vec = embedding_index.get(word)
        if vec is not None:
            matrix[i] = vec
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump(matrix, f)
    return matrix


def inflate_patch_kernel_to_tubelet(patch_kernel: np.ndarray, temporal_patch_size: int,
                                    method: str = "central frame") -> np.ndarray:
    """A ViT's 2-D patch kernel (D, C, ph, pw) as a tubelet kernel in flax's
    layout (pt, ph, pw, C, D): "central frame" keeps the kernel in the
    middle frame and zeros elsewhere, "filter inflation" repeats it / pt."""
    D, C, ph, pw = patch_kernel.shape
    k2 = patch_kernel.transpose(2, 3, 1, 0)  # (ph, pw, C, D)
    pt = temporal_patch_size
    out = np.zeros((pt, ph, pw, C, D), dtype=patch_kernel.dtype)
    if pt == 1:
        out[0] = k2
    elif method == "filter inflation":
        out[:] = k2[None] / pt
    elif method == "central frame":
        out[pt // 2] = k2
    else:
        raise ValueError(f"unknown tokenization method {method!r}")
    return out


def repeat_pos_embed_for_frames(pos_embed: np.ndarray, num_frames: int) -> np.ndarray:
    """(1, P + 1, D) -> (1, num_frames * P + 1, D): the class slot kept, the
    patch slots tiled once a frame."""
    patches = np.tile(pos_embed[:, 1:], (1, num_frames, 1))
    return np.concatenate([pos_embed[:, :1], patches], axis=1)


def interpolate_pos_embed(pos_embed: np.ndarray, n_out: int) -> np.ndarray:
    """(1, n_in, D) -> (1, n_out, D), each channel linearly interpolated
    over the rows (AST's positional-embedding surgery)."""
    n_in, D = pos_embed.shape[1], pos_embed.shape[2]
    if n_in == n_out:
        return pos_embed
    x_out = np.linspace(0, n_in - 1, n_out)
    x_in = np.arange(n_in)
    out = np.stack([np.interp(x_out, x_in, pos_embed[0, :, d]) for d in range(D)], axis=1)
    return out[None].astype(pos_embed.dtype)


def transplant_vit_to_vivit(vit_npz: Dict[str, np.ndarray], vivit: torch.nn.Module,
                            num_frames: int, temporal_patch_size: int = 1,
                            tokenization_method: str = "central frame",
                            model_name: str = "factorised encoder") -> torch.nn.Module:
    """A ViT checkpoint carried into the port's ViViT in place: the patch
    kernel inflated to a tubelet and its bias; the positional embedding
    tiled over the frames into ``pos_embedding`` ("spatio temporal
    attention") or as it is into ``spatial_pos_embedding`` ("factorised
    encoder"), as many rows as both have; the other two modes take no
    positional rows. The encoder blocks keep their weights, as in JAX's."""
    kernel = inflate_patch_kernel_to_tubelet(vit_npz["patch_embed.proj.weight"],
                                             temporal_patch_size, tokenization_method)
    proj = vivit.token_embeddings_layer.project_to_patch
    pos = vit_npz["pos_embed"]
    with torch.no_grad():
        # flax's (pt, ph, pw, C, D) as torch's Conv3d (D, C, pt, ph, pw)
        proj.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2))))
        proj.bias.copy_(torch.from_numpy(np.asarray(vit_npz["patch_embed.proj.bias"])))
        if model_name == "spatio temporal attention":
            pos, table = repeat_pos_embed_for_frames(pos, num_frames), vivit.pos_embedding
        elif model_name == "factorised encoder":
            table = vivit.spatial_pos_embedding
        else:
            return vivit
        n = min(pos.shape[1], table.shape[1])
        table[:, :n] = torch.from_numpy(np.ascontiguousarray(pos[:, :n]))
    return vivit
