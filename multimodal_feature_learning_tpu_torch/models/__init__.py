"""Modules of the port; counterpart of the JAX ``models/``.

``build_model_and_criterion`` is the family builder of JAX
``models/__init__.py``: the family follows the config's flags
(``dvc.use_sparse_detr`` / ``dvc.use_deformable_detr``, the number of
``dvc.input_modalities`` and ``use_raw_videos``), then the weight dict and
the criterion.
"""

from __future__ import annotations

import os


def build_model_and_criterion(cfg, vocab, device="cuda", seed: int = 0,
                              embedding_matrix=None):
    """(model in eval mode on ``device``, its weights drawn from ``seed``;
    criterion; weight_dict) for ``cfg`` and ``vocab`` (its length and its
    ``pad_idx``, ``bos_idx``, ``eos_idx``). With a family flag on, two input
    modalities build the multimodal family (``RawMultimodalDVC`` with
    ``use_raw_videos``), one the sparse or the dense unimodal family; with
    both off, the regular family (over raw frames with ``use_raw_videos``).
    The caption decoder's embedding starts from ``embedding_matrix``; when
    none is given and ``dvc.caption.glove_file_path`` names a file, from
    the matrix ``models/load_weights.py`` builds of it (cached in
    ``dvc.caption.embedding_matrix_file_path``), as JAX's builder does."""
    from .criterion import build_criterion
    from .dvc import build_model
    from .multimodal import build_multimodal_model
    from .regular_dvc import build_regular_model

    cap = cfg.dvc.caption
    if embedding_matrix is None and cap.glove_file_path and os.path.exists(cap.glove_file_path):
        from .load_weights import build_word_embedding_matrix

        embedding_matrix = build_word_embedding_matrix(
            cap.glove_file_path, vocab, cap.pretrained_word_embed_dim,
            cache_path=cap.embedding_matrix_file_path)
    if not (cfg.dvc.use_sparse_detr or cfg.dvc.use_deformable_detr):
        build = build_regular_model
    elif len(cfg.dvc.input_modalities) == 2:
        build = build_multimodal_model
    else:
        build = build_model
    model = build(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                  device=device, seed=seed, embedding_matrix=embedding_matrix)
    criterion, weight_dict = build_criterion(cfg, vocab.pad_idx)
    return model, criterion, weight_dict
