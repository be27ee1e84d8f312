"""A cell of the benchmark at the CPU tests' size: the flagship's or the
video + audio family's configuration cut to narrow widths, seeded weights,
and the mix of a cell with its pool and load cut to match."""

from __future__ import annotations

import copy

from portbench import registry

TINY = {"dvc": {"d_model": 64, "num_queries": 6,
                "detr": {"feature_dim": 64, "d_model": 64, "num_heads": 2, "enc_layers": 2,
                         "dec_layers": 2, "transformer_ff_dim": 128, "video_rescale_len": 24,
                         "num_feature_levels": 3},
                "caption": {"d_model": 64, "depth": 2, "num_heads": 2}},
        "dataset": {"activity_net": {"video_rescale_len": 24, "max_caption_len_all": 8,
                                     "max_gt_target_segments": 4, "audio_rescale_len": 10}}}
VOCAB = 50


def merge(tree: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict):
            merge(tree[k], v)
        else:
            tree[k] = v
    return tree


def tiny_cell(root: str, workload: str, **traffic) -> registry.Cell:
    """``workload``'s cell at the tests' size; ``traffic`` overrides the
    mix's parameters."""
    cell = registry.find_cell(root, workload)
    cell = copy.deepcopy(cell)
    cell.config["config"] = merge(cell.config["config"], copy.deepcopy(TINY))
    cell.config["vocab_size"] = VOCAB
    cell.config["weights"] = {"kind": "seeded"}
    cell.traffic.update(traffic)
    cell.traffic["tokens"] = [12, 40]
    cell.traffic["audio_tokens"] = [6, 20]
    return cell
