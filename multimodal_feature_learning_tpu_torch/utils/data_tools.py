"""Data tooling; counterpart of the JAX ``utils/data_tools.py``, as
functions and a CLI:

    python -m multimodal_feature_learning_tpu_torch.utils.data_tools <command>

``make-npy`` writes JAX's synthetic feature fixture (``make_h5``'s arrays,
the same seed, the same order) as the port's feature format, a directory of
``<video key>.npy``; ``check-timestamps`` lists ground truth whose start is
not before its end; ``get-invalid-ids`` lists the videos with no source file.
An h5 feature file of the JAX package becomes such a directory through the
root ``tools/h5_to_npy.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np


def make_npy(annotation_file: str, out_dir: str, num_tokens: int = 64,
             feature_dim: int = 512, seed: int = 0) -> str:
    """Synthetic features for every video of ``annotation_file``, as
    ``<out_dir>/<key>.npy``: uniform [0, 1) f32 (num_tokens, feature_dim)
    from numpy's ``default_rng(seed)`` in the annotations' order, the arrays
    JAX's ``make_h5`` writes into its h5 file."""
    with open(annotation_file) as f:
        ann = json.load(f)
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for key in ann:
        np.save(os.path.join(out_dir, f"{key}.npy"),
                rng.random((num_tokens, feature_dim), dtype=np.float32))
    return out_dir


def check_timestamps(annotation_files: List[str]) -> Dict[str, List]:
    """{video id: its timestamps with start >= end} over the files."""
    bad: Dict[str, List] = {}
    for path in annotation_files:
        with open(path) as f:
            ann = json.load(f)
        for vid, entry in ann.items():
            for ts in entry["timestamps"]:
                if ts[0] >= ts[1]:
                    bad.setdefault(vid, []).append(ts)
    return bad


def get_invalid_ids(annotation_files: List[str], video_folder: str, out_json: str = "",
                    extension: str = ".mp4") -> List[str]:
    """Ids of the annotated videos with no file (by stem, ``<id>`` or
    ``v_<id>``) in ``video_folder``, written to ``out_json`` when given."""
    present = set()
    if os.path.isdir(video_folder):
        present = {os.path.splitext(f)[0] for f in os.listdir(video_folder)}
    invalid = []
    for path in annotation_files:
        with open(path) as f:
            ann = json.load(f)
        for vid in ann:
            if vid not in present and f"v_{vid}" not in present:
                invalid.append(vid)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(invalid, f)
    return invalid


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    mn = sub.add_parser("make-npy")
    mn.add_argument("annotation_file")
    mn.add_argument("out_dir")
    mn.add_argument("--num-tokens", type=int, default=64)
    mn.add_argument("--feature-dim", type=int, default=512)
    ct = sub.add_parser("check-timestamps")
    ct.add_argument("annotation_files", nargs="+")
    gi = sub.add_parser("get-invalid-ids")
    gi.add_argument("annotation_files", nargs="+")
    gi.add_argument("--video-folder", required=True)
    gi.add_argument("--out-json", default="invalid_ids.json")
    args = p.parse_args(argv)

    if args.cmd == "make-npy":
        print(make_npy(args.annotation_file, args.out_dir, args.num_tokens, args.feature_dim))
    elif args.cmd == "check-timestamps":
        print(json.dumps(check_timestamps(args.annotation_files), indent=2))
    else:
        ids = get_invalid_ids(args.annotation_files, args.video_folder, args.out_json)
        print(f"{len(ids)} invalid ids -> {args.out_json}")


if __name__ == "__main__":
    main()
