#!/usr/bin/env python3
"""Convert an h5 feature file into a directory of ``<video key>.npy``.

The JAX package reads video (and audio) features from an h5 file, one
dataset of shape (num_tokens, feature_dim) per video key, through h5py; the
PyTorch port reads the same features from a directory of ``<key>.npy``
arrays and has no h5py. Run this where h5py is installed:

    python tools/h5_to_npy.py features.h5 features_npy/ [--dtype float32]

Each dataset is written as it is stored (or cast to ``--dtype``), one file a
key, in the file's order; existing files are overwritten. Then point the
port's ``dataset.activity_net.video_features_file`` (or
``audio_features_file``) at the directory.
"""

from __future__ import annotations

import argparse
import os
import sys


def convert(h5_path: str, out_dir: str, dtype: str = "") -> int:
    """Write every dataset of ``h5_path`` to ``out_dir/<key>.npy``; returns
    the number of files written."""
    import h5py
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with h5py.File(h5_path, "r") as h5:
        for key in h5:
            arr = np.asarray(h5[key])
            if dtype:
                arr = arr.astype(dtype)
            np.save(os.path.join(out_dir, f"{key}.npy"), arr)
            n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("h5_path")
    p.add_argument("out_dir")
    p.add_argument("--dtype", default="", help="cast each array (e.g. float32)")
    args = p.parse_args(argv)
    n = convert(args.h5_path, args.out_dir, args.dtype)
    print(f"{n} arrays -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
