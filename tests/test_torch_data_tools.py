"""The port's data tooling (``utils/data_tools.py``) and the root
``tools/h5_to_npy.py`` converter against the JAX package's: an h5 feature
file written by JAX's ``make_h5`` and converted to ``.npy`` files reads the
same on every key through JAX's h5 backend and the port's ``.npy`` backend,
and the port's ``make-npy`` writes those arrays itself; ``check_timestamps``
and ``get_invalid_ids`` equal JAX's, through the functions and the CLIs.
All exact (copies of the same arrays; the same json and file listings)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multimodal_feature_learning_tpu.data.anet import FeatureBackend as JaxFeatureBackend
from multimodal_feature_learning_tpu.utils import data_tools as jdt
from multimodal_feature_learning_tpu_torch.data.anet import FeatureBackend
from multimodal_feature_learning_tpu_torch.utils import data_tools as tdt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ANN = {
    "v_a": {"duration": 10.0, "timestamps": [[0.0, 4.0], [3.0, 9.0]],
            "sentences": ["a man runs", "he stops"]},
    "v_b": {"duration": 20.0, "timestamps": [[5.0, 5.0], [2.0, 11.0], [12.0, 7.0]],
            "sentences": ["x", "y", "z"]},
    "v_c": {"duration": 8.0, "timestamps": [[1.0, 2.0]], "sentences": ["w"]},
}


def write_ann(tmp_path, name: str = "train.json", ann=ANN) -> str:
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def test_h5_converted_to_npy_reads_as_jax_s_h5(tmp_path):
    ann = write_ann(tmp_path)
    h5_path = jdt.make_h5(ann, str(tmp_path / "feats.h5"), num_tokens=16, feature_dim=8)
    out = tmp_path / "npy"
    done = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "h5_to_npy.py"),
                           h5_path, str(out)], capture_output=True, text=True, check=True)
    assert done.stdout.strip() == f"3 arrays -> {out}"
    jax_fb, port_fb = JaxFeatureBackend(h5_path, feature_dim=8), FeatureBackend(str(out), 8)
    for key in ANN:
        assert key in port_fb
        got, ref = port_fb.get(key), jax_fb.get(key)
        assert got.dtype == ref.dtype == np.float32 and got.shape == (16, 8)
        np.testing.assert_array_equal(got, ref)
    assert "v_z" not in port_fb
    # the port's make-npy writes the same arrays without h5py
    own = tdt.make_npy(ann, str(tmp_path / "own"), num_tokens=16, feature_dim=8)
    assert sorted(os.listdir(own)) == sorted(os.listdir(out))
    for key in ANN:
        np.testing.assert_array_equal(FeatureBackend(own, 8).get(key), jax_fb.get(key))


def test_h5_path_names_the_converter(tmp_path):
    with pytest.raises(ValueError, match="tools/h5_to_npy.py"):
        FeatureBackend(str(tmp_path / "features.h5"))


def test_check_timestamps_and_invalid_ids_equal_jax(tmp_path):
    files = [write_ann(tmp_path), write_ann(tmp_path, "val.json",
                                            {"v_d": {"duration": 3.0, "timestamps": [[2.0, 1.0]],
                                                     "sentences": ["q"]}})]
    got = tdt.check_timestamps(files)
    assert got == jdt.check_timestamps(files) == {"v_b": [[5.0, 5.0], [12.0, 7.0]],
                                                  "v_d": [[2.0, 1.0]]}
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("v_a.mp4", "v_v_c.mkv"):  # v_c's file carries JAX's "v_" prefix
        (videos / name).write_bytes(b"")
    tout, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got = tdt.get_invalid_ids(files, str(videos), tout)
    assert got == jdt.get_invalid_ids(files, str(videos), jout) == ["v_b", "v_d"]
    with open(tout) as f, open(jout) as g:
        assert json.load(f) == json.load(g)
    assert tdt.get_invalid_ids(files, str(tmp_path / "none")) == list(ANN) + ["v_d"]


def test_cli_commands(tmp_path, capsys):
    ann = write_ann(tmp_path)
    tdt.main(["check-timestamps", ann])
    assert json.loads(capsys.readouterr().out) == jdt.check_timestamps([ann])
    out_json = str(tmp_path / "invalid.json")
    tdt.main(["get-invalid-ids", ann, "--video-folder", str(tmp_path), "--out-json", out_json])
    assert capsys.readouterr().out.strip() == f"3 invalid ids -> {out_json}"
    tdt.main(["make-npy", ann, str(tmp_path / "feats"), "--num-tokens", "4",
              "--feature-dim", "3"])
    assert capsys.readouterr().out.strip() == str(tmp_path / "feats")
    assert np.load(tmp_path / "feats" / "v_c.npy").shape == (4, 3)
