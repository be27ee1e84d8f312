"""The port's reference-checkpoint bridge (``utils/ref_bridge.py``) against
the JAX package's ``utils/ref_bridge.py``, and the port's CLIs through it,
on the CPU at ``__graft_entry__._small_cfg`` dims.

Seeded values on JAX's parameter trees (shapes from ``jax.eval_shape`` of
the model's init, values from a numpy seed) go into the port's model
through ``utils.weights.load_flax_params``. Every comparison is bit for bit,
since the bridge only moves data: the port's export equals JAX's
``transplant`` (keys, dtypes, shapes, values); the port's import of a
``.pth`` that JAX's ``transplant`` wrote equals JAX's
``load_reference_checkpoint`` of it, leaf for leaf and leftover for
leftover, with the encoder aux loss and the context mask on and off;
mismatched, non-flagship and untrusted files are refused where JAX
refuses them. Then the training, inference and serving CLIs from a
``.pth`` the port wrote, against ``--weights`` of the same parameters, and
the export tool on a CLI checkpoint."""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli import DIMS, overrides, world  # noqa: F401 (fixture)
from test_torch_common import (VOCAB_SIZE, array_batch, family_cfg, flatten_params,
                               small_vocab, torch_cfg_like)

from multimodal_feature_learning_tpu_torch import inference, serve
from multimodal_feature_learning_tpu_torch import main as port_main
from multimodal_feature_learning_tpu_torch.config import Config, apply_overrides, load_config
from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
from multimodal_feature_learning_tpu_torch.engine.state import create_train_state, save_checkpoint
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.models.dvc import build_model
from multimodal_feature_learning_tpu_torch.tools import export_to_reference
from multimodal_feature_learning_tpu_torch.utils import ref_bridge
from multimodal_feature_learning_tpu_torch.utils.weights import (export_flax_params,
                                                                 load_flax_params)

CASES = [(aux, mask) for aux in (False, True) for mask in (False, True)]
CASE_IDS = [f"aux_{'on' if a else 'off'}-mask_{'on' if m else 'off'}" for a, m in CASES]
PE = "unimodal_caption_decoder.positional_encoding.pe"


class Extra:
    """A non-tensor entry of a checkpoint, as the reference's ConfigDict."""

    def __init__(self, lr):
        self.lr = lr


def jax_cfg(aux=False, mask=False, family="sparse", ff_dim=128):
    """A JAX config at ``_small_cfg`` dims: the flagship ("sparse"), or
    "dense", "mm" (``family_cfg``) or "regular" (both family flags off)."""
    from multimodal_feature_learning_tpu.config import recompute_losses

    jcfg = family_cfg("sparse" if family == "regular" else family, mask)
    if family == "regular":
        jcfg.dvc.use_sparse_detr = jcfg.dvc.use_deformable_detr = False
        jcfg.dvc.decoder.depth = 2
        recompute_losses(jcfg)
    jcfg.dvc.detr.use_enc_aux_loss = aux
    jcfg.dvc.detr.transformer_ff_dim = ff_dim
    return jcfg


@functools.lru_cache(maxsize=None)
def jax_params(aux=False, mask=False, seed=0, family="sparse", ff_dim=128,
               vocab_size=VOCAB_SIZE):
    """JAX's params tree of the family at these settings: the shapes of its
    init (``jax.eval_shape``), values from numpy seed ``seed``."""
    from multimodal_feature_learning_tpu.models import build_model_and_criterion as jax_build

    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    jcfg = jax_cfg(aux, mask, family, ff_dim)
    vocab = Vocab(small_vocab().itos + [f"x{i}" for i in range(vocab_size - VOCAB_SIZE)])
    model = jax_build(jcfg, vocab)[0]
    batch = {k: jnp.asarray(v) for k, v in array_batch(torch_cfg_like(jcfg), 2).items()}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


def port_model(params, aux=False, mask=False, family="sparse", ff_dim=128,
               vocab_size=VOCAB_SIZE):
    """(model, port config) of the family on the CPU carrying ``params``."""
    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    tcfg = torch_cfg_like(jax_cfg(aux, mask, family, ff_dim))
    vocab = Vocab(small_vocab().itos + [f"x{i}" for i in range(vocab_size - VOCAB_SIZE)])
    model = build_model_and_criterion(tcfg, vocab, device="cpu")[0]
    load_flax_params(model, flatten_params(params))
    return model, tcfg


def transplant(aux, mask, seed=0, **kw):
    from multimodal_feature_learning_tpu.utils.ref_bridge import transplant

    return transplant(jax_params(aux, mask, seed, **kw), jax_cfg(aux, mask, **kw))


def assert_flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def state_copy(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def assert_state_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- the bridge against JAX's ------------------------------------------------


@pytest.mark.parametrize("aux,mask", CASES, ids=CASE_IDS)
def test_export_equals_jax_transplant(aux, mask):
    model, tcfg = port_model(jax_params(aux, mask), aux, mask)
    want = transplant(aux, mask)
    got = ref_bridge.reference_state_dict(model, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    # the aliased encoder heads are their own tensors, as JAX's
    if aux:
        alias = "unimodal_sparse_transformer.encoder.count_head.weight"
        assert got[alias].data_ptr() != got["count_head_encoder.weight"].data_ptr()


@pytest.mark.parametrize("aux,mask", CASES, ids=CASE_IDS)
def test_import_equals_jax_load(aux, mask, tmp_path):
    from multimodal_feature_learning_tpu.utils.ref_bridge import load_reference_checkpoint

    path = str(tmp_path / "ref.pth")
    torch.save({"model": transplant(aux, mask), "epoch": 3}, path)
    model, tcfg = port_model(jax_params(aux, mask, seed=1), aux, mask)
    leftover = ref_bridge.load_reference_checkpoint(path, model, tcfg)
    want, want_leftover = load_reference_checkpoint(path, jax_params(aux, mask, seed=1),
                                                    jax_cfg(aux, mask))
    assert leftover == want_leftover == []
    got = export_flax_params(model)
    assert_flat_equal(got, flatten_params(want))
    assert_flat_equal(got, flatten_params(jax_params(aux, mask)))


def test_reference_only_keys_are_left_over_as_jax_leaves_them(tmp_path):
    """A file as the reference writes it (the encoder aux heads, which its
    model always holds, both names; its positional encoding buffer; a
    context mask) into a model without the aux heads or a context mask."""
    from multimodal_feature_learning_tpu.utils.ref_bridge import import_reference_state_dict

    sd = transplant(True, True)
    sd[PE] = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 8, 64)))
    model, tcfg = port_model(jax_params(seed=1))
    leftover = ref_bridge.import_reference_state_dict(sd, model, tcfg)
    want, want_leftover = import_reference_state_dict(sd, jax_params(seed=1), jax_cfg())
    assert leftover == want_leftover
    heads = ("segment_embedding_encoder.", "count_head_encoder.",
             "unimodal_sparse_transformer.encoder.segment_embedding.",
             "unimodal_sparse_transformer.encoder.count_head.")
    assert len(leftover) == 16 and all(k.startswith(heads) for k in leftover)
    assert_flat_equal(export_flax_params(model), flatten_params(want))


def test_context_mask_stays_when_the_file_lacks_it():
    from multimodal_feature_learning_tpu.utils.ref_bridge import import_reference_state_dict

    sd = {k: v for k, v in transplant(False, True).items()
          if not k.startswith("context_mask_model.")}
    model, tcfg = port_model(jax_params(mask=True, seed=1), mask=True)
    before = {k: v.clone() for k, v in model.context_mask.state_dict().items()}
    assert ref_bridge.import_reference_state_dict(sd, model, tcfg) == []
    assert_state_equal(model.context_mask.state_dict(), before)
    want, _ = import_reference_state_dict(sd, jax_params(mask=True, seed=1), jax_cfg(mask=True))
    assert_flat_equal(export_flax_params(model), flatten_params(want))


@pytest.mark.parametrize("what,leaf", [("ff_dim", "linear1"), ("vocab", "embed")])
def test_mismatched_file_is_refused_and_the_model_untouched(what, leaf):
    from multimodal_feature_learning_tpu.utils.ref_bridge import import_reference_state_dict

    kw = {"ff_dim": 64} if what == "ff_dim" else {"vocab_size": VOCAB_SIZE + 1}
    sd = transplant(False, False)
    model, tcfg = port_model(jax_params(seed=1, **kw), **kw)
    before = state_copy(model)
    with pytest.raises(ValueError, match="does not match") as err:
        ref_bridge.import_reference_state_dict(sd, model, tcfg)
    assert leaf in str(err.value)
    assert_state_equal(state_copy(model), before)
    with pytest.raises(ValueError, match="does not match"):
        import_reference_state_dict(sd, jax_params(seed=1, **kw), jax_cfg())


@pytest.mark.parametrize("family", ["dense", "mm", "regular"])
def test_other_families_are_refused_where_jax_refuses(family):
    from multimodal_feature_learning_tpu.utils.ref_bridge import import_reference_state_dict

    sd = transplant(False, False)
    with pytest.raises(Exception):
        import_reference_state_dict(sd, jax_params(family=family), jax_cfg(family=family))
    model, tcfg = port_model(jax_params(family=family), family=family)
    before = state_copy(model)
    with pytest.raises(ValueError, match="UnimodalSparseDVC"):
        ref_bridge.import_reference_state_dict(sd, model, tcfg)
    with pytest.raises(ValueError, match="UnimodalSparseDVC"):
        ref_bridge.reference_state_dict(model, tcfg)
    assert_state_equal(state_copy(model), before)


def test_untrusted_pickle_refused_then_loaded_with_trust(tmp_path):
    from multimodal_feature_learning_tpu.utils.ref_bridge import load_reference_checkpoint

    path = str(tmp_path / "pickled.pth")
    torch.save({"model": transplant(False, False), "config": Extra(1e-4)}, path)
    model, tcfg = port_model(jax_params(seed=1))
    before = state_copy(model)
    with pytest.raises(ValueError, match="--trust-checkpoint"):
        ref_bridge.load_reference_checkpoint(path, model, tcfg)
    with pytest.raises(ValueError, match="--trust-checkpoint"):
        load_reference_checkpoint(path, jax_params(seed=1), jax_cfg())
    assert_state_equal(state_copy(model), before)
    assert ref_bridge.load_reference_checkpoint(path, model, tcfg, trust_pickle=True) == []
    want, _ = load_reference_checkpoint(path, jax_params(seed=1), jax_cfg(), trust_pickle=True)
    assert_flat_equal(export_flax_params(model), flatten_params(want))


def test_bare_state_dict_loads(tmp_path):
    from multimodal_feature_learning_tpu.utils.ref_bridge import load_reference_checkpoint

    path = str(tmp_path / "bare.pth")
    torch.save(transplant(True, False), path)
    model, tcfg = port_model(jax_params(aux=True, seed=1), aux=True)
    assert ref_bridge.load_reference_checkpoint(path, model, tcfg) == []
    want, _ = load_reference_checkpoint(path, jax_params(aux=True, seed=1), jax_cfg(aux=True))
    assert_flat_equal(export_flax_params(model), flatten_params(want))


# -- the CLIs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def sources(world):  # noqa: F811
    """(weights .npz, reference .pth) of one seeded, perturbed model at the
    CLI world's dims and vocab."""
    cfg = apply_overrides(Config(), DIMS + world[1])
    _, vocab = build_dataset("val", cfg)
    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device="cpu", seed=5)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.2, p.shape).astype(np.float32)))
    npz, pth = str(world[0] / "ref_src.npz"), str(world[0] / "ref_src.pth")
    np.savez(npz, **export_flax_params(model))
    torch.save({"model": ref_bridge.reference_state_dict(model, cfg), "epoch": 0}, pth)
    return npz, pth


def test_inference_from_reference_equals_weights(world, sources, capsys):  # noqa: F811
    npz, pth = sources
    runs = []
    for flag, path in (("--weights", npz), ("--from-reference-checkpoint", pth)):
        runs.append(inference.main(["--device", "cpu", flag, path, "--val-mode", "one_by_one",
                                    "--batch-size", "4", *overrides(
                                        world, f"submission_dir={world[0] / 'ref_inf'}")]))
    assert f"imported reference checkpoint {pth} (0 reference-only keys skipped)" \
        in capsys.readouterr().out
    (stats_w, sub_w, scores_w), (stats_r, sub_r, scores_r) = runs
    assert len(sub_r["results"]) == 4
    assert sub_r["results"] == sub_w["results"] and stats_r == stats_w and scores_r == scores_w


def test_training_from_reference_with_bf16_masters(world, sources):  # noqa: F811
    npz, pth = sources
    ckpts, runs = [], []
    for flag, path, out in (("--weights", npz, "ref_train_w"),
                            ("--from-reference-checkpoint", pth, "ref_train_r")):
        out = str(world[0] / out)
        runs.append(port_main.main(["--device", "cpu", flag, path, "--epochs", "1",
                                    "--batch-size", "8", "--output-dir", out,
                                    *overrides(world, "master_dtype=bfloat16")]))
        ckpts.append(torch.load(os.path.join(out, "checkpoint"), weights_only=True))
    assert_state_equal(ckpts[1]["model"], ckpts[0]["model"])
    assert {v.dtype for v in ckpts[1]["model"].values()} == {torch.bfloat16}
    assert runs[1]["epochs"] == runs[0]["epochs"]
    assert all(np.isfinite(v) for k, v in runs[1]["epochs"][0].items() if k != "epoch")


def test_serve_from_reference(world, sources, capsys):  # noqa: F811
    row = serve.main(["--device", "cpu", "--from-reference-checkpoint", sources[1],
                      "--n-requests", "6", "--rps", "500", "--batch-size", "2",
                      *overrides(world)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    assert row["requests"] == 6 and row["shed"] == 0


def test_weights_beside_reference_is_refused(world, sources):  # noqa: F811
    both = ["--device", "cpu", "--weights", sources[0], "--from-reference-checkpoint",
            sources[1], *overrides(world)]
    for entry in (port_main.main, inference.main, serve.main):
        with pytest.raises(SystemExit, match="--weights and --from-reference-checkpoint"):
            entry(both)


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_export_tool_round_trips_a_cli_checkpoint(world, sources, master_dtype,  # noqa: F811
                                                  tmp_path, capsys):
    """A checkpoint of the training CLI (f32 or bf16 masters) through the
    export tool: a ``weights_only`` file with the checkpoint's epoch, f32
    tensors (as JAX's tool restores onto an f32 template), that imports
    back to the checkpoint's values, widened to f32, bit for bit. Then
    ``inference --resume`` replaces an imported file, as in JAX."""
    cfg = apply_overrides(load_config(), DIMS + world[1])
    cfg.master_dtype = master_dtype
    _, vocab = build_dataset("val", cfg)
    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device="cpu", seed=9)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    save_checkpoint(str(tmp_path), state, epoch=7)
    ckpt, pth = str(tmp_path / "checkpoint"), str(tmp_path / "exported.pth")
    done = export_to_reference.main(["--device", "cpu", "--resume", ckpt, "--out", pth,
                                     *overrides(world)])
    assert f"exported {ckpt} (epoch 7) -> {pth}: {done['tensors']} tensors" \
        in capsys.readouterr().out
    exported = torch.load(pth, weights_only=True)
    assert exported["epoch"] == 7 and {v.dtype for v in exported["model"].values()} == {
        torch.float32}
    fresh = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device="cpu", seed=10)
    assert ref_bridge.import_reference_state_dict(exported["model"], fresh, cfg) == []
    assert_state_equal(state_copy(fresh), {k: v.float() for k, v in model.state_dict().items()})
    # --resume replaces an imported file (JAX inference.py's order)
    args = ["--device", "cpu", "--batch-size", "4",
            *overrides(world, f"submission_dir={tmp_path / 'sub'}")]
    resumed = inference.main(["--resume", ckpt, *args])
    both = inference.main(["--from-reference-checkpoint", sources[1], "--resume", ckpt, *args])
    assert both[0] == resumed[0] and both[1]["results"] == resumed[1]["results"]
