"""The dense deformable family of the port (``dvc.use_sparse_detr=False``,
``dvc.use_deformable_detr=True``: every token a query, a class head) against
the JAX package's ``UnimodalDVC`` of the same family.

At ``_small_cfg`` dims, f32 on the CPU, every dropout rate 0, the same flax
params on both sides (carried by ``utils.weights``) and the same synthetic
batch (numpy seed 0). The tolerances are those the sparse family's files
hold for the same quantities:

- training (``forward_train`` + criterion, the model built by
  ``models.build_model_and_criterion``): matchings equal, loss terms rel
  1e-5 (atol 1e-6), gradient leaves atol 2e-4 x max |g_leaf| (the key
  biases, whose exact gradient is 0, under 1e-5 x the kernel's), as
  ``test_torch_train.py``; the class head gets no gradient on either side;
  one ``make_train_step`` of the port against optax's update of JAX's
  gradients: within 1e-6 + 2 lr x min(1, dg / |g|) and 1.01 lr;
JAX's side runs compiled (``jax.jit``), as its train and eval steps do.

- ``forward_eval`` in every val_mode: matchings and captions equal,
  teacher-forced log-probabilities atol 1e-4, segments atol 1e-5, as
  ``test_torch_eval.py``;
- ``forward_serve`` with ``rank="class"`` (1 - p(no-object)), plain-op and
  fused (JAX's Pallas kernel in interpret mode): segments atol 1e-5 of the
  duration, scores atol 1e-4, k and captions equal, as
  ``test_torch_serve.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, GRAD_REL, LOGP_ATOL, LOSS_ATOL, LOSS_REL, PAD, SHIFT_FREE, VOCAB_SIZE,
    array_batch, assert_grads_match, assert_losses_match, build_jax_family, build_port_family,
    family_cfg, flatten_params, jax_losses_and_grads, no_dropout, port_losses_and_grads,
    serve_inputs, small_vocab, torch_cfg_like,
)

from multimodal_feature_learning_tpu.engine.state import make_optimizer as jax_optimizer
from multimodal_feature_learning_tpu.models.criterion import build_weight_dict as jax_weights
from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device, make_train_step
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module")
def dense():
    """(jax cfg, jax model, flax params, port model, criterion, weight_dict,
    numpy batch, port batch): the dense family with the differentiable
    context mask, dropout off."""
    jcfg = no_dropout(family_cfg("dense"))
    jmodel, params = build_jax_family(jcfg)
    model, criterion, weight_dict = build_port_family(jcfg, params)
    batch = array_batch(torch_cfg_like(jcfg), 2)
    return jcfg, jmodel, params, model, criterion, weight_dict, batch, batch_to_device(batch,
                                                                                       "cpu")


@pytest.fixture(scope="module")
def trained(dense):
    jcfg, jmodel, params, model, criterion, weight_dict, batch, tb = dense
    return (jax_losses_and_grads(jcfg, jmodel, params, batch),
            port_losses_and_grads(model, criterion, weight_dict, tb))


def test_dense_tree_has_the_class_head_and_no_saliency_net(dense):
    """flax creates only what the dense forward calls: the class head, no
    encoder aux heads, no saliency net; the port's module has exactly those
    params (the strict load of the fixture) and the family's outputs."""
    _, _, params, model, _, _, _, tb = dense
    flat = flatten_params(params)
    assert any("class_embedding" in k for k in flat)
    for absent in ("enc_mask_predictor", "enc_output", "segment_embedding_encoder",
                   "count_head_encoder"):
        assert not any(absent in k for k in flat), absent
    out = model.proposal(tb["video_tensor"], tb["video_mask"], tb["durations"],
                         with_enc_aux=True)
    assert "backbone_topk_proposals" not in out and "aux_outputs_enc" not in out
    assert out["pred_logits"].shape == (2, model.num_queries, 201)
    torch.testing.assert_close(out["pred_logits"].sum(-1), torch.ones(2, model.num_queries))


def test_weight_dict_matches_jax(dense):
    """No encoder aux terms for the dense family; the sparse one has them."""
    jcfg, _, _, _, _, weight_dict, _, _ = dense
    assert weight_dict == jax_weights(jcfg)
    assert not any("_enc_" in k for k in weight_dict)
    assert "mask_prediction" not in jcfg.dvc.losses


def test_train_matchings_and_losses_match_jax(trained):
    (ridx, raux, rloss, _), (gidx, gaux, gloss, _) = trained
    np.testing.assert_array_equal(gidx, ridx)
    np.testing.assert_array_equal(gaux, raux)
    assert_losses_match(rloss, gloss)
    assert not any("_enc_" in k or "mask_prediction" in k for k in gloss)


def test_train_gradients_match_jax(trained):
    (*_, rgrad), (*_, ggrad) = trained
    nonzero = assert_grads_match(rgrad, ggrad)
    assert nonzero > 0.85 * len(rgrad)
    for k in rgrad:
        if "class_embedding" in k:  # no loss reads the class head
            assert not np.abs(rgrad[k]).any() and not np.abs(ggrad[k]).any(), k


def test_train_step_through_the_family_builder_matches_jax(dense, trained):
    """One ``make_train_step`` of a model from ``build_model_and_criterion``
    against optax's update of JAX's gradients from the same params."""
    import optax

    jcfg, _, params, _, _, _, batch, tb = dense
    (_, _, rloss, rgrad), _ = trained
    tcfg = torch_cfg_like(jcfg)
    model, criterion, weight_dict = build_model_and_criterion(tcfg, small_vocab(),
                                                              device="cpu")
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    load_flax_params(model, flatten_params(params))
    state = create_train_state(tcfg, model, STEPS_PER_EPOCH)
    metrics = make_train_step(criterion, weight_dict, seed=0)(state, tb)
    for k, v in rloss.items():
        assert abs(float(metrics[k]) - v) <= max(LOSS_REL * abs(v), LOSS_ATOL), k

    tx = jax_optimizer(jcfg, STEPS_PER_EPOCH)
    jparams = jax.tree_util.tree_map(np.asarray, params)
    jgrads = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [rgrad[k] for k in flatten_params(jparams)]))
    @jax.jit
    def update(g, p):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    ref = flatten_params(update(jgrads, jparams))
    got = export_flax_params(model)
    lr = tcfg.lr
    assert set(ref) == set(got)
    for k in ref:
        dg = GRAD_REL * float(np.abs(rgrad[k]).max())
        if k.endswith(SHIFT_FREE):
            dg = 2e-5 * float(np.abs(rgrad[k.replace("bias", "kernel")]).max())
        ratio = np.minimum(1.0, dg / np.maximum(np.abs(rgrad[k]), 1e-30))
        bound = np.minimum(1e-6 + 2 * lr * ratio, 1.01 * lr)
        assert (np.abs(got[k] - ref[k]) <= bound).all(), k


MODES = {
    "one_by_one": ("one_by_one", {}),
    "teacher_forcing": ("teacher_forcing", {}),
    "beam3": ("beam", {"beam_size": 3}),
    "serve": ("serve", {}),
}


@pytest.mark.parametrize("case", list(MODES))
def test_forward_eval_matches_jax(dense, case):
    _, jmodel, params, model, _, _, batch, tb = dense
    mode, kw = MODES[case]
    (rout, rcap, ridx, raux, rmask) = jax.jit(
        lambda p, b: jmodel.forward_eval(p, b, mode, **kw))(params, batch)
    (gout, gcap, gidx, gaux, gmask) = model.forward_eval(tb, mode, **kw)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    assert (gaux is None) == (raux is None)
    if raux is not None:
        np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
    np.testing.assert_allclose(gout["pred_segments"].numpy(),
                               np.asarray(rout["pred_segments"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap))
    assert len({tuple(r) for r in gcap.tolist()}) > 1  # not a degenerate decode
    for key in ("pred_captions", "aux_outputs", "aux_outputs_caption"):
        assert (key in gout) == (key in rout), key
    if "pred_captions" in rout:
        np.testing.assert_allclose(gout["pred_captions"].numpy(),
                                   np.asarray(rout["pred_captions"]), rtol=0, atol=LOGP_ATOL)


def assert_served_match(jcfg, ref, got, durations):
    dur = durations[:, None, None]
    np.testing.assert_allclose(got["segments"].numpy() / dur,
                               np.asarray(ref["segments"]) / dur, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["captions"].numpy(), np.asarray(ref["captions"]))


def test_forward_serve_rank_class_matches_jax(dense):
    """rank="class" takes the foreground probability of the class head: it
    differs from the stability ranking, and equals JAX's."""
    jcfg, jmodel, params, model, *_ = dense
    video, mask, durations = serve_inputs(jcfg)
    args = tuple(torch.from_numpy(a) for a in (video, mask, durations))
    got = model.forward_serve(*args, rank="class")
    ref = jax.jit(lambda p, *a: jmodel.forward_serve(p, *a, rank="class"))(
        params, video, mask, durations)
    assert_served_match(jcfg, ref, got, durations)
    out = model._propose(*args)
    expected = torch.sort(1.0 - out["pred_logits"][..., -1], dim=1, descending=True).values
    torch.testing.assert_close(got["scores"], expected[:, :model.max_gt])
    assert not torch.equal(got["scores"], model.forward_serve(*args)["scores"])


@pytest.mark.parametrize("grid", ["video", "batch"])
def test_forward_serve_fused_rank_class_matches_jax(dense, monkeypatch, grid):
    """The fused decode step on the dense family (JAX's Pallas kernel in
    interpret mode on the CPU)."""
    import multimodal_feature_learning_tpu.ops.fused_decode as jfd
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model

    jcfg, _, params, model, *_ = dense
    jcfg = no_dropout(family_cfg("dense"))
    jcfg.decode_impl, jcfg.decode_fused_grid = "fused", grid
    jmodel = jax_build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    orig = jfd.fused_decode_step
    monkeypatch.setattr(jfd, "fused_decode_step",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    video, mask, durations = serve_inputs(jcfg)
    ref = jax.jit(lambda p, *a: jmodel.forward_serve(p, *a, rank="class"))(
        params, video, mask, durations)
    model.decode_impl, model.decode_fused_grid = "fused", grid
    try:
        got = model.forward_serve(*(torch.from_numpy(a) for a in (video, mask, durations)),
                                  rank="class")
    finally:
        model.decode_impl, model.decode_fused_grid = "xla", "video"
    assert_served_match(jcfg, ref, got, durations)


def test_dense_bf16_runs_like_the_sparse_family(dense):
    """compute_dtype "bfloat16" is the same class's policy: bf16 copies of
    the masters in the forward, the matcher's outputs back in f32, the
    memory in bf16; the served segments and k stay finite and well formed."""
    jcfg, _, params, _, _, _, _, tb = dense
    tcfg = torch_cfg_like(jcfg)
    tcfg.compute_dtype = "bfloat16"
    model, _, _ = build_model_and_criterion(tcfg, small_vocab(), device="cpu")
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    load_flax_params(model, flatten_params(params))
    out = model.forward_eval(tb, "one_by_one")[0]
    assert out["pred_segments"].dtype == torch.float32
    assert out["pred_logits"].dtype == torch.float32
    assert out["memory"].dtype == torch.bfloat16
    video, mask, durations = serve_inputs(jcfg)
    served = model.forward_serve(*(torch.from_numpy(a) for a in (video, mask, durations)),
                                 rank="class")
    assert torch.isfinite(served["segments"]).all()
    assert ((served["k"] >= 1) & (served["k"] <= model.max_gt)).all()


def test_regular_family_and_glove_raise():
    """The regular family (both family flags off) is built by the family
    builder, not as a UnimodalDVC, which points it to ``main.py --mode
    eval``; a GloVe file is not ported (the builder names ROADMAP Queue 1
    item 9); a model with two input modalities is not a UnimodalDVC."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.models.regular_dvc import RegularDVC

    tcfg = torch_cfg_like(family_cfg("dense"))
    tcfg.dvc.use_deformable_detr = False
    model, _, _ = build_model_and_criterion(tcfg, small_vocab(), device="cpu")
    assert isinstance(model, RegularDVC)
    with pytest.raises(ValueError, match="regular family.*--mode eval"):
        build_model(tcfg, VOCAB_SIZE, device="cpu")
    tcfg = torch_cfg_like(family_cfg("dense"))
    tcfg.dvc.caption.glove_file_path = "glove.840B.300d.txt"
    with pytest.raises(NotImplementedError, match="item 9"):
        build_model_and_criterion(tcfg, small_vocab(), device="cpu")
    tcfg = torch_cfg_like(family_cfg("mm"))
    with pytest.raises(ValueError, match="--mode eval"):
        build_model(tcfg, VOCAB_SIZE, device="cpu")
