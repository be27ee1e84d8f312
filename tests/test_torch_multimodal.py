"""The video + audio family of the port (``models/multimodal.py``,
``models/backbones.py``) against the JAX package's ``MultimodalDVC``, and
the audio path of its data layer against JAX's.

At ``_small_cfg`` dims with audio_rescale_len 12 (as
``tests/test_multimodal.py::mm_cfg``), f32 on the CPU, every dropout rate 0,
the same flax params on both sides (carried by ``utils.weights``) and the
same synthetic batch (numpy seed 0, audio features included). Two
variants cover sparse and dense, the BiModalEncoder on and off and the
differentiable context masks on and off. JAX's train forward runs compiled, its ``forward_eval`` eagerly, as
``test_torch_eval.py`` runs it (XLA's compiled eval moves JAX's own
log-probabilities by up to 1.7e-4 at these dims). The tolerances are those
the sparse family's files hold for the same quantities:

- training (``forward_train`` + criterion): matchings equal, loss terms rel
  1e-5 (atol 1e-6), gradient leaves atol 2e-4 x max |g_leaf| (the key
  biases, whose exact gradient is 0, under 1e-5 x the kernel's), as
  ``test_torch_train.py``;
- ``forward_eval``: matchings, crop masks and captions (greedy, greedy with
  faster_eval, beam) equal and segments atol 1e-5, as
  ``test_torch_eval.py``; the teacher-forced log-probabilities of every
  caption layer atol 2e-4, twice that file's 1e-4. The two sides' f32
  memories differ by about as much as the unimodal trunk's (1.0-1.3e-5 of
  their max, against 0.9e-5), but the multimodal caption layers, with a
  cross-attention into each cropped memory and the concat bridge, carry
  that to up to 1.2e-4 in the log-probabilities (about 6e-6 relative to
  their largest magnitude, 11), where the unimodal decoder ends at 3e-5;
  the errors are spread over every position of the rows, and no
  context-mask logit changes sign.
The audio collate and loader are held against JAX's in
``test_torch_data.py``, the training CLI on this family in
``test_torch_cli.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_cli_drivers import TINY
from test_torch_common import (
    LOGP_ATOL, VOCAB_SIZE, array_batch, assert_grads_match, assert_losses_match,
    build_jax_family, build_port_family, family_cfg, flatten_params, jax_losses_and_grads,
    no_dropout, port_losses_and_grads, small_vocab, torch_cfg_like,
)

from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device, make_train_step
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

MM_LOGP_ATOL = 2 * LOGP_ATOL

# (family, differentiable mask, BiModalEncoder, the val_modes held against
# JAX): between them sparse and dense, each flag on and off
VARIANTS = {
    # config #3 as the JAX package trained it (tools/run_family_convergence.sh)
    "sparse_bimodal_cropmask": ("mm", False, True, ("one_by_one",)),
    "dense_ctxmask": ("mm_dense", True, False, ("one_by_one", "one_by_one_faster",
                                                "teacher_forcing", "beam3")),
}
MODES = {
    "one_by_one": ("one_by_one", {}),
    "one_by_one_faster": ("one_by_one", {"faster_eval": True}),
    "teacher_forcing": ("teacher_forcing", {}),
    "beam3": ("beam", {"beam_size": 3}),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """(name, jax cfg, jax model, flax params, port model, criterion,
    weight_dict, numpy batch, port batch, JAX's and the port's training
    forward)."""
    family, mask, bimodal, _ = VARIANTS[request.param]
    jcfg = no_dropout(family_cfg(family, mask, bimodal))
    jmodel, params = build_jax_family(jcfg)
    model, criterion, weight_dict = build_port_family(jcfg, params)
    batch = array_batch(torch_cfg_like(jcfg), 2)
    tb = batch_to_device(batch, "cpu")
    trained = (jax_losses_and_grads(jcfg, jmodel, params, batch),
               port_losses_and_grads(model, criterion, weight_dict, tb))
    return (request.param, jcfg, jmodel, params, model, criterion, weight_dict, batch, tb,
            trained)


def test_tree_matches_the_variant(variant):
    """The trees that exist are the variant's: the BiModalEncoder's, the
    context masks', and the per-modality saliency net only when sparse
    (flax creates it only when it runs), never the unused reference-point
    head of the per-modality preparation."""
    name, jcfg, _, params, model, *_ = variant
    assert ("bimodal" in params) == jcfg.dvc.use_bimodal_encoder == hasattr(model, "bimodal")
    assert ("video_context_mask" in params) == jcfg.use_differentiable_mask
    flat = flatten_params(params)
    sparse = jcfg.dvc.use_sparse_detr
    assert any("video_prep||enc_mask_predictor" in k for k in flat) == sparse
    assert any("audio_prep||enc_output" in k for k in flat) == sparse
    assert not any("video_prep||reference_points_head" in k for k in flat)


def test_train_matchings_losses_and_gradients_match_jax(variant):
    *_, trained = variant
    (ridx, raux, rloss, rgrad), (gidx, gaux, gloss, ggrad) = trained
    np.testing.assert_array_equal(gidx, ridx)
    np.testing.assert_array_equal(gaux, raux)
    assert_losses_match(rloss, gloss)
    assert ("loss_mask_prediction" in gloss) == variant[1].dvc.use_sparse_detr
    assert ("loss_context" in gloss) == variant[1].use_differentiable_mask
    assert assert_grads_match(rgrad, ggrad) > 0.85 * len(rgrad)


def test_forward_eval_matches_jax(variant):
    name, _, jmodel, params, model, _, _, batch, tb, _ = variant
    for case in VARIANTS[name][3]:
        mode, kw = MODES[case]
        rout, rcap, ridx, raux, rmask = jmodel.forward_eval(params, batch, mode, **kw)
        gout, gcap, gidx, gaux, gmask = model.forward_eval(tb, mode, **kw)
        np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx), err_msg=case)
        np.testing.assert_array_equal(gaux.numpy(), np.asarray(raux), err_msg=case)
        for g, r in zip(gmask, rmask):  # the video and the audio crop masks
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=case)
        np.testing.assert_allclose(gout["pred_segments"].numpy(),
                                   np.asarray(rout["pred_segments"]), rtol=0, atol=1e-5)
        assert gcap.shape == np.asarray(rcap).shape, case
        np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap), err_msg=case)
        assert len({tuple(r) for r in gcap.tolist()}) > 1  # not a degenerate decode
        np.testing.assert_allclose(gout["pred_captions"].numpy(),
                                   np.asarray(rout["pred_captions"]), rtol=0, atol=MM_LOGP_ATOL)
        assert len(gout["aux_outputs_caption"]) == len(rout["aux_outputs_caption"]) > 0
        for g, r in zip(gout["aux_outputs_caption"], rout["aux_outputs_caption"]):
            np.testing.assert_allclose(g["pred_captions"].numpy(),
                                       np.asarray(r["pred_captions"]), rtol=0, atol=MM_LOGP_ATOL)


def test_train_step_through_the_family_builder(variant):
    """``make_train_step`` of a model from ``build_model_and_criterion``
    gives JAX's loss terms at the shared start, and a finite update."""
    name, jcfg, _, params, *_, tb, trained = variant
    (_, _, rloss, _), _ = trained
    tcfg = torch_cfg_like(jcfg)
    model, criterion, weight_dict = build_model_and_criterion(tcfg, small_vocab(),
                                                              device="cpu")
    load_flax_params(model, flatten_params(params))
    state = create_train_state(tcfg, model, 10)
    metrics = make_train_step(criterion, weight_dict, seed=0)(state, tb)
    for k, v in rloss.items():
        assert abs(float(metrics[k]) - v) <= max(1e-5 * abs(v), 1e-6), k
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_compute_dtype_is_ignored_as_in_jax():
    """JAX's MultimodalDVC never reads compute_dtype: a model built with
    "bfloat16" computes in f32 and gives the f32 model's outputs exactly
    (both from the same seed)."""
    tcfg = torch_cfg_like(no_dropout(family_cfg("mm")))
    tb = batch_to_device(array_batch(tcfg, 2), "cpu")
    ref_model, _, _ = build_model_and_criterion(tcfg, small_vocab(), device="cpu", seed=3)
    tcfg.compute_dtype = "bfloat16"
    bf16, _, _ = build_model_and_criterion(tcfg, small_vocab(), device="cpu", seed=3)
    got, ref = bf16.forward_eval(tb, "one_by_one"), ref_model.forward_eval(tb, "one_by_one")
    assert got[0]["video_memory"].dtype == torch.float32
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0]["pred_captions"], ref[0]["pred_captions"])


# -- the entry points --------------------------------------------------------

DIMS = [o for o in TINY if not o.startswith(("eval_rate", "checkpoint_rate", "print_freq"))]
MM = ["dvc.input_modalities=video,audio", "dataset.activity_net.audio_rescale_len=12"]


def test_unported_paths_raise(tmp_path, monkeypatch):
    """Raw ingest builds ``RawMultimodalDVC``; the serving and inference
    entry points, which build the unimodal model (as JAX's), point a
    two-modality config, a raw one and the regular family to ``main.py
    --mode eval``."""
    from multimodal_feature_learning_tpu_torch import inference, serve
    from multimodal_feature_learning_tpu_torch.models.multimodal import (
        RawMultimodalDVC, build_multimodal_model)

    tcfg = torch_cfg_like(family_cfg("mm"))
    tcfg.use_raw_videos = True
    tcfg.dvc.vivit.num_heads = tcfg.dvc.ast.num_heads = 8
    assert isinstance(build_multimodal_model(tcfg, VOCAB_SIZE, device="cpu"), RawMultimodalDVC)
    monkeypatch.chdir(tmp_path)
    for extra in (MM, ["use_raw_videos=true"],
                  ["dvc.use_sparse_detr=false", "dvc.use_deformable_detr=false"]):
        for entry in (inference.main, serve.main):
            with pytest.raises(ValueError, match="--mode eval"):
                entry(["--synthetic", "--device", "cpu", "--config-overrides", *DIMS, *extra])
