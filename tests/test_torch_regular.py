"""The regular family of the port (``models/regular_dvc.py``: a vanilla
query decoder over the frame features, or over its own ViViT on raw frames;
BASELINE config #4) against the JAX package's ``RegularDVC``.

Two variants: on features at ``_small_cfg`` dims with two decoder layers
and the differentiable context mask (``tests/test_regular_family.py``'s
``reg_cfg``), and on raw uint8 frames at ``tests/test_raw_end_to_end.py``'s
dims (d 32, one decoder layer, 4 frames of 32 x 32 from the synthetic
decoder, through the JAX raw dataset and collate). The same flax params (a
JAX init perturbed from a numpy seed) and the same numpy batch on both
sides. JAX's ``RegularProposalNet`` fixes its dropout at 0.1; for the
training comparison both sides run it at 0 (JAX's module cloned with
``dropout=0``, the port's ``Dropout`` layers at p = 0), which changes no
parameter. Tolerances as ``test_torch_multimodal.py``: matchings equal,
loss terms rel 1e-5, gradient leaves atol 2e-4 x max |g_leaf| (JAX's
train forward compiled); in ``forward_eval`` (JAX eager) matchings, crop
masks and captions equal, log-probabilities atol 1e-4, segments atol 3e-5
and count logits within 1e-5 of their largest. The last two are wider than
the deformable families' 1e-5: the perturbed weights make the post-norm
query decoder's attention sharp, and the query features of its second
layer differ by 4.6e-6 of their largest (1.7e-5 of 3.7; the first layer's
by 1e-6), which reaches the segments as 1.05e-5 and the count logits as
2.1e-5 of 5.2 (measured; a flax-style LayerNorm in the port moves these by
less than 1e-6)."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, LOGP_ATOL, PAD, SHIFT_FREE, VOCAB_SIZE, array_batch, assert_grads_match,
    assert_losses_match, flatten_params, jax_losses_and_grads, jax_small_cfg, perturb,
    port_losses_and_grads, small_vocab, torch_cfg_like,
)

from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.models.layers import Dropout
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

RAW_ANN = {  # tests/test_raw_end_to_end.py's annotations
    f"v_{i}": {"duration": 10.0 + i, "timestamps": [[1.0, 4.0 + i], [5.0, 9.0]],
               "sentences": ["a man is running", "the dog jumps high"]}
    for i in range(2)
}
MODES = {
    "one_by_one": ("one_by_one", {}),
    "one_by_one_faster": ("one_by_one", {"faster_eval": True}),
    "teacher_forcing": ("teacher_forcing", {}),
    "beam3": ("beam", {"beam_size": 3}),
}
VARIANTS = {"features_ctxmask": tuple(MODES), "raw": ("one_by_one", "beam3")}
SEG_ATOL, COUNT_REL = 3e-5, 1e-5


def regular_cfg(raw: bool):
    from multimodal_feature_learning_tpu.config import recompute_losses

    jcfg = jax_small_cfg(use_differentiable_mask=not raw)
    jcfg.dvc.use_sparse_detr = jcfg.dvc.use_deformable_detr = False
    jcfg.dvc.decoder.depth = 2
    if raw:  # tests/test_raw_end_to_end.py
        jcfg.use_raw_videos = True
        jcfg.dvc.d_model = jcfg.dvc.caption.d_model = 32
        jcfg.dvc.num_queries = 4
        jcfg.dvc.decoder.depth = 1
        anet = jcfg.dataset.activity_net
        anet.video_rescale_len, anet.max_caption_len_all, anet.max_gt_target_segments = 4, 8, 3
    recompute_losses(jcfg)
    return jcfg


def raw_world(tmp_path):
    """(JAX's collated raw batch, the vocab's size) of RAW_ANN."""
    from multimodal_feature_learning_tpu.data.raw_anet import (RawActivityNetDataset,
                                                              collate_raw, synthetic_decoder)
    from multimodal_feature_learning_tpu.data.vocab import build_vocab

    path = tmp_path / "ann.json"
    path.write_text(json.dumps(RAW_ANN))
    vocab = build_vocab(RAW_ANN, min_freq=1)
    ds = RawActivityNetDataset(str(path), synthetic_decoder(frame_size=32), vocab, False,
                               video_rescale_len=4, num_mel_bins=16, audio_target_length=8,
                               with_audio=False, max_gt_target_segments=3, max_caption_len=8)
    batch = collate_raw([ds[i] for i in range(len(ds))], vocab.pad_idx, max_gt=3,
                        max_caption_len=8)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def without_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, tmp_path_factory):
    from multimodal_feature_learning_tpu.models.regular_dvc import build_regular_model

    raw = request.param == "raw"
    jcfg = regular_cfg(raw)
    jmodel = build_regular_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    jmodel.proposal_net = jmodel.proposal_net.clone(dropout=0.0)
    tcfg = torch_cfg_like(jcfg)
    batch = raw_world(tmp_path_factory.mktemp("raw")) if raw else array_batch(tcfg, 2)
    params = perturb(jmodel.init(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in batch.items()}), 0)
    model, criterion, weight_dict = build_model_and_criterion(tcfg, small_vocab(), device="cpu")
    load_flax_params(model, flatten_params(params))
    without_dropout(model)
    tb = batch_to_device(batch, "cpu")
    trained = (jax_losses_and_grads(jcfg, jmodel, params, batch),
               port_losses_and_grads(model, criterion, weight_dict, tb))
    return request.param, jcfg, jmodel, params, model, batch, tb, trained


def test_tree_and_family(variant):
    from multimodal_feature_learning_tpu_torch.models.regular_dvc import RegularDVC

    name, jcfg, _, params, model, _, tb, _ = variant
    assert isinstance(model, RegularDVC)
    flat = flatten_params(params)
    assert any(k.startswith("proposal||params||backbone||") for k in flat) == (name == "raw")
    assert ("context_mask" in params) == jcfg.use_differentiable_mask
    assert (tb["video_tensor"].dtype == torch.uint8) == (name == "raw")


def test_train_matchings_losses_and_gradients_match_jax(variant):
    name, *_, trained = variant
    (ridx, raux, rloss, rgrad), (gidx, gaux, gloss, ggrad) = trained
    np.testing.assert_array_equal(gidx, ridx)
    if name != "raw":  # one decoder layer: no auxiliary matching
        np.testing.assert_array_equal(gaux, raux)
    assert_losses_match(rloss, gloss, min_terms=5 if name == "raw" else 10)
    assert ("loss_context" in gloss) == (name != "raw")
    assert assert_grads_match(rgrad, ggrad, (SHIFT_FREE,)) > 0.85 * len(rgrad)
    if name == "raw":  # gradients reach the ViViT
        leaf = "proposal||params||backbone||token_embeddings_layer||project_to_patch||kernel"
        assert float(np.abs(ggrad[leaf]).max()) > 0
        np.testing.assert_allclose(ggrad[leaf], rgrad[leaf], rtol=0,
                                   atol=1e-4 * float(np.abs(rgrad[leaf]).max()))


def test_forward_eval_matches_jax(variant):
    name, _, jmodel, params, model, batch, tb, _ = variant
    for case in VARIANTS[name]:
        mode, kw = MODES[case]
        rout, rcap, ridx, raux, rmask = jmodel.forward_eval(params, batch, mode, **kw)
        gout, gcap, gidx, gaux, gmask = model.forward_eval(tb, mode, **kw)
        np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx), err_msg=case)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask), err_msg=case)
        np.testing.assert_allclose(gout["pred_segments"].numpy(),
                                   np.asarray(rout["pred_segments"]), rtol=0, atol=SEG_ATOL)
        count = np.asarray(rout["pred_count"])
        np.testing.assert_allclose(gout["pred_count"].numpy(), count, rtol=0,
                                   atol=COUNT_REL * float(np.abs(count).max()))
        np.testing.assert_array_equal(gcap.numpy(), np.asarray(rcap), err_msg=case)
        assert len({tuple(r) for r in gcap.tolist()}) > 1, case
        np.testing.assert_allclose(gout["pred_captions"].numpy(),
                                   np.asarray(rout["pred_captions"]), rtol=0, atol=LOGP_ATOL)


def test_beam_one_is_greedy_and_serve_is_refused(variant):
    *_, model, _, tb, _ = variant
    greedy = model.forward_eval(tb, "one_by_one")[1]
    assert torch.equal(model.forward_eval(tb, "beam", beam_size=1)[1], greedy)
    with pytest.raises(ValueError, match="no 'serve'"):
        model.forward_eval(tb, "serve")
