"""The port's pretrained-weight surgery and GloVe embeddings
(``models/load_weights.py``, ``models/embeddings.py``) against the JAX
package's: the GloVe matrix and every transplant exactly (numpy on both
sides, the same arithmetic), the embedders within 1e-6 of their largest
value (f32 products in another order), and a small flagship built on an
embedding matrix within the parity tolerances of ``test_torch_train.py``
(losses) and ``test_torch_serve.py`` (tokens exact)."""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu.data.vocab import Vocab as JaxVocab
from multimodal_feature_learning_tpu.models import embeddings as jemb
from multimodal_feature_learning_tpu.models import load_weights as jlw
from multimodal_feature_learning_tpu_torch.models import backbones as tb
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.models import embeddings as temb
from multimodal_feature_learning_tpu_torch.models import load_weights as tlw
from multimodal_feature_learning_tpu_torch.utils.weights import (export_flax_params,
                                                                 load_flax_params)
from test_torch_common import (
    BOS, EOS, PAD, VOCAB_SIZE, array_batch, assert_losses_match, flatten_params,
    jax_small_cfg, no_dropout, perturb, serve_inputs, small_vocab, torch_cfg_like,
)

REL = 1e-6


def write_glove(path, words, dim: int, seed: int = 0):
    """A GloVe text file of ``words`` (a word, then ``dim`` floats, spaces
    between), values from a numpy seed."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for w in words:
            f.write(" ".join([w] + [f"{v:.6f}" for v in rng.normal(size=dim)]) + "\n")


def glove_for(vocab, tmp_path, dim: int = 300):
    """A GloVe file for the vocabulary's words but every third one (those
    rows are drawn at random), plus two words outside it."""
    words = [w for i, w in enumerate(vocab.get_itos()) if i % 3] + ["zebra", "quokka"]
    path = str(tmp_path / "glove.txt")
    write_glove(path, words, dim)
    return path


def assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * float(np.abs(ref).max()))


def test_glove_matrix_and_its_cache_equal_jax(tmp_path):
    vocab = small_vocab()
    jvocab = JaxVocab(vocab.get_itos())
    glove = glove_for(vocab, tmp_path)
    ref = jlw.build_word_embedding_matrix(glove, jvocab, 300)
    got = tlw.build_word_embedding_matrix(glove, vocab, 300)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    unknown = [i for i in range(len(vocab)) if i % 3 == 0]
    assert np.abs(got[unknown]).max() < 1.0  # N(0, 0.1) rows where GloVe has no word
    # each package reads the other's cache, and a cache of the wrong shape is rebuilt
    jcache, tcache = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jlw.build_word_embedding_matrix(glove, jvocab, 300, cache_path=jcache)
    tlw.build_word_embedding_matrix(glove, vocab, 300, cache_path=tcache)
    with open(jcache, "rb") as f, open(tcache, "rb") as g:
        np.testing.assert_array_equal(pickle.load(f), pickle.load(g))
    os.remove(glove)  # from here on only the caches can give the matrix
    np.testing.assert_array_equal(tlw.build_word_embedding_matrix(glove, vocab, 300,
                                                                  cache_path=jcache), ref)
    np.testing.assert_array_equal(jlw.build_word_embedding_matrix(glove, jvocab, 300,
                                                                  cache_path=tcache), ref)
    with pytest.raises(OSError):
        tlw.build_word_embedding_matrix(glove, vocab, 200, cache_path=tcache)


def test_glove_cache_refuses_anything_but_an_array(tmp_path):
    cache = str(tmp_path / "evil.pkl")
    with open(cache, "wb") as f:
        pickle.dump({"not": os.getcwd}, f)
    glove = glove_for(small_vocab(), tmp_path, dim=4)
    got = tlw.build_word_embedding_matrix(glove, small_vocab(), 4, cache_path=cache)
    assert got.shape == (VOCAB_SIZE, 4)  # rebuilt from the text file and cached anew
    with open(cache, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), got)


@pytest.mark.parametrize("pre_dim", [None, 16, 24], ids=["plain", "same_dim", "projected"])
def test_vocabulary_embedder_equals_jax(pre_dim):
    d_model = 16
    matrix = None if pre_dim is None else \
        np.random.default_rng(1).normal(size=(VOCAB_SIZE, pre_dim)).astype(np.float32)
    tokens = np.random.default_rng(2).integers(0, VOCAB_SIZE, size=(3, 7)).astype(np.int32)
    jmod = jemb.VocabularyEmbedder(VOCAB_SIZE, d_model, matrix)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tmod = temb.VocabularyEmbedder(VOCAB_SIZE, d_model, matrix)
    if matrix is not None:  # both start from the matrix
        np.testing.assert_array_equal(np.asarray(init["params"]["Embed_0"]["embedding"]), matrix)
        np.testing.assert_array_equal(tmod.embed.weight.detach().numpy(), matrix)
    assert hasattr(tmod, "Dense_0") == (pre_dim == 24) == ("Dense_0" in init["params"])
    params = perturb(init, 3)
    load_flax_params(tmod, flatten_params(params))
    ref = jmod.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tmod(torch.from_numpy(tokens).long())
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("normalize", [True, False])
def test_caption_sine_embedding_equals_jax(normalize):
    mask = np.zeros((3, 9), bool)
    mask[1, 6:] = True
    mask[2, 2:] = True
    ref = jemb.caption_sine_embedding(jnp.asarray(mask), 16, normalize=normalize)
    got = temb.caption_sine_embedding(torch.from_numpy(mask), 16, normalize=normalize)
    assert_close(got.numpy(), ref)


def test_learned_positional_embedding_equals_jax():
    x = np.random.default_rng(4).normal(size=(2, 5, 8)).astype(np.float32)
    jmod = jemb.LearnedPositionalEmbedding(max_tokens=12, d_model=8)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    tmod = temb.LearnedPositionalEmbedding(12, 8, dropout=0.1)
    load_flax_params(tmod, flatten_params(params))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x))
    assert_close(got.numpy(), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("pt,method", [(1, "central frame"), (2, "central frame"),
                                       (3, "central frame"), (2, "filter inflation"),
                                       (3, "filter inflation")])
def test_patch_kernel_inflation_equals_jax(pt, method):
    kernel = np.random.default_rng(pt).normal(size=(8, 3, 4, 4)).astype(np.float32)
    got = tlw.inflate_patch_kernel_to_tubelet(kernel, pt, method)
    np.testing.assert_array_equal(got, jlw.inflate_patch_kernel_to_tubelet(kernel, pt, method))
    assert got.shape == (pt, 4, 4, 3, 8)


def test_unknown_tokenization_method_raises():
    with pytest.raises(ValueError, match="unknown tokenization method"):
        tlw.inflate_patch_kernel_to_tubelet(np.zeros((8, 3, 4, 4), np.float32), 2, "mean")


@pytest.mark.parametrize("n_out", [17, 5, 9])
def test_pos_embed_surgery_equals_jax(n_out):
    pos = np.random.default_rng(n_out).normal(size=(1, 9, 6)).astype(np.float32)
    np.testing.assert_array_equal(tlw.repeat_pos_embed_for_frames(pos, 3),
                                  jlw.repeat_pos_embed_for_frames(pos, 3))
    got = tlw.interpolate_pos_embed(pos, n_out)
    np.testing.assert_array_equal(got, jlw.interpolate_pos_embed(pos, n_out))
    assert got.shape == (1, n_out, 6) and got.dtype == np.float32


VIVIT = dict(d_model=32, depth=1, temporal_depth=1, num_heads=2, spatial_patch_size=16,
             max_tokens=24)


def unflatten(flat: dict) -> dict:
    """{"a||b||c": array} -> the nested params tree."""
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("||")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


@pytest.mark.parametrize("mode", ["factorised encoder", "spatio temporal attention",
                                  "factorised self attention",
                                  "factorised dot product attention"])
@pytest.mark.parametrize("pt,method", [(1, "central frame"), (2, "filter inflation")])
def test_vit_to_vivit_transplant_equals_jax(mode, pt, method):
    """JAX's transplant of a seeded ViT npz into a ViViT params tree,
    carried into the port's ViViT by ``load_flax_params``, equals the port's
    transplant into the port's ViViT carrying the same params before it. The
    tree is the port's seeded ViViT exported under flax's names and layouts
    (``test_torch_backbones.py`` holds those equal to a flax init's)."""
    rng = np.random.default_rng(7)
    vit = {"patch_embed.proj.weight": rng.normal(size=(32, 3, 16, 16)).astype(np.float32),
           "patch_embed.proj.bias": rng.normal(size=(32,)).astype(np.float32),
           "pos_embed": rng.normal(size=(1, 5, 32)).astype(np.float32)}
    kw = dict(model_name=mode, temporal_patch_size=pt, **VIVIT)
    torch.manual_seed(pt)
    got = tb.VideoVisionTransformer(**kw)
    with torch.no_grad():
        for p in got.parameters():
            p.normal_()
    flat = export_flax_params(got)
    ref = tb.VideoVisionTransformer(**kw)
    load_flax_params(ref, flatten_params(jlw.transplant_vit_to_vivit(
        vit, unflatten(flat), num_frames=4, temporal_patch_size=pt, tokenization_method=method,
        model_name=mode)))
    assert tlw.transplant_vit_to_vivit(vit, got, num_frames=4, temporal_patch_size=pt,
                                       tokenization_method=method, model_name=mode) is got
    ref_sd, got_sd = ref.state_dict(), got.state_dict()
    assert ref_sd.keys() == got_sd.keys()
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    bias = got.token_embeddings_layer.project_to_patch.bias.detach().numpy()
    np.testing.assert_array_equal(bias, vit["patch_embed.proj.bias"])
    moved = {"factorised encoder": "spatial_pos_embedding",
             "spatio temporal attention": "pos_embedding"}.get(mode)
    for name in ("pos_embedding", "spatial_pos_embedding"):
        same = np.array_equal(got_sd[name].numpy(), flat["params||" + name])
        assert same == (name != moved), name


# -- a small flagship on GloVe embeddings, against JAX ---------------------------

PRE_DIM = 24  # not the small config's d_model: the projection runs


@pytest.fixture(scope="module")
def glove_pair(tmp_path_factory):
    """(jax cfg, jax model, its params, port model, matrix): the matrix built
    from a seeded GloVe file, the JAX model on it (params perturbed), the
    port's built through ``build_model_and_criterion`` from the same file,
    then carrying the JAX params."""
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build

    tmp = tmp_path_factory.mktemp("glove")
    jcfg = no_dropout(jax_small_cfg(use_differentiable_mask=False))
    jcfg.dvc.caption.glove_file_path = glove_for(small_vocab(), tmp, PRE_DIM)
    jcfg.dvc.caption.pretrained_word_embed_dim = PRE_DIM
    jcfg.dvc.caption.embedding_matrix_file_path = str(tmp / "matrix.pkl")
    matrix = jlw.build_word_embedding_matrix(jcfg.dvc.caption.glove_file_path,
                                             JaxVocab(small_vocab().get_itos()), PRE_DIM)
    jmodel = jax_build(jcfg, VOCAB_SIZE, PAD, BOS, EOS, matrix)
    anet = jcfg.dataset.activity_net
    B, T, G, Lc = 2, anet.video_rescale_len, anet.max_gt_target_segments, anet.max_caption_len_all
    init_batch = {
        "video_tensor": np.zeros((B, T, jcfg.dvc.detr.feature_dim), np.float32),
        "video_mask": np.zeros((B, T), bool), "durations": np.ones((B,), np.float32),
        "gt_segments": np.zeros((B, G, 2), np.float32), "gt_mask": np.zeros((B, G), bool),
        "cap_tokens": np.full((B, G, Lc), PAD, np.int32)}
    params = jmodel.init(jax.random.PRNGKey(0), init_batch)
    emb = params["caption"]["params"]["target_embedding"]
    np.testing.assert_array_equal(np.asarray(emb["Embed_0"]["embedding"]), matrix)
    params = perturb(params, 0)
    tcfg = torch_cfg_like(jcfg)
    tcfg.dvc.caption.glove_file_path = jcfg.dvc.caption.glove_file_path
    tmodel, criterion, weight_dict = build_model_and_criterion(tcfg, small_vocab(),
                                                               device="cpu")
    np.testing.assert_array_equal(
        tmodel.caption.target_embedding.embed.weight.detach().numpy(), matrix)
    load_flax_params(tmodel, flatten_params(params))
    return jcfg, jmodel, params, tmodel, criterion, weight_dict


def test_glove_flagship_serves_like_jax(glove_pair):
    jcfg, jmodel, params, tmodel, _, _ = glove_pair
    video, mask, durations = serve_inputs(jcfg)
    ref = jmodel.forward_serve(params, video, mask, durations)
    got = tmodel.forward_serve(torch.from_numpy(video), torch.from_numpy(mask),
                               torch.from_numpy(durations))
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["captions"].numpy(), np.asarray(ref["captions"]))
    caps = got["captions"].reshape(-1, got["captions"].shape[-1])
    assert len({tuple(r) for r in caps.tolist()}) > 1


def test_glove_flagship_trains_like_jax(glove_pair):
    """``forward_train`` and the criterion of both (dropout rates 0): the
    same matchings and every loss term within the train test's tolerance."""
    from multimodal_feature_learning_tpu.models.criterion import SetCriterion as JaxCriterion
    from multimodal_feature_learning_tpu.models.criterion import build_weight_dict

    jcfg, jmodel, params, tmodel, criterion, weight_dict = glove_pair
    batch = array_batch(torch_cfg_like(jcfg), 2, seed=3)
    jweights = build_weight_dict(jcfg)
    jcrit = JaxCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=jweights,
                         losses=list(jcfg.dvc.losses), pad_idx=PAD, smoothing=jcfg.dvc.smoothing)

    @jax.jit
    def jax_losses(p, b):
        out, idx, idx_aux, memory_mask = jmodel.forward_train(p, b, jax.random.PRNGKey(0))
        losses = jcrit(out, b, idx, idx_aux, memory_mask)
        losses["loss"] = sum(losses[k] * jweights[k] for k in losses if k in jweights)
        return losses, idx

    ref, ref_idx = jax_losses(params, batch)
    tmodel.train()
    with torch.no_grad():
        tb_ = {k: torch.from_numpy(v) for k, v in batch.items()}
        out, idx, idx_aux, memory_mask = tmodel.forward_train(tb_)
        losses = criterion(out, tb_, idx, idx_aux, memory_mask)
    tmodel.eval()
    got = {k: float(v) for k, v in losses.items()}
    got["loss"] = float(sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert_losses_match({k: float(v) for k, v in ref.items()}, got)
