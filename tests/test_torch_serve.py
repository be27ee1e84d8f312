"""The port's GT-free serving path against the JAX package's.

``UnimodalDVC.forward_serve`` of both, on the same weights and inputs at
``_small_cfg`` dims, f32 on the CPU: scores within atol 1e-4, segments within
atol 1e-5 of the video's duration (the model predicts normalized segments;
in seconds an f32 rounding of 1e-6 becomes 1e-4 for a 100 s video), ``k``
equal and captions token-exact. The differences come from f32 sums taken in
another order through 2+2 transformer layers. Then the port's ``DVCServer``
and its device rule."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_common import (
    build_jax_model, build_port_model, jax_small_cfg, serve_inputs,
)

from multimodal_feature_learning_tpu_torch.data.vocab import Vocab
from multimodal_feature_learning_tpu_torch.models.dvc import build_model
from multimodal_feature_learning_tpu_torch.serve import DVCServer


@pytest.fixture(scope="module", params=[True, False], ids=["ctxmask", "cropmask"])
def pair(request):
    """(jax cfg, jax model, flax params, port model): with the differentiable
    context mask (the config default) and without it (as conv_e79 was
    trained)."""
    jcfg = jax_small_cfg(use_differentiable_mask=request.param)
    jmodel, params = build_jax_model(jcfg)
    return jcfg, jmodel, params, build_port_model(jcfg, params)


@pytest.mark.parametrize("faster_eval", [False, True])
def test_forward_serve_matches_jax(pair, faster_eval):
    jcfg, jmodel, params, tmodel = pair
    video, mask, durations = serve_inputs(jcfg)
    ref = jmodel.forward_serve(params, video, mask, durations, faster_eval=faster_eval)
    got = tmodel.forward_serve(torch.from_numpy(video), torch.from_numpy(mask),
                               torch.from_numpy(durations), faster_eval=faster_eval)
    dur = durations[:, None, None]
    np.testing.assert_allclose(got["segments"].numpy() / dur,
                               np.asarray(ref["segments"]) / dur, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["captions"].numpy(), np.asarray(ref["captions"]))


def test_outputs_are_not_degenerate(pair):
    """The perturbed weights give captions that differ between events, so
    token-exact agreement above is a real check."""
    jcfg, _, _, tmodel = pair
    video, mask, durations = serve_inputs(jcfg)
    got = tmodel.forward_serve(torch.from_numpy(video), torch.from_numpy(mask),
                               torch.from_numpy(durations))
    caps = got["captions"].reshape(-1, got["captions"].shape[-1])
    assert len({tuple(r) for r in caps.tolist()}) > 1
    assert torch.isfinite(got["segments"]).all()


def test_server_answers_like_forward_serve(pair):
    jcfg, _, _, tmodel = pair
    video, _, durations = serve_inputs(jcfg, B=3, seed=1)
    rng = np.random.default_rng(2)
    G = jcfg.dataset.activity_net.max_gt_target_segments
    with DVCServer(tmodel, batch_size=4, max_wait_ms=50.0) as server:
        # the requests' own lengths differ from the grid; the server rescales
        lengths = [int(n) for n in rng.integers(10, 60, size=3)]
        feats = [rng.normal(size=(n, video.shape[2])).astype(np.float32) for n in lengths]
        futs = [server.submit(f, float(d)) for f, d in zip(feats, durations)]
        results = [f.result(timeout=60) for f in futs]
    assert server.stats["filled"] == 3
    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize

    T = jcfg.dataset.activity_net.video_rescale_len
    batch = np.zeros((4, T, video.shape[2]), np.float32)
    dur = np.ones((4,), np.float32)
    for i, f in enumerate(feats):
        batch[i] = nearest_resize(f[None], T, axis=1)[0]
        dur[i] = durations[i]
    ref = tmodel.forward_serve(torch.from_numpy(batch), torch.zeros((4, T), dtype=torch.bool),
                               torch.from_numpy(dur))
    for i, events in enumerate(results):
        k = int(ref["k"][i])
        assert 1 <= len(events) == k <= G
        for j, ev in enumerate(events):
            assert ev["caption"] == ref["captions"][i, j].tolist()
            np.testing.assert_allclose(ev["segment"], ref["segments"][i, j].numpy(), atol=1e-6)


def test_server_decodes_captions_with_a_vocab(pair):
    """With a vocab the server answers the strings of JAX's
    ``captions_to_string`` on the ids it would answer without one."""
    jcfg, _, _, tmodel = pair
    from test_torch_common import VOCAB_SIZE

    from multimodal_feature_learning_tpu.data.vocab import Vocab as JaxVocab
    from multimodal_feature_learning_tpu.utils.postprocess import captions_to_string

    words = ["<unk>", "<pad>", "<bos>", "<eos>"] + [f"w{i}" for i in range(VOCAB_SIZE - 4)]
    vocab = Vocab(words)
    feats = np.random.default_rng(3).normal(
        size=(30, jcfg.dvc.detr.feature_dim)).astype(np.float32)
    with DVCServer(tmodel, batch_size=2, max_wait_ms=1.0) as plain:
        ids = plain.submit(feats, 42.0).result(timeout=60)
    with DVCServer(tmodel, vocab=vocab, batch_size=2, max_wait_ms=1.0) as server:
        strings = server.submit(feats, 42.0).result(timeout=60)
    assert [e["caption"] for e in strings] == captions_to_string(
        [e["caption"] for e in ids], JaxVocab(words))


def test_caption_strings_match_jax_postprocess():
    """The reference's post-processing: specials dropped, then the first and
    last word, then repeated words and stray punctuation."""
    from multimodal_feature_learning_tpu.data.vocab import Vocab as JaxVocab
    from multimodal_feature_learning_tpu.utils.postprocess import (
        captions_to_string as jax_captions_to_string,
    )
    from multimodal_feature_learning_tpu_torch.utils.postprocess import captions_to_string

    words = "<unk> <pad> <bos> <eos> a man man . is riding bike".split()
    rows = [[2, 4, 5, 5, 7, 8, 9, 4, 10, 7, 3, 1, 1], [2, 3, 1, 1], [2, 4, 3], [2, 0, 6, 6, 4, 5, 3],
            [2, 4, 7, 7, 5, 3]]
    ref = jax_captions_to_string(rows, JaxVocab(words))
    assert ref[0] == "man is riding a bike"
    assert captions_to_string(rows, Vocab(words)) == ref


@pytest.fixture(scope="module")
def fused_pair(pair):
    """The same weights as ``pair``, with ``decode_impl="fused"`` on both
    sides."""
    jcfg, _, params, _ = pair
    jcfg = jax_small_cfg(use_differentiable_mask=jcfg.use_differentiable_mask)
    jcfg.decode_impl = "fused"
    from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
    from test_torch_common import BOS, EOS, PAD, VOCAB_SIZE

    jmodel = jax_build_model(jcfg, VOCAB_SIZE, PAD, BOS, EOS)
    return jcfg, jmodel, params, build_port_model(jcfg, params)


@pytest.mark.parametrize("grid", ["video", "batch"])
def test_forward_serve_fused_matches_jax(fused_pair, monkeypatch, grid):
    """``forward_serve`` with the fused decode step against JAX's, whose
    Pallas kernel runs in interpret mode on the CPU; the tolerances of
    ``test_forward_serve_matches_jax``, captions token-exact."""
    import multimodal_feature_learning_tpu.ops.fused_decode as jfd

    jcfg, jmodel, params, tmodel = fused_pair
    assert jmodel.decode_impl == tmodel.decode_impl == "fused"
    jmodel.decode_fused_grid = tmodel.decode_fused_grid = grid
    orig = jfd.fused_decode_step
    monkeypatch.setattr(jfd, "fused_decode_step",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    video, mask, durations = serve_inputs(jcfg)
    ref = jmodel.forward_serve(params, video, mask, durations)
    got = tmodel.forward_serve(torch.from_numpy(video), torch.from_numpy(mask),
                               torch.from_numpy(durations))
    dur = durations[:, None, None]
    np.testing.assert_allclose(got["segments"].numpy() / dur,
                               np.asarray(ref["segments"]) / dur, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["captions"].numpy(), np.asarray(ref["captions"]))


def test_server_fails_futures_on_dispatch_error(pair):
    jcfg, _, _, tmodel = pair
    with DVCServer(tmodel, batch_size=2, max_wait_ms=1.0) as server:
        with pytest.raises(ValueError):
            server.submit(np.zeros((5, 3), np.float32), 10.0)  # wrong feature width

        def broken(*_args, **_kw):
            raise RuntimeError("boom")

        server._step = broken
        fut = server.submit(np.zeros((8, jcfg.dvc.detr.feature_dim), np.float32), 10.0)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    assert server.stats["errors"] == 1


def test_entry_point_without_device_raises_on_cpu_host(monkeypatch):
    """With no GPU and no explicit CPU request the port raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg = jax_small_cfg()
    from test_torch_common import VOCAB_SIZE, torch_cfg_like

    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(torch_cfg_like(jcfg), VOCAB_SIZE)


def served_batch(tmodel, feats, durations, B, transfer=None, **kw):
    """forward_serve of the requests as the static server assembles them:
    nearest-rescaled into a zero batch of B rows, durations 1 elsewhere."""
    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize

    T = tmodel.video_rescale_len
    video = np.zeros((B, T, feats[0].shape[1]), np.float32)
    dur = np.ones((B,), np.float32)
    for i, (f, d) in enumerate(zip(feats, durations)):
        if f is not None:
            video[i], dur[i] = nearest_resize(f[None], T, axis=1)[0], d
    video = torch.from_numpy(video)
    if transfer is not None:
        video = video.to(transfer).float()
    return tmodel.forward_serve(video, torch.zeros((B, T), dtype=torch.bool),
                                torch.from_numpy(dur), **kw)


def assert_events_equal(events, ref, i):
    k = int(ref["k"][i])
    assert len(events) == k
    for j, ev in enumerate(events):
        assert ev["caption"] == ref["captions"][i, j].tolist()
        assert ev["segment"] == (float(ref["segments"][i, j, 0]), float(ref["segments"][i, j, 1]))
        assert ev["score"] == float(ref["scores"][i, j])


def test_server_sheds_beyond_max_queue(pair):
    """With the worker busy on one request and max_queue=2 waiting, the next
    submit is refused and counted; the three taken are all answered."""
    import threading

    jcfg, _, _, tmodel = pair
    feats = np.random.default_rng(4).normal(size=(20, jcfg.dvc.detr.feature_dim)) \
        .astype(np.float32)
    server = DVCServer(tmodel, batch_size=1, max_wait_ms=0.0, max_queue=2)
    entered, release = threading.Event(), threading.Event()
    real_step = server._step

    def held_step(video, durations):
        entered.set()
        assert release.wait(timeout=60)
        return real_step(video, durations)

    server._step = held_step
    try:
        futs = [server.submit(feats, 30.0)]
        assert entered.wait(timeout=60)
        futs += [server.submit(feats, 30.0) for _ in range(2)]
        with pytest.raises(RuntimeError, match="max_queue=2"):
            server.submit(feats, 30.0)
        assert server.stats["shed"] == 1
        release.set()
        answers = [f.result(timeout=60) for f in futs]
    finally:
        release.set()
        server.close()
    assert answers[0] == answers[1] == answers[2] and len(answers[0]) >= 1
    assert server.stats["dispatches"] == 3 and server.stats["shed"] == 1


def test_ingest_failure_fails_only_its_request(pair):
    """A request whose ingest raises fails its own future; the rest of its
    batch is served on a zero slot in its place, as forward_serve answers
    that batch."""
    jcfg, _, _, tmodel = pair
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(n, jcfg.dvc.detr.feature_dim)).astype(np.float32)
             for n in (20, 13, 30)]
    durations = (30.0, 40.0, 50.0)
    server = DVCServer(tmodel, batch_size=4, max_wait_ms=500.0)
    real_ingest = server._ingest

    def ingest(f):
        if f.shape[0] == 13:
            raise ValueError("undecodable features")
        return real_ingest(f)

    server._ingest = ingest
    with server:
        futs = [server.submit(f, d) for f, d in zip(feats, durations)]
        with pytest.raises(ValueError, match="undecodable"):
            futs[1].result(timeout=60)
        answers = {i: futs[i].result(timeout=60) for i in (0, 2)}
    assert server.stats["dispatches"] == 1 and server.stats["errors"] == 1
    ref = served_batch(tmodel, [feats[0], None, feats[2]], durations, 4)
    for i, events in answers.items():
        assert_events_equal(events, ref, i)


def test_rank_class_ranks_by_stability_on_the_sparse_family(pair):
    """The sparse family has no class head, so rank="class" falls back to
    stability, as JAX's does; an unknown rank raises."""
    jcfg, jmodel, params, tmodel = pair
    video, mask, durations = serve_inputs(jcfg)
    args = (torch.from_numpy(video), torch.from_numpy(mask), torch.from_numpy(durations))
    got = tmodel.forward_serve(*args, rank="class")
    stability = tmodel.forward_serve(*args)
    for k in got:
        assert torch.equal(got[k], stability[k]), k
    ref = jmodel.forward_serve(params, video, mask, durations, rank="class")
    np.testing.assert_array_equal(got["captions"].numpy(), np.asarray(ref["captions"]))
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="rank"):
        tmodel.forward_serve(*args, rank="confidence")


@pytest.mark.parametrize("option", ["bf16_transfer", "faster_eval"])
def test_server_options_answer_like_forward_serve(pair, option):
    """transfer_dtype="bfloat16" answers forward_serve of the bf16-cast
    features; faster_eval answers forward_serve(faster_eval=True)."""
    jcfg, _, _, tmodel = pair
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(n, jcfg.dvc.detr.feature_dim)).astype(np.float32)
             for n in (24, 40)]
    durations = (25.0, 70.0)
    if option == "bf16_transfer":
        kw, ref_kw = {"transfer_dtype": "bfloat16"}, {"transfer": torch.bfloat16}
    else:
        kw, ref_kw = {"faster_eval": True}, {"faster_eval": True}
    with DVCServer(tmodel, batch_size=2, max_wait_ms=500.0, **kw) as server:
        futs = [server.submit(f, d) for f, d in zip(feats, durations)]
        answers = [f.result(timeout=60) for f in futs]
    ref = served_batch(tmodel, feats, durations, 2, **ref_kw)
    for i, events in enumerate(answers):
        assert_events_equal(events, ref, i)
    if option == "bf16_transfer":  # the rounding reaches the answers
        plain = served_batch(tmodel, feats, durations, 2)
        assert not torch.equal(ref["scores"], plain["scores"])
    with pytest.raises(ValueError, match="transfer_dtype"):
        DVCServer(tmodel, transfer_dtype="float16")
