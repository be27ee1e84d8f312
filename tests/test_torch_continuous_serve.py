"""The port's continuous-batching server and its model-side pieces against
the JAX package's.

At ``_small_cfg`` dims, f32 on the CPU, with the same flax params on both
sides (perturbed from a numpy seed, carried into the port by
``utils.weights``), with and without the differentiable context mask:

- ``ContinuousDVCServer``'s answers against JAX ``forward_serve`` on the
  same requests in one batch: captions and k exact, segments within 1e-5 x
  the duration, scores within 1e-4 (the tolerances of
  ``tests/test_torch_serve.py``, whose reasons hold here: f32 sums taken in
  another order through 2+2 transformer layers). A video's greedy decode
  does not depend on the other rows of its batch, so a request that joins a
  half-decoded pool gets the tokens it would get alone;
- ``greedy_decode_chunk`` on JAX's own prefilled state, with slots at
  different positions: tokens, ``done`` and cursors exact, the caches within
  1e-5 x their largest value (the layer pass's f32 sums);
- ``merge_serve_slots`` on the same random pools: every leaf exact (a
  select moves values without arithmetic);
- a single request in an otherwise idle pool, and a failed admit that fails
  only its own wave (JAX ``tests/test_continuous_serve.py``); a failed chunk
  that fails the slots in flight and rebuilds the pool."""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import build_jax_model, build_port_model, jax_small_cfg

from multimodal_feature_learning_tpu.models.caption_decoder import (
    greedy_decode_chunk as jax_greedy_decode_chunk,
)
from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize
from multimodal_feature_learning_tpu_torch.models.caption_decoder import greedy_decode_chunk
from multimodal_feature_learning_tpu_torch.serve import ContinuousDVCServer

SEG_TOL, SCORE_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-5
JAX_B = 6  # rows of every JAX serving call


@pytest.fixture(scope="module", params=[True, False], ids=["ctxmask", "cropmask"])
def pair(request):
    """(jax cfg, jax model, flax params, port model)."""
    jcfg = jax_small_cfg(use_differentiable_mask=request.param)
    jmodel, params = build_jax_model(jcfg)
    return jcfg, jmodel, params, build_port_model(jcfg, params)


def requests_of(jcfg, lengths_durations, seed):
    rng = np.random.default_rng(seed)
    D = jcfg.dvc.detr.feature_dim
    return [(rng.normal(size=(t, D)).astype(np.float32), d) for t, d in lengths_durations]


def jax_serve(jcfg, jmodel, params, reqs):
    """JAX ``forward_serve`` of the requests in one batch, padded to JAX_B
    rows with the first request: every call has one shape, so JAX's eager
    ops compile once in the file."""
    T = jcfg.dataset.activity_net.video_rescale_len
    reqs = reqs + [reqs[0]] * (JAX_B - len(reqs))
    video = np.stack([nearest_resize(f[None], T, axis=1)[0] for f, _ in reqs])
    durations = np.array([d for _, d in reqs], np.float32)
    out = jmodel.forward_serve(params, video, np.zeros((JAX_B, T), bool), durations)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_answers_match(results, ref, durations):
    for i, events in enumerate(results):
        k = int(ref["k"][i])
        assert len(events) == k
        for j, ev in enumerate(events):
            assert ev["caption"] == ref["captions"][i, j].tolist(), (i, j)
            np.testing.assert_allclose(np.array(ev["segment"]) / durations[i],
                                       ref["segments"][i, j] / durations[i],
                                       rtol=0, atol=SEG_TOL)
            np.testing.assert_allclose(ev["score"], ref["scores"][i, j], rtol=0, atol=SCORE_TOL)


def test_continuous_server_matches_jax_forward_serve(pair):
    """2 slots, 6 requests, chunk 3: every slot is answered and refilled,
    and refills join while the other slot is mid-caption."""
    jcfg, jmodel, params, tmodel = pair
    reqs = requests_of(jcfg, [(17, 12.0), (24, 33.0), (55, 48.0), (8, 7.5), (30, 20.0),
                              (12, 90.0)], seed=2)
    with ContinuousDVCServer(tmodel, batch_size=2, chunk=3) as server:
        futs = [server.submit(f, d) for f, d in reqs]
        results = [f.result(timeout=120) for f in futs]
    assert server.stats["chunks"] > 2 and server.stats["prefills"] >= 3
    assert server.stats["errors"] == 0
    assert_answers_match(results, jax_serve(jcfg, jmodel, params, reqs), [d for _, d in reqs])
    assert len({tuple(ev["caption"]) for events in results for ev in events}) > 1


def test_continuous_single_request(pair):
    """One request through an otherwise idle pool of 4: the inactive slots
    do not perturb it."""
    jcfg, jmodel, params, tmodel = pair
    reqs = requests_of(jcfg, [(40, 27.0)], seed=3)
    with ContinuousDVCServer(tmodel, batch_size=4, chunk=2) as server:
        events = server.submit(*reqs[0]).result(timeout=120)
    assert server.stats["prefills"] == 1
    assert_answers_match([events], jax_serve(jcfg, jmodel, params, reqs), [27.0])


def test_failed_admit_spares_active_slots(pair):
    """A prefill that raises while request A is mid-caption fails only the
    wave it admits (B); A is answered as if nothing happened, and the pool
    serves a later request."""
    jcfg, jmodel, params, tmodel = pair
    (feats_a, dur_a), (feats_b, dur_b) = requests_of(jcfg, [(24, 21.0), (24, 9.0)], seed=7)
    server = ContinuousDVCServer(tmodel, batch_size=2, chunk=1)
    try:
        real_prefill, real_chunk = server._prefill, server._decode_chunk
        go = threading.Event()
        seen = {}

        def held_chunk():  # A's first chunk waits until B is queued
            assert go.wait(timeout=60)
            return real_chunk()

        def failing_prefill(video, durations):
            if "a_admitted" not in seen:
                seen["a_admitted"] = True
                return real_prefill(video, durations)
            seen["active_at_failure"] = server._active.copy()
            server._prefill = real_prefill
            raise RuntimeError("injected admit failure")

        server._prefill, server._decode_chunk = failing_prefill, held_chunk
        fut_a = server.submit(feats_a, dur_a)
        # B arrives after A's admit, while A's first chunk is held
        deadline = time.monotonic() + 60
        while server.stats["prefills"] < 1:
            assert time.monotonic() < deadline, "request A was never admitted"
            time.sleep(0.01)
        fut_b = server.submit(feats_b, dur_b)
        go.set()
        with pytest.raises(RuntimeError, match="injected admit failure"):
            fut_b.result(timeout=120)
        events_a = fut_a.result(timeout=120)
        assert seen["active_at_failure"].sum() == 1
        assert server.stats["errors"] == 1
        assert_answers_match([events_a],
                             jax_serve(jcfg, jmodel, params, [(feats_a, dur_a)]), [dur_a])
        assert len(server.submit(feats_b, dur_b).result(timeout=120)) >= 1
    finally:
        server.close()


@pytest.mark.parametrize("rebuild_fails", [False, True], ids=["rebuilt", "rebuild_failed"])
def test_failed_chunk_fails_the_active_slots_and_rebuilds(pair, rebuild_fails):
    """A chunk that raises fails the requests in flight and the pool is
    rebuilt from a zero prefill, after which a new request is served; a
    rebuild that raises is counted in ``rebuild_errors``."""
    jcfg, _, _, tmodel = pair
    (feats, dur), = requests_of(jcfg, [(30, 15.0)], seed=9)
    server = ContinuousDVCServer(tmodel, batch_size=2, chunk=2)
    try:
        real_chunk, real_zero_pool = server._decode_chunk, server._zero_pool

        def failing_chunk():
            server._decode_chunk = real_chunk
            raise RuntimeError("injected chunk failure")

        def failing_zero_pool():
            server._zero_pool = real_zero_pool
            raise RuntimeError("injected rebuild failure")

        server._decode_chunk = failing_chunk
        if rebuild_fails:
            server._zero_pool = failing_zero_pool
        with pytest.raises(RuntimeError, match="injected chunk failure"):
            server.submit(feats, dur).result(timeout=120)
        assert server.stats.get("rebuild_errors", 0) == int(rebuild_fails)
        assert not server._active.any()
        if not rebuild_fails:
            assert len(server.submit(feats, dur).result(timeout=120)) >= 1
    finally:
        server.close()
    assert server.stats["errors"] == 1


def jax_prefilled(jcfg, jmodel, params, B=JAX_B, seed=4):
    rng = np.random.default_rng(seed)
    T = jcfg.dataset.activity_net.video_rescale_len
    video = rng.normal(size=(B, T, jcfg.dvc.detr.feature_dim)).astype(np.float32)
    durations = rng.uniform(10, 100, size=(B,)).astype(np.float32)
    return jmodel.forward_serve_prefill(params, video, np.zeros((B, T), bool), durations)


def to_torch(x):
    return torch.from_numpy(np.array(x))


def test_greedy_decode_chunk_matches_jax(pair):
    """From JAX's own prefill of 6 videos: a chunk of 2 with videos 1 and 4
    inactive, then another with all active, so the videos sit at different
    positions, on both sides."""
    jcfg, jmodel, params, tmodel = pair
    ctx, state = jax_prefilled(jcfg, jmodel, params)
    G = jcfg.dataset.activity_net.max_gt_target_segments
    L = jcfg.dataset.activity_net.max_caption_len_all
    cap_params = jmodel._cast_params(params)["caption"]
    t_state = {k: to_torch(v) for k, v in state.items()}
    t_state["captions"] = t_state["captions"].long()
    t_state["t"] = t_state["t"].long()
    t_mem_kv = [(to_torch(k), to_torch(v)) for k, v in ctx["mem_kv"]]
    zeroed = None if ctx["zeroed"] is None else to_torch(ctx["zeroed"])
    pad_mask = to_torch(ctx["caption_pad_mask"])
    dec = jmodel.caption_decoder
    chunk = 2
    for active in ([True, False, True, True, False, True], [True] * JAX_B):
        captions, done, t, kc, vc = jax_greedy_decode_chunk(
            dec, cap_params, state["captions"], state["done"], state["t"], state["k_caches"],
            state["v_caches"], ctx["mem_kv"], ctx["caption_pad_mask"], L,
            tmodel.eos_idx, tmodel.pad_idx, G, ctx["zeroed"], jnp.array(active), chunk)
        state = {"captions": captions, "done": done, "t": t, "k_caches": kc, "v_caches": vc}
        with torch.no_grad():
            greedy_decode_chunk(
                tmodel.caption, t_state["captions"], t_state["done"], t_state["t"],
                t_state["k_caches"], t_state["v_caches"], t_mem_kv, pad_mask, L,
                tmodel.eos_idx, tmodel.pad_idx, G, zeroed, torch.tensor(active), chunk)
        for key in ("captions", "done", "t"):
            np.testing.assert_array_equal(t_state[key].numpy(), np.asarray(state[key]), key)
        for key in ("k_caches", "v_caches"):
            ref = np.asarray(state[key])
            np.testing.assert_allclose(t_state[key].numpy(), ref, rtol=0,
                                       atol=CACHE_TOL * np.abs(ref).max())
    t_final = np.asarray(state["t"])
    assert len(set(t_final.tolist())) > 1, t_final  # the videos sit at different positions
    assert (np.asarray(state["captions"])[:, 1:] != tmodel.pad_idx).any()


def test_merge_serve_slots_matches_jax(pair):
    jcfg, jmodel, params, tmodel = pair
    ctx, state = jax_prefilled(jcfg, jmodel, params, seed=5)
    rng = np.random.default_rng(6)

    def noisy(tree):  # a second pool that differs from the first in every leaf
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32)
                       if np.issubdtype(np.asarray(a).dtype, np.floating)
                       else ~np.asarray(a) if np.asarray(a).dtype == bool
                       else np.asarray(a) + 1), tree)

    new_ctx, new_state = noisy(ctx), noisy(state)
    G = jcfg.dataset.activity_net.max_gt_target_segments
    replace = np.array([True, False, True, False, False, True])
    ref_ctx, ref_state = jmodel.merge_serve_slots(ctx, state, new_ctx, new_state,
                                                  jnp.array(replace), G)

    def torch_tree(tree):
        return jax.tree_util.tree_map(to_torch, tree)

    got_ctx, got_state = tmodel.merge_serve_slots(
        torch_tree(ctx), torch_tree(state), torch_tree(new_ctx), torch_tree(new_state),
        torch.from_numpy(replace), G)
    ref_leaves = jax.tree_util.tree_leaves_with_path({"ctx": ref_ctx, "state": ref_state})
    got_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.numpy(), {"ctx": got_ctx, "state": got_state}))
    assert len(got_leaves) == len(ref_leaves) > 0
    for (path, g), (_, r) in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=jax.tree_util.keystr(path))
    # the unreplaced slot keeps the old pool, the replaced ones take the new
    np.testing.assert_array_equal(got_state["t"].numpy(),
                                  np.where(replace, new_state["t"], state["t"]))


def test_pieces_reproduce_forward_serve(pair):
    """Prefill, then chunks until every video is done, then the trailing
    token: the captions of the port's own forward_serve, token for token."""
    jcfg, _, _, tmodel = pair
    rng = np.random.default_rng(8)
    T = jcfg.dataset.activity_net.video_rescale_len
    video = torch.from_numpy(rng.normal(size=(3, T, jcfg.dvc.detr.feature_dim))
                             .astype(np.float32))
    mask = torch.zeros((3, T), dtype=torch.bool)
    durations = torch.tensor([20.0, 50.0, 90.0])
    ref = tmodel.forward_serve(video, mask, durations)
    ctx, state = tmodel.forward_serve_prefill(video, mask, durations)
    active = torch.ones(3, dtype=torch.bool)
    for _ in range(tmodel.seq_len):
        tmodel.forward_serve_decode_chunk(ctx, state, active, 2)
    captions = state["captions"]
    tail = torch.where((captions == tmodel.eos_idx).any(dim=1), tmodel.pad_idx, tmodel.eos_idx)
    full = torch.cat([captions, tail[:, None]], dim=1).view(3, tmodel.max_gt, -1)
    assert torch.equal(full, ref["captions"])
    for key in ("segments", "k", "scores", "valid"):
        assert torch.equal(ctx[key], ref[key]), key
