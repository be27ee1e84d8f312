"""Measurement tools of the port, each run as
``python3 -m multimodal_feature_learning_tpu_torch.tools.<name>`` on the card
(the default device) and each with a ``run()`` that returns its rows.

- ``probe_op_overhead``: the marginal cost of one op in a chain, eager and
  replayed from a CUDA graph, K5 included;
- ``profile_msda``: the MSDA kernels (K1, K2) against the plain core;
- ``profile_decode``: the serving forward against its proposal half, and
  the decode's cost per token and per layer;
- ``bench_fused_decode``: ``forward_eval(batch, "serve")`` per decode
  backend, the arms interleaved;
- ``onchip_decode_parity``: each fused decode backend's tokens against the
  plain-op decode's, with trained weights;
- ``load_test_serve``: the serving CLI, static and continuous, over offered
  rates and chunk sizes (its ``run()`` returns a row a point).
"""
