"""serve_p95_ms: the 95th percentile of the latency of every request due
inside the window, from its due time to its answer (answers after the
window's close count); a failed request counts as never answered."""

import math

import numpy as np


def read(run):
    if run.kind != "serve" or not run.records:
        return None
    lat = [(r["done"] - r["due"]) * 1e3 if "events" in r else math.inf for r in run.records]
    return float(np.percentile(lat, 95))
