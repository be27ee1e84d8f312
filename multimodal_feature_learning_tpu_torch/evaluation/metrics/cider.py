"""CIDEr (Vedantam et al. 2015), COCO-caption conventions.

TF-IDF over n-grams (n = 1..4) with document frequency computed from the
reference set of the call (the ANET evaluator scores per video, so the "corpus"
is that video's matched pairs — same as the reference pipeline's behavior),
length-penalized cosine similarity (sigma = 6), averaged over n and scaled by 10.

The port's copy of the JAX package's ``evaluation/metrics/cider.py``, kept
line for line so that both score a submission to the same float.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from math import exp, log, sqrt
from typing import Dict, List, Tuple

import numpy as np


def _ngram_counts(tokens: List[str], n_max: int = 4) -> Counter:
    counts: Counter = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self):
        return "CIDEr"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        keys = list(gts.keys())
        crefs = [[_ngram_counts(r.split(), self.n) for r in gts[k]] for k in keys]
        ctest = [_ngram_counts(res[k][0].split(), self.n) for k in keys]

        # document frequency over reference "documents" (videos in this call)
        doc_freq: Counter = Counter()
        for refs in crefs:
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1
        ref_count = float(max(len(crefs), 1))

        def tfidf_vec(cnts: Counter):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, tf in cnts.items():
                df = log(max(1.0, doc_freq[ng]))
                k = len(ng) - 1
                vec[k][ng] = float(tf) * (log(ref_count) - df)
                norm[k] += vec[k][ng] ** 2
                if k == 0:
                    length += tf
            return vec, [sqrt(x) for x in norm], length

        def sim(vh, nh, lh, vr, nr, lr):
            delta = float(lh - lr)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ng, w in vh[k].items():
                    # COCO quirk: min on the hyp weight only
                    val[k] += min(w, vr[k].get(ng, 0.0)) * vr[k].get(ng, 0.0)
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= exp(-(delta**2) / (2 * self.sigma**2))
            return val

        scores = []
        for refs, hyp in zip(crefs, ctest):
            vh, nh, lh = tfidf_vec(hyp)
            score = np.zeros(self.n)
            for ref in refs:
                vr, nr, lr = tfidf_vec(ref)
                score += sim(vh, nh, lh, vr, nr, lr)
            score_avg = np.mean(score / max(len(refs), 1)) * 10.0
            scores.append(float(score_avg))

        mean = float(np.mean(scores)) if scores else 0.0
        return mean, scores
