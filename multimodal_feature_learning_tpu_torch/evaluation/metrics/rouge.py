"""ROUGE-L (Lin 2004), COCO-caption conventions: per-candidate max over
references of the LCS F-measure with beta = 1.2, averaged over candidates.

The port's copy of the JAX package's ``evaluation/metrics/rouge.py``, kept
line for line so that both score a submission to the same float.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self):
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r = max(prec, default=0.0), max(rec, default=0.0)
        if p != 0 and r != 0:
            return ((1 + self.beta**2) * p * r) / (r + self.beta**2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [self.calc_score(res[k], gts[k]) for k in gts]
        avg = sum(scores) / len(scores) if scores else 0.0
        return avg, scores
