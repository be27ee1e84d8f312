"""Corpus BLEU-1..4 (Papineni et al. 2002), exact pycocoevalcap semantics.

Replicates the pycocoevalcap ``BleuScorer`` as patched by the reference
(README.md:35-49: ``compute_score(option='closest', verbose=0)``):

* per-sentence cooked stats: ``guess[k] = max(len(hyp)-k, 0)``,
  ``correct[k]`` = ref-clipped n-gram matches;
* reference length per sentence: ``closest`` = min over refs by
  ``(abs(len(ref)-len(hyp)), len(ref))`` (ties -> shorter);
* cumulative-product precision with the COCO epsilons
  ``(correct+tiny)/(guess+small)``, n-th root, and the brevity penalty
  ``exp(1-1/ratio)`` applied only when ``ratio < 1`` with
  ``ratio = (testlen+tiny)/(reflen+small)`` — corpus-level for the returned
  score, per-sentence for the returned score lists.

The formulas below use the identical operation order (pow of the running
product, not exp/log) so results are bit-identical to pycocoevalcap.

The port's copy of the JAX package's ``evaluation/metrics/bleu.py``, kept
line for line so that both score a submission to the same float.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple


def _precook(words: List[str], n: int):
    """(length, ngram Counter) of a token list."""
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return len(words), counts


def _cook_refs(refs: List[str], n: int):
    """(ref lengths, max ngram counts over refs)."""
    reflen = []
    maxcounts: Counter = Counter()
    for ref in refs:
        rl, counts = _precook(ref.split(), n)
        reflen.append(rl)
        for ngram, count in counts.items():
            maxcounts[ngram] = max(maxcounts[ngram], count)
    return reflen, maxcounts


def _cook_test(test: str, reflen, refmaxcounts: Counter, n: int):
    testlen, counts = _precook(test.split(), n)
    result = {
        "testlen": testlen,
        "reflen": reflen,
        "guess": [max(0, testlen - k + 1) for k in range(1, n + 1)],
        "correct": [0] * n,
    }
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(refmaxcounts.get(ngram, 0), count)
    return result


def _single_reflen(reflens, option: str, testlen: int) -> float:
    if option == "shortest":
        return min(reflens)
    if option == "average":
        return float(sum(reflens)) / len(reflens)
    if option == "closest":
        return min(reflens, key=lambda ref: (abs(ref - testlen), ref))
    raise ValueError(f"unsupported reflen option {option!r}")


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self):
        return "Bleu"

    def compute_score(
        self, gts: Dict, res: Dict, option: str = "closest", verbose: int = 0
    ) -> Tuple[List[float], List[List[float]]]:
        n = self.n
        small = 1e-9
        tiny = 1e-15  # so that if guess is 0 still return 0
        bleu_list: List[List[float]] = [[] for _ in range(n)]

        total_testlen = 0
        total_reflen = 0.0
        totalcomps = {"guess": [0] * n, "correct": [0] * n}

        for key in gts:
            reflen_list, refmaxcounts = _cook_refs(gts[key], n)
            comps = _cook_test(res[key][0], reflen_list, refmaxcounts, n)

            testlen = comps["testlen"]
            total_testlen += testlen
            reflen = _single_reflen(comps["reflen"], option, testlen)
            total_reflen += reflen

            for k in range(n):
                totalcomps["guess"][k] += comps["guess"][k]
                totalcomps["correct"][k] += comps["correct"][k]

            # per-sentence bleu with its own brevity penalty
            bleu = 1.0
            for k in range(n):
                bleu *= (float(comps["correct"][k]) + tiny) / (
                    float(comps["guess"][k]) + small
                )
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        bleus: List[float] = []
        bleu = 1.0
        for k in range(n):
            bleu *= float(totalcomps["correct"][k] + tiny) / (
                totalcomps["guess"][k] + small
            )
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total_testlen + tiny) / (total_reflen + small)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)

        return bleus, bleu_list
