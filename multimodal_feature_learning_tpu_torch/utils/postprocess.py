"""Host-side postprocessing of predictions, as the JAX package's
``utils/postprocess.py`` does it: caption ids to strings (``pre_process``,
``captions_to_string``, on the port's ``data.vocab.Vocab``), the submission
JSON (``get_sample_submission``, ``save_submission``) and the averaged
scores with F1 (``pprint_eval_scores``). The port keeps its own copy: it
imports nothing of the JAX package."""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

PUNCTUATION = (".", ",", "/", "'")


def pre_process(captions: List[str]) -> List[str]:
    """Drop consecutive repeated words and stray punctuation after the first
    word, in place; returns the list."""
    for i, caption in enumerate(captions):
        tokens = caption.split()
        if not tokens:
            captions[i] = ""
            continue
        kept = [tokens[0]]
        for tok in tokens[1:]:
            if tok in PUNCTUATION or kept[-1] == tok:
                continue
            kept.append(tok)
        captions[i] = " ".join(kept)
    return captions


def captions_to_string(captions: Iterable[Iterable[int]], vocab) -> List[str]:
    """Token-id rows -> strings: drop <pad>, <bos>, <eos> and <unk>, then the
    first and the last remaining word (the reference model's quirk, kept so
    that served strings are the JAX server's), then ``pre_process``."""
    unwanted = {vocab.pad_idx, vocab.bos_idx, vocab.eos_idx, vocab.stoi["<unk>"]}
    out = []
    for caption in captions:
        words = [vocab.itos[int(t)] for t in caption if int(t) not in unwanted]
        out.append(" ".join(words[1:-1]))
    return pre_process(out)


def get_sample_submission() -> Dict:
    """The empty submission: ``results`` maps a video key to its events."""
    return {
        "version": "VERSION 1.0",
        "results": {},
        "external_data": {"used": True, "details": "DVC"},
    }


def save_submission(json_data: Dict, json_file_path: str):
    with open(json_file_path, "w") as f:
        json.dump(json_data, f, indent=4)


def pprint_eval_scores(scores: Dict, debug: bool = False) -> Dict:
    """Each list of per-tIoU scores -> 100 x its mean (other entries kept),
    plus ``F1_score`` of the averaged Precision and Recall."""
    avg_scores = {}
    for metric in scores:
        if isinstance(scores[metric], list):
            score = scores[metric]
            avg_scores[metric] = 100 * sum(score) / float(len(score))
            if debug:
                print("| %s: %2.4f" % (metric, avg_scores[metric]))
        else:
            avg_scores[metric] = scores[metric]
    if (avg_scores.get("Precision", 0) + avg_scores.get("Recall", 0)) > 0:
        avg_scores["F1_score"] = (
            2 * avg_scores["Precision"] * avg_scores["Recall"]
            / (avg_scores["Precision"] + avg_scores["Recall"])
        )
    else:
        avg_scores["F1_score"] = 0.0
    return avg_scores
