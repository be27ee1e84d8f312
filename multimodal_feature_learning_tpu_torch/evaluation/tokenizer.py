"""Caption tokenizer for scoring.

The reference scores through pycocoevalcap's PTBTokenizer, which shells out to
the Stanford CoreNLP Java jar (evaluation/evaluate.py:241-242; the submodule is
empty in the reference snapshot and needs a JVM).  This is a dependency-free
Python reimplementation of the same observable behavior: lowercase,
PTB-style word splitting, and removal of the same punctuation set the COCO
tokenizer strips.  The evaluator takes any callable with this signature, so a
Java-backed tokenizer can be swapped in where bit-exact METEOR comparison
against the reference pipeline is required.

The port's copy of the JAX package's ``evaluation/tokenizer.py``, kept line
for line so that both score a submission to the same float.
"""

from __future__ import annotations

import re
from typing import Dict, List

# punctuation removed by the COCO caption tokenizer
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_WORD = re.compile(r"[^\s]+")
# separate punctuation from words PTB-style
_SPLIT = re.compile(r"([\.\,\?\!\:\;\"\(\)\[\]\{\}]|'s|'re|'ve|n't|'ll|'d|'m)")


def ptb_tokenize_line(line: str) -> List[str]:
    line = line.replace("-LRB-", "(").replace("-RRB-", ")")
    out: List[str] = []
    for chunk in _WORD.findall(line.lower()):
        pieces = [p for p in _SPLIT.split(chunk) if p]
        out.extend(p for p in pieces if p not in PUNCTUATIONS)
    return out


class PTBTokenizer:
    """pycocoevalcap-compatible interface: {key: [{'caption': str}]} ->
    {key: [str]} with each caption tokenized to a space-joined string."""

    def tokenize(self, captions_for_image: Dict) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for k, caps in captions_for_image.items():
            out[k] = [" ".join(ptb_tokenize_line(c["caption"])) for c in caps]
        return out
