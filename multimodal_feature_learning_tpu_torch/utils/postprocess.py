"""Caption ids to strings, as the JAX package's ``utils/postprocess.py``
(``pre_process``, ``captions_to_string``) turns them, on the port's
``data.vocab.Vocab``. The port keeps its own copy: it imports nothing of
the JAX package."""

from __future__ import annotations

from typing import Iterable, List

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
