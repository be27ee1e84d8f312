"""Vocabulary and caption tokenizer; the port's copy of the JAX package's
``data/vocab.py``.

Specials ``<unk> <pad> <bos> <eos>`` take ids 0..3, then the tokens of the
training captions in first-seen order with at least ``min_freq``
occurrences. A vocabulary is saved as the pickle of its ``itos`` list, so a
``vocab.pkl`` written by either package loads in the other. The tokenizer is
a regex one that splits words, splits off punctuation and keeps
contractions as spacy does: "don't" -> ["do", "n't"].
"""

from __future__ import annotations

import pickle
import re
from collections import Counter
from typing import Dict, Iterable, List

_SPECIALS = ["<unk>", "<pad>", "<bos>", "<eos>"]

# contractions spacy splits as suffix tokens
_CONTRACTION = re.compile(r"(?i)(n't|'s|'re|'ve|'ll|'d|'m)$")
_TOKEN = re.compile(r"[A-Za-z0-9]+(?:'[A-Za-z0-9]+)*|[^\sA-Za-z0-9]")


def word_tokenize(text: str) -> List[str]:
    out: List[str] = []
    for tok in _TOKEN.findall(text):
        m = _CONTRACTION.search(tok)
        if m and m.start() > 0:
            out.append(tok[: m.start()])
            out.append(m.group(0))
        else:
            out.append(tok)
    return out


class _ItosUnpickler(pickle.Unpickler):
    """A vocabulary file holds a list of strings, which unpickles without
    any class; refusing every class keeps a crafted file from running code."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"a vocabulary file may not name {module}.{name}")


class Vocab:
    """stoi/itos mapping; an unknown token maps to ``<unk>``."""

    def __init__(self, itos: List[str]):
        self.itos = list(itos)
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}
        self.unk_idx = self.stoi["<unk>"]

    def __len__(self):
        return len(self.itos)

    def __getitem__(self, token: str) -> int:
        return self.stoi.get(token, self.unk_idx)

    def __contains__(self, token: str) -> bool:
        return token in self.stoi

    def get_itos(self) -> List[str]:
        return self.itos

    def lookup_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.itos[i] for i in ids]

    @property
    def pad_idx(self):
        return self.stoi["<pad>"]

    @property
    def bos_idx(self):
        return self.stoi["<bos>"]

    @property
    def eos_idx(self):
        return self.stoi["<eos>"]

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.itos, f)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path, "rb") as f:
            itos = _ItosUnpickler(f).load()
        if not (isinstance(itos, list) and all(isinstance(w, str) for w in itos)):
            raise ValueError(f"{path} does not hold a list of strings")
        return cls(itos)


def build_vocab(annotations: Dict, min_freq: int = 2) -> Vocab:
    """annotations: {vid: {'sentences': [...]}} (train split)."""
    counter: Counter = Counter()
    for value in annotations.values():
        for caption in value["sentences"]:
            counter.update(word_tokenize(caption.lower()))
    # specials first, then tokens in first-seen order with freq >= min_freq
    itos = list(_SPECIALS)
    for tok, freq in counter.items():
        if freq >= min_freq:
            itos.append(tok)
    return Vocab(itos)
