"""Minimal vocabulary for turning caption ids into words; the port's copy of
what serving needs from the JAX ``data/vocab.py::Vocab``."""

from __future__ import annotations

from typing import Iterable, List

SPECIALS = ["<unk>", "<pad>", "<bos>", "<eos>"]


class Vocab:
    def __init__(self, itos: List[str]):
        self.itos = list(itos)
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    def __len__(self):
        return len(self.itos)

    @property
    def pad_idx(self):
        return self.stoi["<pad>"]

    @property
    def bos_idx(self):
        return self.stoi["<bos>"]

    @property
    def eos_idx(self):
        return self.stoi["<eos>"]

    def decode(self, ids: Iterable[int]) -> str:
        """Token ids -> words joined by spaces, special tokens dropped."""
        specials = {self.stoi[s] for s in SPECIALS if s in self.stoi}
        return " ".join(self.itos[int(i)] for i in ids if int(i) not in specials)
