"""Minimal vocabulary for turning caption ids into words; the port's copy of
what serving needs from the JAX ``data/vocab.py::Vocab`` (strings are made
by ``utils.postprocess.captions_to_string``)."""

from __future__ import annotations

from typing import List


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
