"""Deterministic word-hash tokenizer and batch padding (copy of
``audio_rag_tpu/text/tokenizer.py::HashWordTokenizer``/``pad_batch``).

Equal words map to equal ids, stable across processes and across the two
packages, so the port's sparse/lexical retrieval matches the JAX package's
token for token.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

__all__ = ["HashWordTokenizer", "pad_batch"]

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")


class HashWordTokenizer:
    """ids: 0=pad, 1=cls/bos, 2=sep/eos, 3=unk; words hash into
    [n_special, vocab)."""

    n_special = 4

    def __init__(self, vocab_size: int = 30000):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.cls_id = 1
        self.sep_id = 2
        self.unk_id = 3
        self.eos_id = self.sep_id
        self._reverse: dict[int, str] = {}

    def _word_id(self, word: str) -> int:
        h = hashlib.blake2s(word.encode(), digest_size=8).digest()
        wid = self.n_special + int.from_bytes(h, "little") % (
            self.vocab_size - self.n_special
        )
        self._reverse.setdefault(wid, word)
        return wid

    def tokenize_words(self, text: str) -> list[str]:
        return _WORD_RE.findall(text.lower())

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        ids = [self._word_id(w) for w in self.tokenize_words(text)]
        if add_special:
            return [self.cls_id, *ids, self.sep_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        words = [
            self._reverse.get(int(i), "<unk>")
            for i in ids
            if int(i) >= self.n_special
        ]
        return " ".join(words)


def pad_batch(
    seqs: list[list[int]], max_len: int, pad_id: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad to (B, max_len) int32 + attention mask."""
    B = len(seqs)
    out = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.int32)
    for i, s in enumerate(seqs):
        s = s[:max_len]
        out[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return out, mask
