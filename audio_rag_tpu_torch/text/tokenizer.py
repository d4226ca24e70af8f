"""Deterministic word-hash tokenizer and batch padding (copy of
``audio_rag_tpu/text/tokenizer.py::HashWordTokenizer``/``pad_batch``/
``get_tokenizer``/``norm_tokens``), the cross-encoder's pair layout
included, and the generator's reverse-map side file.

Equal words map to equal ids, stable across processes and across the two
packages, so the port's sparse/lexical retrieval matches the JAX package's
token for token. The JAX package reads a checkpoint directory's
HuggingFace tokenizer files through ``transformers``; the port has no
reader of them yet, so :func:`get_tokenizer` refuses a directory that
holds some rather than tokenize otherwise than the JAX package would.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Sequence

import numpy as np

from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = ["TOKENIZER_PATTERNS", "HashWordTokenizer", "get_tokenizer",
           "load_reverse_map", "refuse_tokenizer_files",
           "norm_tokens", "pad_batch"]

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")
_STRIP = ".,;:!?()[]\"'"


def norm_tokens(text: str) -> list[str]:
    """Lowercased whitespace tokens with edge punctuation stripped (the
    extractive headers' terms)."""
    return [w for w in (t.strip(_STRIP) for t in text.lower().split()) if w]


class HashWordTokenizer:
    """ids: 0=pad, 1=cls/bos, 2=sep/eos, 3=unk; words hash into
    [n_special, vocab). ``decode`` reads the reverse map of the words this
    instance has encoded (and of a side file, :func:`load_reverse_map`),
    or the map it is given (:meth:`known_words`); an id it has not seen
    decodes as ``<unk>``."""

    n_special = 4

    def __init__(self, vocab_size: int = 30000):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.cls_id = 1
        self.sep_id = 2
        self.unk_id = 3
        self.eos_id = self.sep_id
        self._reverse: dict[int, str] = {}
        #: the side file's id → word entries (:func:`load_reverse_map`)
        self._side: dict[int, str] = {}

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

    def decode(self, ids: Sequence[int],
               known: dict[int, str] | None = None) -> str:
        rev = self._reverse if known is None else known
        words = [
            rev.get(int(i), "<unk>")
            for i in ids
            if int(i) >= self.n_special
        ]
        return " ".join(words)

    def known_words(self, text: str) -> dict[int, str]:
        """The reverse map of the side file's words and then ``text``'s: a
        decode map that does not depend on what else this instance has
        encoded."""
        known = dict(self._side)
        for w in self.tokenize_words(text):
            known.setdefault(self._word_id(w), w)
        return known

    def encode_pair(self, a: str, b: str, max_len: int) -> list[int]:
        """RoBERTa pair layout: <s> a </s></s> b </s>, truncating ``b``."""
        ia = [self._word_id(w) for w in self.tokenize_words(a)]
        ib = [self._word_id(w) for w in self.tokenize_words(b)]
        budget = max_len - len(ia) - 4
        ib = ib[: max(budget, 0)]
        out = [self.cls_id, *ia, self.sep_id, self.sep_id, *ib, self.sep_id]
        return out[:max_len]


#: the files of a HuggingFace tokenizer, which the port cannot read yet
TOKENIZER_PATTERNS = ("tokenizer*.json", "vocab*", "merges.txt", "*.model")


def refuse_tokenizer_files(checkpoint_path: str | Path | None) -> None:
    """Raise ``ConfigError`` when a checkpoint directory holds
    HuggingFace tokenizer files: the JAX package would tokenize (or
    decode) with them, and the port cannot read them yet."""
    if not checkpoint_path or not Path(checkpoint_path).is_dir():
        return
    found = sorted({f.name for pat in TOKENIZER_PATTERNS
                    for f in Path(checkpoint_path).glob(pat)})
    if found:
        raise ConfigError(
            f"{checkpoint_path} holds HuggingFace tokenizer files "
            f"({', '.join(found)}), which the port cannot read yet "
            "(ROADMAP.md §1 item 2): it would tokenize otherwise than the "
            "JAX package. Remove them to use the hash tokenizer",
            context={"checkpoint_path": str(checkpoint_path)})


def get_tokenizer(checkpoint_path: str | Path | None = None,
                  vocab_size: int = 30000) -> HashWordTokenizer:
    """The hash tokenizer of ``vocab_size`` ids, as the JAX package's
    ``get_tokenizer`` gives without tokenizer files; a checkpoint
    directory that holds some raises (:func:`refuse_tokenizer_files`)."""
    refuse_tokenizer_files(checkpoint_path)
    return HashWordTokenizer(vocab_size)


def load_reverse_map(tok: HashWordTokenizer, path: str | Path) -> int:
    """Add a JSON side file's id → word entries to ``tok``'s reverse map
    where the id has no word yet, so that a fresh process decodes a
    trained model's emissions; returns the entries read (0 when the file
    is missing)."""
    p = Path(path)
    if not p.exists():
        return 0
    side = json.loads(p.read_text())
    for k, v in side.items():
        tok._reverse.setdefault(int(k), v)
        tok._side.setdefault(int(k), v)
    return len(side)


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
