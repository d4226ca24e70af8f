"""Word and character error rates (counterpart of
``audio_rag_tpu/evaluation/wer.py``, pure Python): Levenshtein alignment
over normalized word sequences, with corpus-level aggregation (total edits
over total reference words, the standard pooling, robust to short
utterances). ``scripts/eval_torch.py wer`` reports them for the committed
trained tiny ASR on held-out synthetic speech.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["wer", "wer_counts", "aggregate_wer", "cer", "WERCounts"]

_WORD_RE = re.compile(r"[a-z0-9']+")


def _words(text: str) -> list[str]:
    return _WORD_RE.findall(text.lower())


@dataclass
class WERCounts:
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0
    n_ref: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def wer(self) -> float:
        return self.errors / self.n_ref if self.n_ref else (
            0.0 if self.insertions == 0 else 1.0)


def wer_counts(reference: str, hypothesis: str) -> WERCounts:
    """Levenshtein S/D/I counts between word sequences (O(R·H) DP with
    backtrack-free count propagation: each cell carries (cost, s, d, i))."""
    ref, hyp = _words(reference), _words(hypothesis)
    R, H = len(ref), len(hyp)
    if R == 0:
        return WERCounts(insertions=H, n_ref=0)
    if H == 0:
        return WERCounts(deletions=R, n_ref=R)
    # row[j] = (cost, subs, dels, ins) for ref[:i] vs hyp[:j]
    row = [(j, 0, 0, j) for j in range(H + 1)]
    for i in range(1, R + 1):
        prev = row
        row = [(i, 0, i, 0)] + [None] * H  # type: ignore[list-item]
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                row[j] = prev[j - 1]
                continue
            sub = prev[j - 1]
            dele = prev[j]
            ins = row[j - 1]
            best = min(sub, dele, ins, key=lambda t: t[0])
            if best is sub:
                row[j] = (best[0] + 1, best[1] + 1, best[2], best[3])
            elif best is dele:
                row[j] = (best[0] + 1, best[1], best[2] + 1, best[3])
            else:
                row[j] = (best[0] + 1, best[1], best[2], best[3] + 1)
    cost, s, d, ins_ = row[H]
    assert cost == s + d + ins_
    return WERCounts(substitutions=s, deletions=d, insertions=ins_, n_ref=R)


def wer(reference: str, hypothesis: str) -> float:
    """Single-utterance word error rate (edits / reference words)."""
    return wer_counts(reference, hypothesis).wer


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate: Levenshtein distance over the normalized
    character stream / reference length. The natural companion metric for
    a char-level acoustic model (one wrong char fails a whole word under
    WER)."""
    ref = " ".join(_words(reference))
    hyp = " ".join(_words(hypothesis))
    if not ref:
        return 0.0 if not hyp else 1.0
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        row = [i] + [0] * len(hyp)
        for j, hc in enumerate(hyp, 1):
            row[j] = min(prev[j - 1] + (rc != hc), prev[j] + 1,
                         row[j - 1] + 1)
        prev = row
    return prev[-1] / len(ref)


def aggregate_wer(pairs: list[tuple[str, str]]) -> WERCounts:
    """Corpus-level WER over (reference, hypothesis) pairs: edit counts
    pool before dividing (per-utterance WERs do not average correctly)."""
    total = WERCounts()
    for ref, hyp in pairs:
        c = wer_counts(ref, hyp)
        total.substitutions += c.substitutions
        total.deletions += c.deletions
        total.insertions += c.insertions
        total.n_ref += c.n_ref
    return total
