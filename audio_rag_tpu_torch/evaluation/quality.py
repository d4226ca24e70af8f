"""Discriminating retrieval-quality sweep (counterpart of
``audio_rag_tpu/evaluation/quality.py``).

Runs the synthetic corpus (:mod:`audio_rag_tpu_torch.evaluation.corpus`)
through the port's :class:`~audio_rag_tpu_torch.engine.query_engine.
QueryEngine` under each retrieval config (dense, sparse, hybrid,
hybrid+rerank, contextual headers on, and PRF query expansion) with the
committed trained tiny models (``eval-small`` embedder and reranker).
Every stage has query types that isolate its mechanism, so a ranking
regression in any stage moves the numbers.

The audio-in variant speaks every chunk in the charvoice and transcribes it
with the trained tiny ASR before embedding; relevance is still judged on
the ground-truth text (``metadata["gt_text"]``, else ``original_text``).
Each setup function takes ``device`` ("cuda" by default).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from audio_rag_tpu_torch.evaluation.corpus import (
    SynthCorpus,
    extend_corpus,
    make_corpus,
)

__all__ = ["build_eval_setup", "build_eval_setup_audio",
           "transcribe_corpus", "run_quality_sweep", "SWEEP_CONFIGS"]

#: (label, search_type, rerank, store, prf)
SWEEP_CONFIGS = [
    ("dense", "dense", False, "base", False),
    ("sparse", "sparse", False, "base", False),
    ("hybrid", "hybrid", False, "base", False),
    ("hybrid+rerank", "hybrid", True, "base", False),
    # contextual headers change what is embedded (store side); expansion
    # changes what is searched (query side)
    ("hybrid+context", "hybrid", False, "ctx", False),
    ("hybrid+context+prf", "hybrid", False, "ctx", True),
]


def _make_chunks(texts: list[str], gt: list[str] | None = None) -> list:
    from audio_rag_tpu_torch.core.types import AudioChunk

    return [
        AudioChunk(t, float(i) * 30.0, float(i + 1) * 30.0,
                   speaker=f"SPEAKER_{i % 2:02d}", chunk_id=f"c{i:03d}",
                   metadata={} if gt is None else {"gt_text": gt[i]})
        for i, t in enumerate(texts)
    ]


def _engines(chunks: list, groups, device: torch.device | str) -> dict:
    """``base`` embeds the chunks as they are, ``ctx`` after the extractive
    contextual stage ran over each recording (``groups``); one trained
    embedder and reranker serve both."""
    from audio_rag_tpu_torch.config import (
        ContextualConfig,
        EmbeddingConfig,
        RerankingConfig,
        RetrievalConfig,
    )
    from audio_rag_tpu_torch.contextual.processor import ContextualProcessor
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.engine.query_engine import QueryEngine
    from audio_rag_tpu_torch.reranking.bge import BGEReranker
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    emb = BGEM3Embedder(EmbeddingConfig(model="eval-small"), device=device)
    emb.load()
    rr = BGEReranker(RerankingConfig(model="eval-small",
                                     fused_doc_tokens=32), device=device)
    rr.load()

    engines: dict[str, QueryEngine] = {}
    store = VectorStore(RetrievalConfig(capacity_step=256), device=device)
    store.add(chunks, emb.embed([c.text for c in chunks]))
    engines["base"] = QueryEngine(emb, store, rr)

    proc = ContextualProcessor(ContextualConfig(
        enabled=True, backend="extractive", window_size=1))
    ctx_chunks = []
    for a, b in groups or [(0, len(chunks))]:
        ctx_chunks.extend(proc.process_chunks(chunks[a:b]))
    ctx_store = VectorStore(RetrievalConfig(capacity_step=256),
                            device=device)
    ctx_store.add(ctx_chunks, emb.embed([c.text for c in ctx_chunks]))
    engines["ctx"] = QueryEngine(emb, ctx_store, rr)
    return engines


def build_eval_setup(corpus: SynthCorpus | None = None,
                     device: torch.device | str = "cuda"):
    """(engines, corpus): ``engines`` maps store flavour ("base", "ctx") →
    QueryEngine over the corpus's chunk texts."""
    corpus = corpus or extend_corpus(make_corpus())
    return _engines(_make_chunks(corpus.chunks), corpus.doc_groups,
                    device), corpus


def transcribe_corpus(texts: list[str], asr=None, seed: int = 4242,
                      noise_level: float = 0.01,
                      device: torch.device | str = "cuda") -> list[str]:
    """Speak each text in the charvoice and transcribe it with the trained
    tiny ASR through the product transcribe path (6 s windows → mel →
    batched greedy decode → char codec): the hypothesis texts."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR, synth_text

    if asr is None:
        from audio_rag_tpu_torch.asr.whisper import WhisperASR
        from audio_rag_tpu_torch.config import ASRConfig

        asr = WhisperASR(ASRConfig(
            model_size="tiny-synth", compute_type="float32",
            vad_filter=False, temperature_fallback=False,
            window_batch_size=4), device=device)
    if not asr.is_loaded:
        asr.load()
    rng = np.random.default_rng(seed)
    hyps = []
    for text in texts:
        wav = synth_text(text, rng, noise_level=noise_level)
        segs = asr.transcribe(wav, SR)
        hyps.append(" ".join(s.text for s in segs))
    return hyps


def build_eval_setup_audio(corpus: SynthCorpus | None = None, asr=None,
                           device: torch.device | str = "cuda"):
    """Audio-in ladder: every corpus chunk goes speech → trained ASR → text
    before embedding; chunk boundaries stay 1:1 with the corpus and each
    chunk carries its ground-truth text under ``metadata["gt_text"]`` (the
    contextual stage keeps it), so transcription errors can only hurt the
    ranking, never the judge."""
    corpus = corpus or extend_corpus(make_corpus())
    hyps = transcribe_corpus(corpus.chunks, asr=asr, device=device)
    return _engines(_make_chunks(hyps, corpus.chunks), corpus.doc_groups,
                    device), corpus


def run_quality_sweep(
    engines=None,
    eval_set=None,
    top_k: int = 5,
    initial_k: int = 20,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Metrics per config, overall and per query type (paraphrase / tag /
    pair / context / mismatch): ``{config: {"p_at_5", "mrr", "ndcg",
    "hit_rate", "by_type": {type: {...}}}}``. Relevance is judged on each
    hit's ground-truth text, so a contextual header cannot satisfy a
    keyword by quoting a neighbour."""
    from audio_rag_tpu_torch.config import ExpansionConfig
    from audio_rag_tpu_torch.evaluation.metrics import RAGEvaluator
    from audio_rag_tpu_torch.expansion.prf import PRFExpander

    if engines is None:
        engines, corpus = build_eval_setup(device=device)
        eval_set = eval_set or corpus.eval_set
    assert eval_set is not None
    evaluator = RAGEvaluator(k=top_k)
    queries = [s.question for s in eval_set]

    out: dict[str, Any] = {}
    for label, stype, rerank, flavor, prf in SWEEP_CONFIGS:
        engine = engines[flavor]
        qs = queries
        if prf:
            expander = PRFExpander(
                ExpansionConfig(backend="prf"), engine.embedder,
                engine.store)
            qs = [expander.expand_single(q) for q in queries]
        rows = engine.query_batch(
            qs, top_k=top_k, search_type=stype,
            initial_k=initial_k, rerank=rerank,
        )
        per_sample = []
        for sample, results in zip(eval_set, rows):
            results = [
                dataclasses.replace(
                    r, text=r.metadata.get(
                        "gt_text",
                        r.metadata.get("original_text", r.text)))
                for r in results
            ]
            m = evaluator.compute_retrieval_metrics(
                results, sample.relevance_keywords, k=top_k)
            per_sample.append((sample.metadata.get("type", "?"), m))

        def agg(ms):
            n = max(len(ms), 1)
            return {
                "p_at_5": round(sum(m.precision_at_k for m in ms) / n, 4),
                "mrr": round(sum(m.mrr for m in ms) / n, 4),
                "ndcg": round(sum(m.ndcg for m in ms) / n, 4),
                "hit_rate": round(sum(m.hit_rate for m in ms) / n, 4),
            }

        by_type = {}
        for t in sorted({t for t, _ in per_sample}):
            by_type[t] = agg([m for tt, m in per_sample if tt == t])
        out[label] = {**agg([m for _, m in per_sample]), "by_type": by_type}
    return out
