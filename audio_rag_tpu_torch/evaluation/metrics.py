"""RAG evaluation harness (counterpart of
``audio_rag_tpu/evaluation/metrics.py``):

* retrieval metrics with keyword-substring relevance: precision@k,
  recall@k, MRR, NDCG, hit rate;
* generation metrics: semantic similarity (the embedder's cosine),
  entailment (the NLI scorer, else the reranker's sigmoid), unigram BLEU;
* the LLM-judged quartet (faithfulness, answer relevancy, context
  precision, context recall), judged by the port's generator;
* a dataset sweep across search types with average and p95 latency and a
  printable report.

A judge that fails scores 0.0 and logs, as in the JAX package: the
evaluator measures, it does not serve answers.
"""

from __future__ import annotations

import logging
import math
import re
import time
from dataclasses import asdict, dataclass
from typing import Any

import numpy as np

from audio_rag_tpu_torch.evaluation.dataset import EvalDataset, EvalSample

log = logging.getLogger(__name__)

__all__ = [
    "RetrievalMetrics",
    "GenerationMetrics",
    "EvaluationResult",
    "RAGEvaluator",
]


@dataclass
class RetrievalMetrics:
    precision_at_k: float = 0.0
    recall_at_k: float = 0.0
    mrr: float = 0.0
    ndcg: float = 0.0
    hit_rate: float = 0.0
    num_retrieved: int = 0
    num_relevant: int = 0


@dataclass
class GenerationMetrics:
    semantic_similarity: float | None = None
    entailment_score: float | None = None
    bleu_unigram: float = 0.0
    answer_length: int = 0


@dataclass
class EvaluationResult:
    question: str
    search_type: str
    retrieval: RetrievalMetrics
    generation: GenerationMetrics | None
    latency_s: float
    answer: str | None = None
    #: LLM-judged RAGAS quartet (faithfulness / answer_relevancy /
    #: context_precision / context_recall) when requested
    ragas: dict[str, float] | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "question": self.question,
            "search_type": self.search_type,
            "retrieval": asdict(self.retrieval),
            "generation": asdict(self.generation)
            if self.generation else None,
            "latency_s": self.latency_s,
            "ragas": self.ragas,
        }


def _is_relevant(text: str, keywords: list[str]) -> bool:
    """Keyword-substring relevance (reference metrics.py:163-176)."""
    low = text.lower()
    return any(k.lower() in low for k in keywords)


class RAGEvaluator:
    def __init__(self, embedder=None, reranker=None, generator=None,
                 k: int = 5, nli=None, device: str = "cuda"):
        #: embedder for semantic similarity (optional)
        self.embedder = embedder
        #: cross-encoder relevance scoring — LAST-RESORT entailment proxy
        self.reranker = reranker
        #: LLM judge for faithfulness (optional)
        self.generator = generator
        #: real NLI scorer (evaluation/nli.py); built lazily when None
        self._nli = nli
        self._nli_tried = nli is not None
        self.k = k
        #: where a lazily built NLI scorer runs
        self.device = device

    @property
    def nli(self):
        if not self._nli_tried:
            self._nli_tried = True
            try:
                from audio_rag_tpu_torch.evaluation.nli import NLIScorer

                self._nli = NLIScorer(device=self.device)
            except Exception as exc:
                log.warning("NLI scorer unavailable: %s", exc)
        return self._nli

    # -- retrieval ---------------------------------------------------------
    def compute_retrieval_metrics(
        self, results: list, keywords: list[str], k: int | None = None
    ) -> RetrievalMetrics:
        k = k or self.k
        top = results[:k]
        if not top or not keywords:
            return RetrievalMetrics(num_retrieved=len(top))
        rel = [_is_relevant(r.text, keywords) for r in top]
        n_rel = sum(rel)
        precision = n_rel / len(top)
        # recall denominator: relevant among all retrieved (reference
        # semantics — no ground-truth corpus labels exist)
        all_rel = sum(
            1 for r in results if _is_relevant(r.text, keywords)
        )
        recall = n_rel / all_rel if all_rel else 0.0
        mrr = 0.0
        for i, flag in enumerate(rel):
            if flag:
                mrr = 1.0 / (i + 1)
                break
        dcg = sum(
            (1.0 if flag else 0.0) / math.log2(i + 2)
            for i, flag in enumerate(rel)
        )
        ideal = sum(1.0 / math.log2(i + 2) for i in range(n_rel))
        ndcg = dcg / ideal if ideal else 0.0
        return RetrievalMetrics(
            precision_at_k=round(precision, 4),
            recall_at_k=round(recall, 4),
            mrr=round(mrr, 4),
            ndcg=round(ndcg, 4),
            hit_rate=1.0 if n_rel else 0.0,
            num_retrieved=len(top),
            num_relevant=n_rel,
        )

    # -- generation --------------------------------------------------------
    @staticmethod
    def _unigram_bleu(candidate: str, reference: str) -> float:
        """Clipped unigram precision (reference metrics.py:240-251)."""
        cand = re.findall(r"[a-z0-9']+", candidate.lower())
        ref = re.findall(r"[a-z0-9']+", reference.lower())
        if not cand:
            return 0.0
        ref_counts: dict[str, int] = {}
        for w in ref:
            ref_counts[w] = ref_counts.get(w, 0) + 1
        clipped = 0
        for w in cand:
            if ref_counts.get(w, 0) > 0:
                clipped += 1
                ref_counts[w] -= 1
        return round(clipped / len(cand), 4)

    def compute_generation_metrics(
        self, answer: str, reference: str
    ) -> GenerationMetrics:
        m = GenerationMetrics(
            bleu_unigram=self._unigram_bleu(answer, reference),
            answer_length=len(answer.split()),
        )
        if self.embedder is not None:
            try:
                a, b = self.embedder.embed([answer, reference])
                m.semantic_similarity = round(
                    float(np.dot(a.dense, b.dense)
                          / max(np.linalg.norm(a.dense)
                                * np.linalg.norm(b.dense), 1e-9)), 4
                )
            except Exception as exc:
                log.warning("semantic similarity failed: %s", exc)
        # real NLI (reference evaluation/metrics.py:132-161): P(entailment)
        # from a 3-class cross-encoder — relevance is NOT entailment, so
        # the reranker-sigmoid proxy only applies when no NLI model loads
        if self.nli is not None:
            try:
                m.entailment_score = round(
                    self.nli.entailment(reference, answer), 4)
                return m
            except Exception as exc:
                log.warning("NLI entailment failed: %s", exc)
        if self.reranker is not None and hasattr(self.reranker,
                                                "score_pairs"):
            try:
                score = float(
                    self.reranker.score_pairs(reference, [answer])[0]
                )
                m.entailment_score = round(1.0 / (1.0 + math.exp(-score)), 4)
            except Exception as exc:
                log.warning("entailment scoring failed: %s", exc)
        return m

    # -- LLM-judged RAGAS quartet ------------------------------------------
    # The reference computes faithfulness / answer relevancy / context
    # precision / context recall through the ragas library over Ollama
    # (reference evaluation/metrics.py:100-126,253-291). Here the same
    # four metrics are first-party LLM-judged, served by the on-mesh
    # generator, following each ragas metric's published semantics.

    def judge_faithfulness(
        self, question: str, answer: str, contexts: list[str]
    ) -> float | None:
        """Ask the generator whether the answer is grounded in the contexts
        (0-10 → 0-1). Replaces the reference's RAGAS-over-Ollama."""
        if self.generator is None:
            return None
        ctx = "\n---\n".join(c[:500] for c in contexts[:5])
        prompt = (
            "Rate 0-10 how well the ANSWER is supported by the CONTEXTS. "
            "Reply with a single number.\n\n"
            f"QUESTION: {question}\nANSWER: {answer}\nCONTEXTS:\n{ctx}\n\n"
            "Rating:"
        )
        try:
            raw = self.generator.generate(prompt, max_tokens=4,
                                          temperature=0.0)
            m = re.search(r"\d+(\.\d+)?", raw)
            return min(float(m.group()) / 10.0, 1.0) if m else None
        except Exception as exc:
            log.warning("faithfulness judge failed: %s", exc)
            return None

    def judge_answer_relevancy(
        self, question: str, answer: str, n_questions: int = 3
    ) -> float | None:
        """ragas AnswerRelevancy semantics: generate questions the ANSWER
        would answer, then score mean embedding cosine against the actual
        question (a relevant answer regenerates its own question; an
        evasive/off-topic one doesn't)."""
        if self.generator is None:
            return None
        gen_qs: list[str] = []
        for i in range(n_questions):
            prompt = (
                "Write one short question that the following ANSWER "
                "directly answers. Reply with only the question.\n\n"
                f"ANSWER: {answer[:800]}\n\nQUESTION:"
            )
            try:
                raw = self.generator.generate(
                    prompt, max_tokens=24,
                    temperature=0.0 if i == 0 else 0.7,
                )
            except Exception as exc:
                log.warning("answer-relevancy judge failed: %s", exc)
                return None
            q = raw.strip().splitlines()[0].strip() if raw.strip() else ""
            if q:
                gen_qs.append(q)
        if not gen_qs:
            return 0.0
        if self.embedder is not None:
            try:
                embs = self.embedder.embed([question] + gen_qs)
                q0 = embs[0].dense
                sims = [
                    float(np.dot(q0, e.dense)
                          / max(np.linalg.norm(q0)
                                * np.linalg.norm(e.dense), 1e-9))
                    for e in embs[1:]
                ]
                return round(float(np.mean(sims)), 4)
            except Exception as exc:
                log.warning("answer-relevancy embed failed: %s", exc)
        # no embedder: lexical-overlap fallback
        return round(float(np.mean(
            [self._unigram_bleu(q, question) for q in gen_qs])), 4)

    def judge_context_precision(
        self, question: str, contexts: list[str],
        ground_truth: str | None = None,
    ) -> float | None:
        """ragas ContextPrecision semantics: per-context LLM verdict
        "useful for answering?", aggregated as rank-weighted mean
        precision@i over the useful positions — useful contexts ranked
        low drag the score down."""
        if self.generator is None or not contexts:
            return None
        verdicts: list[bool] = []
        for c in contexts[:5]:
            ref = f"\nREFERENCE ANSWER: {ground_truth[:400]}" \
                if ground_truth else ""
            prompt = (
                "Is the CONTEXT useful for answering the QUESTION? "
                "Reply yes or no.\n\n"
                f"QUESTION: {question}{ref}\n"
                f"CONTEXT: {c[:500]}\n\nVerdict:"
            )
            try:
                raw = self.generator.generate(prompt, max_tokens=3,
                                              temperature=0.0)
            except Exception as exc:
                log.warning("context-precision judge failed: %s", exc)
                return None
            verdicts.append("yes" in raw.lower())
        hits, acc = 0, 0.0
        for i, v in enumerate(verdicts):
            if v:
                hits += 1
                acc += hits / (i + 1)
        return round(acc / hits, 4) if hits else 0.0

    def judge_context_recall(
        self, contexts: list[str], ground_truth: str,
        max_statements: int = 8,
    ) -> float | None:
        """ragas ContextRecall semantics: split the ground-truth answer
        into statements, ask per statement whether it can be attributed
        to the retrieved contexts; recall = attributed fraction."""
        if self.generator is None or not ground_truth.strip():
            return None
        statements = [
            s.strip() for s in re.split(r"(?<=[.!?])\s+", ground_truth)
            if s.strip()
        ][:max_statements]
        if not statements:
            return None
        ctx = "\n---\n".join(c[:500] for c in contexts[:5])
        attributed = 0
        for s in statements:
            prompt = (
                "Can the STATEMENT be attributed to (supported by) the "
                "CONTEXTS? Reply yes or no.\n\n"
                f"CONTEXTS:\n{ctx}\n\nSTATEMENT: {s}\n\nVerdict:"
            )
            try:
                raw = self.generator.generate(prompt, max_tokens=3,
                                              temperature=0.0)
            except Exception as exc:
                log.warning("context-recall judge failed: %s", exc)
                return None
            attributed += int("yes" in raw.lower())
        return round(attributed / len(statements), 4)

    def compute_ragas_metrics(
        self,
        question: str,
        answer: str,
        contexts: list[str],
        ground_truth: str,
    ) -> dict[str, float]:
        """The full quartet (reference ``compute_ragas_metrics``,
        evaluation/metrics.py:253-291): judge failures score 0.0 like the
        reference's per-metric except handler; returns {} with no judge."""
        if self.generator is None:
            return {}
        out: dict[str, float] = {}
        for name, fn in (
            ("faithfulness",
             lambda: self.judge_faithfulness(question, answer, contexts)),
            ("answer_relevancy",
             lambda: self.judge_answer_relevancy(question, answer)),
            ("context_precision",
             lambda: self.judge_context_precision(
                 question, contexts, ground_truth)),
            ("context_recall",
             lambda: self.judge_context_recall(contexts, ground_truth)),
        ):
            v = fn()
            out[name] = float(v) if v is not None else 0.0
        return out

    # -- dataset sweep -----------------------------------------------------
    def evaluate_dataset(
        self,
        pipeline,
        dataset: EvalDataset,
        search_types: list[str] = ("dense", "hybrid"),
        generate_answers: bool = False,
        use_hyde: bool = False,
        compute_ragas: bool = False,
    ) -> list[EvaluationResult]:
        results: list[EvaluationResult] = []
        for search_type in search_types:
            for sample in dataset:
                results.append(
                    self._evaluate_sample(
                        pipeline, sample, search_type,
                        generate_answers, use_hyde, compute_ragas,
                    )
                )
        return results

    def _evaluate_sample(
        self, pipeline, sample: EvalSample, search_type: str,
        generate_answers: bool, use_hyde: bool,
        compute_ragas: bool = False,
    ) -> EvaluationResult:
        t0 = time.perf_counter()
        out = pipeline.query(
            sample.question,
            search_type=search_type,
            top_k=self.k,
            use_hyde=use_hyde,
            generate_answer=generate_answers,
        )
        latency = time.perf_counter() - t0
        retrieval = self.compute_retrieval_metrics(
            out.results, sample.relevance_keywords
        )
        generation = None
        if generate_answers and out.answer:
            generation = self.compute_generation_metrics(
                out.answer, sample.reference_answer
            )
        ragas = None
        if compute_ragas and out.answer:
            ragas = self.compute_ragas_metrics(
                sample.question, out.answer,
                [r.text for r in out.results],
                sample.reference_answer,
            ) or None
        return EvaluationResult(
            question=sample.question,
            search_type=search_type,
            retrieval=retrieval,
            generation=generation,
            latency_s=round(latency, 4),
            answer=out.answer,
            ragas=ragas,
        )

    # -- summary -----------------------------------------------------------
    @staticmethod
    def summarize_results(
        results: list[EvaluationResult],
    ) -> dict[str, dict[str, float]]:
        """Per-search-type averages + latency percentiles
        (reference metrics.py:394-428)."""
        by_type: dict[str, list[EvaluationResult]] = {}
        for r in results:
            by_type.setdefault(r.search_type, []).append(r)
        summary: dict[str, dict[str, float]] = {}
        for stype, rs in by_type.items():
            lat = np.array([r.latency_s for r in rs])
            entry = {
                "precision_at_k": float(np.mean(
                    [r.retrieval.precision_at_k for r in rs])),
                "recall_at_k": float(np.mean(
                    [r.retrieval.recall_at_k for r in rs])),
                "mrr": float(np.mean([r.retrieval.mrr for r in rs])),
                "ndcg": float(np.mean([r.retrieval.ndcg for r in rs])),
                "hit_rate": float(np.mean(
                    [r.retrieval.hit_rate for r in rs])),
                "avg_latency_s": float(lat.mean()),
                "p95_latency_s": float(np.percentile(lat, 95)),
                "n": len(rs),
            }
            gens = [r.generation for r in rs if r.generation]
            if gens:
                entry["bleu_unigram"] = float(np.mean(
                    [g.bleu_unigram for g in gens]))
                sims = [g.semantic_similarity for g in gens
                        if g.semantic_similarity is not None]
                if sims:
                    entry["semantic_similarity"] = float(np.mean(sims))
            rag = [r.ragas for r in rs if r.ragas]
            for key in ("faithfulness", "answer_relevancy",
                        "context_precision", "context_recall"):
                vals = [d[key] for d in rag if key in d]
                if vals:
                    entry[key] = float(np.mean(vals))
            summary[stype] = {k: round(v, 4) for k, v in entry.items()}
        return summary

    @staticmethod
    def print_summary(summary: dict[str, dict[str, float]]) -> str:
        lines = [f"{'':<12}" + "".join(
            f"{s:>12}" for s in summary
        )]
        metrics = sorted(
            {m for v in summary.values() for m in v}
        )
        for m in metrics:
            lines.append(
                f"{m:<20}" + "".join(
                    f"{summary[s].get(m, float('nan')):>12.4f}"
                    for s in summary
                )
            )
        report = "\n".join(lines)
        print(report)
        return report
