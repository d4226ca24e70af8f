"""The port's evaluation against the JAX package's, on the CPU: WER and
CER (the JAX ``test_wer.py`` cases and more, equal counts and values), the
retrieval, generation and LLM-judged metrics (the JAX ``test_metrics.py``
cases through both packages, equal values), the datasets and the synthetic
corpus (equal), the NLI scorer (probabilities within 1e-5 of the JAX
``nli_forward`` in f32), the text quality sweep (every metric within 1e-4
of the JAX sweep, the JAX separation orderings asserted on the port's), the
fake-backend dataset sweep through both ``AudioRAG``s, and eight held-out
charvoice utterances transcribed by both tiny ASRs (equal hypotheses)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from audio_rag_tpu.config import loader as jloader
from audio_rag_tpu.core.types import EmbeddingResult as JaxEmbeddingResult
from audio_rag_tpu.core.types import RetrievalResult as JaxResult
from audio_rag_tpu.core.types import TranscriptSegment as JaxSegment
from audio_rag_tpu.evaluation import dataset as jdataset
from audio_rag_tpu.evaluation import metrics as jmetrics
from audio_rag_tpu.evaluation import wer as jwer
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu_torch.config import load_config
from audio_rag_tpu_torch.core.types import EmbeddingResult, RetrievalResult
from audio_rag_tpu_torch.core.types import TranscriptSegment
from audio_rag_tpu_torch.evaluation import dataset as tdataset
from audio_rag_tpu_torch.evaluation import metrics as tmetrics
from audio_rag_tpu_torch.evaluation import wer as twer
from audio_rag_tpu_torch.evaluation.quality import SWEEP_CONFIGS
from audio_rag_tpu_torch.pipeline import AudioRAG
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NOWHERE = ROOT / "configs" / "no-such-dir"  # no base.yaml: defaults only

# -- WER ------------------------------------------------------------------------

WER_CASES = [
    ("the cat sat", "the cat sat"),
    ("The cat, sat!", "the cat sat"),
    ("the cat sat", "the dog sat"),
    ("the cat sat", "the sat"),
    ("the cat", "the big cat"),
    ("a b c", "x y z"),
    ("a", "x y z"),
    ("a b", ""),
    ("", "a b"),
    ("", ""),
    ("a b c d", "a x c"),
    ("gradient descent minimizes the loss", "gradient decent minimize loss"),
    ("s017 covers bafoki alongside tamuzu", "s017 covers bafoki tamuzo x"),
    ("don't stop 42 now", "dont stop 4 2 now"),
]


@pytest.mark.parametrize("ref,hyp", WER_CASES)
def test_wer_and_cer_match_jax(ref, hyp):
    got, want = twer.wer_counts(ref, hyp), jwer.wer_counts(ref, hyp)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.errors, got.wer) == (want.errors, want.wer)
    assert twer.wer(ref, hyp) == jwer.wer(ref, hyp)
    assert twer.cer(ref, hyp) == jwer.cer(ref, hyp)
    assert twer._words(ref) == jwer._words(ref)


def test_aggregate_wer_pools_as_jax():
    pairs = [("w1 w2 w3 w4 w5 w6 w7 w8 w9 w10",
              "w1 w2 w3 w4 w5 w6 w7 w8 w9 bad"), ("a b", "x y z"),
             *WER_CASES]
    got, want = twer.aggregate_wer(pairs), jwer.aggregate_wer(pairs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.wer == want.wer
    first = twer.aggregate_wer(pairs[:2])
    assert (first.n_ref, first.errors) == (12, 4)


# -- retrieval and generation metrics ------------------------------------------------

def _hits(cls, *texts):
    return [cls(t, 1.0 - i * 0.1) for i, t in enumerate(texts)]


RETRIEVAL_CASES = [
    (("gradient descent is", "the learning rate"),
     ["gradient descent", "learning rate"], None),
    (("gradient descent", "cooking pasta"), ["gradient"], None),
    (("cooking pasta", "gradient descent"), ["gradient"], None),
    (("a", "b"), ["nonexistent keyword"], None),
    ((), ["x"], None),
    (("a",), [], None),
    (tuple(["relevant kw"] * 2 + ["junk"] * 18), ["relevant"], 5),
    (("junk", "Relevant KW", "junk", "relevant", "x", "relevant"),
     ["RELEVANT"], 3),
]


@pytest.mark.parametrize("texts,keywords,k", RETRIEVAL_CASES)
def test_retrieval_metrics_match_jax(texts, keywords, k):
    got = tmetrics.RAGEvaluator(k=5).compute_retrieval_metrics(
        _hits(RetrievalResult, *texts), keywords, k=k)
    want = jmetrics.RAGEvaluator(k=5).compute_retrieval_metrics(
        _hits(JaxResult, *texts), keywords, k=k)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


class HalfNLI:
    def entailment(self, premise, hypothesis):
        return 0.5


@pytest.mark.parametrize("answer,reference", [
    ("gradient descent minimizes loss",
     "gradient descent iteratively minimizes the loss"),
    ("cats and dogs", "gradient loss"),
    ("", "gradient"),
    ("the the the loss", "the loss"),
])
def test_generation_metrics_match_jax(answer, reference):
    from audio_rag_tpu.embeddings.fake import FakeEmbedder as JaxFake
    from audio_rag_tpu_torch.embeddings.fake import FakeEmbedder

    got = tmetrics.RAGEvaluator(embedder=FakeEmbedder(), nli=HalfNLI())
    want = jmetrics.RAGEvaluator(embedder=JaxFake(), nli=HalfNLI())
    a = got.compute_generation_metrics(answer, reference)
    b = want.compute_generation_metrics(answer, reference)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.semantic_similarity is not None and a.entailment_score == 0.5


class ScriptedJudge:
    """The JAX ``test_metrics.py`` stand-in for the LLM judge."""

    def __init__(self):
        self.calls = []

    def generate(self, prompt, max_tokens=16, temperature=0.0, **kw):
        self.calls.append((prompt, max_tokens, temperature))
        if "Rate 0-10" in prompt:
            return " 8 "
        if "Write one short question" in prompt:
            return "what is gradient descent?\n(extra line ignored)"
        if "Is the CONTEXT useful" in prompt:
            ctx = prompt.split("CONTEXT:")[1]
            return "Yes." if "signal" in ctx else "No."
        if "Can the STATEMENT" in prompt:
            stmt = prompt.split("STATEMENT:")[1]
            return "yes" if "gradient" in stmt else "no"
        return "no"


class WordEmbedder:
    def __init__(self, cls):
        self.cls = cls

    def embed(self, texts):
        out = []
        for t in texts:
            v = np.zeros(8, np.float32)
            for w in t.lower().split():
                v[sum(map(ord, w)) % 8] += 1.0
            out.append(self.cls(dense=v))
        return out


JUDGE_CALLS = [
    ("judge_faithfulness", ("q", "a", ["ctx"])),
    ("judge_answer_relevancy", ("what is gradient descent?",
                                "gradient descent minimizes loss")),
    ("judge_answer_relevancy", ("how do transformers work?",
                                "gradient descent minimizes loss")),
    ("judge_context_precision", ("q", ["signal one", "noise",
                                       "signal two"])),
    ("judge_context_precision", ("q", ["noise", "signal"])),
    ("judge_context_precision", ("q", ["noise", "junk"], "gt answer.")),
    ("judge_context_recall", (["ctx"], "gradient descent iterates. pasta "
                                       "is tasty.")),
    ("judge_context_recall", (["ctx"], "   ")),
    ("compute_ragas_metrics", ("q", "a", ["signal ctx"],
                               "gradient descent iterates.")),
]


@pytest.mark.parametrize("embed", [False, True])
@pytest.mark.parametrize("name,args", JUDGE_CALLS)
def test_llm_judges_match_jax(name, args, embed):
    tj, jj = ScriptedJudge(), ScriptedJudge()
    got = tmetrics.RAGEvaluator(
        generator=tj, embedder=WordEmbedder(EmbeddingResult) if embed
        else None)
    want = jmetrics.RAGEvaluator(
        generator=jj, embedder=WordEmbedder(JaxEmbeddingResult) if embed
        else None)
    assert getattr(got, name)(*args) == getattr(want, name)(*args)
    assert tj.calls == jj.calls
    assert tmetrics.RAGEvaluator().compute_ragas_metrics(
        "q", "a", ["c"], "g") == {}


def test_summary_and_report_match_jax():
    quartet = {"faithfulness": 0.8, "answer_relevancy": 0.5,
               "context_precision": 0.8333, "context_recall": 0.5}
    rows = []
    for mod in (tmetrics, jmetrics):
        rows.append([
            mod.EvaluationResult(
                "q", stype, mod.RetrievalMetrics(0.4, 1.0, 0.5, 0.6, 1.0, 5,
                                                 2),
                mod.GenerationMetrics(0.9, 0.7, 0.25, 12) if i else None,
                0.01 * (i + 1), answer="a", ragas=quartet if i else None)
            for i, stype in enumerate(["dense", "hybrid", "hybrid",
                                       "dense"])])
    got = tmetrics.RAGEvaluator.summarize_results(rows[0])
    want = jmetrics.RAGEvaluator.summarize_results(rows[1])
    assert got == want
    assert [r.to_dict() for r in rows[0]] == [r.to_dict() for r in rows[1]]
    assert tmetrics.RAGEvaluator.print_summary(got) == \
        jmetrics.RAGEvaluator.print_summary(want)


# -- datasets and the corpus ------------------------------------------------------

def test_datasets_match_jax(tmp_path):
    got, want = tdataset.CS229_EVAL_DATASET, jdataset.CS229_EVAL_DATASET
    assert got.name == want.name and len(got) == len(want) == 8
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    got.save(tmp_path / "port.json")
    want.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    back = tdataset.EvalDataset.load(tmp_path / "jax.json")
    assert [dataclasses.asdict(s) for s in back] == \
        [dataclasses.asdict(s) for s in got]


def test_corpus_and_lexicon_match_jax():
    from audio_rag_tpu.audio import charvoice as jvoice
    from audio_rag_tpu.evaluation import corpus as jcorpus
    from audio_rag_tpu_torch.audio import charvoice as tvoice
    from audio_rag_tpu_torch.evaluation import corpus as tcorpus

    base, jbase = tcorpus.make_corpus(), jcorpus.make_corpus()
    for got, want in ((base, jbase), (tcorpus.extend_corpus(base),
                                      jcorpus.extend_corpus(jbase))):
        for f in ("chunks", "tags", "topic_of", "pair_of", "doc_forms",
                  "query_forms", "doc_groups"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.eval_set.name == want.eval_set.name
        assert [dataclasses.asdict(s) for s in got.eval_set] == \
            [dataclasses.asdict(s) for s in want.eval_set]
    assert len(base.chunks) == 240 and len(got.chunks) == 272
    assert tvoice.corpus_lexicon() == jvoice.corpus_lexicon()
    for kw in ({}, {"max_frames": 330, "max_chars": 55},
               {"double_p": 0.3}):
        assert tvoice.make_utterance_texts(
            np.random.default_rng(777), 24, tvoice.corpus_lexicon(), **kw) \
            == jvoice.make_utterance_texts(
                np.random.default_rng(777), 24, jvoice.corpus_lexicon(),
                **kw)


# -- the NLI scorer -----------------------------------------------------------------

PREMISE = "the gradient descent is very fast model training large"
HYPOTHESES = ["gradient descent is fast", "gradient descent is not fast",
              "kernel variance overfitting regularization",
              "model training is large and very fast " * 6]


@pytest.fixture(scope="module")
def nli_pair():
    from audio_rag_tpu.evaluation.nli import NLIScorer as JaxNLI
    from audio_rag_tpu_torch.evaluation.nli import NLIScorer

    return NLIScorer(device="cpu"), JaxNLI()


def test_nli_matches_jax(nli_pair):
    port, ref = nli_pair
    prem = [PREMISE] * len(HYPOTHESES)
    got, want = port.probs(prem, HYPOTHESES), ref.probs(prem, HYPOTHESES)
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[0, 2] > got[1, 2] and got[0, 2] > got[2, 2]
    assert port.entailment(PREMISE, HYPOTHESES[0]) == pytest.approx(
        ref.entailment(PREMISE, HYPOTHESES[0]), abs=1e-5)
    for scorer in nli_pair:  # the evaluator reads it as in the JAX package
        ev = (tmetrics if scorer is port else jmetrics).RAGEvaluator(
            nli=scorer)
        good = ev.compute_generation_metrics(HYPOTHESES[0], PREMISE)
        bad = ev.compute_generation_metrics(HYPOTHESES[1], PREMISE)
        assert good.entailment_score > bad.entailment_score


def test_nli_random_weights_and_refusals(monkeypatch):
    """``model="random"`` runs the ``test`` preset: with the JAX init
    carried across, the same probabilities; a missing asset raises
    ``FileNotFoundError``, with a checkpoint path that holds no
    ``nli.safetensors`` too, as in the JAX package."""
    import jax

    from audio_rag_tpu.evaluation.nli import NLIScorer as JaxNLI
    from audio_rag_tpu_torch.evaluation import nli as tnli
    from audio_rag_tpu_torch.weights import cross_encoder_params

    port = tnli.NLIScorer(model="random", device="cpu")
    ref = JaxNLI(model="random")
    port._params = cross_encoder_params(
        jax.tree.map(np.asarray, ref._params), port.dims)
    prem = [PREMISE, "a b c"]
    np.testing.assert_allclose(port.probs(prem, HYPOTHESES[:2]),
                               ref.probs(prem, HYPOTHESES[:2]), atol=1e-5,
                               rtol=0)
    monkeypatch.setattr(tnli, "_ASSET", ROOT / "no-such-asset.npz")
    with pytest.raises(FileNotFoundError):
        tnli.NLIScorer(device="cpu")
    with pytest.raises(FileNotFoundError):  # nor a checkpoint, as in JAX
        tnli.NLIScorer(checkpoint_path="/x", device="cpu")
    ev = tmetrics.RAGEvaluator(device="cpu")
    assert ev.nli is None  # the relevance proxy takes over, with a warning


# -- the quality sweep -------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    from audio_rag_tpu.evaluation.quality import run_quality_sweep as jsweep
    from audio_rag_tpu_torch.evaluation.quality import run_quality_sweep

    return run_quality_sweep(device="cpu"), jsweep()


def test_text_sweep_matches_jax(sweeps):
    got, want = sweeps
    assert list(got) == list(want) == [c[0] for c in SWEEP_CONFIGS]
    for cfg in want:
        assert set(got[cfg]["by_type"]) == set(want[cfg]["by_type"])
        for t in [None, *want[cfg]["by_type"]]:
            g = got[cfg] if t is None else got[cfg]["by_type"][t]
            w = want[cfg] if t is None else want[cfg]["by_type"][t]
            for m in ("p_at_5", "mrr", "ndcg", "hit_rate"):
                assert abs(g[m] - w[m]) <= 1e-4, (cfg, t, m, g[m], w[m])


def test_text_sweep_separates_as_jax(sweeps):
    """The orderings ``tests/unit/evaluation/test_quality_separation.py``
    pins, on the port's sweep."""
    s = sweeps[0]
    assert s["hybrid"]["mrr"] > s["dense"]["mrr"] + 0.10
    assert s["hybrid"]["by_type"]["tag"]["mrr"] >= 0.5
    assert s["dense"]["by_type"]["tag"]["mrr"] <= 0.2
    assert s["dense"]["by_type"]["paraphrase"]["mrr"] >= 0.6
    assert s["sparse"]["by_type"]["paraphrase"]["mrr"] <= 0.3
    assert (s["hybrid+rerank"]["by_type"]["pair"]["mrr"]
            > s["hybrid"]["by_type"]["pair"]["mrr"] + 0.05)
    assert (s["hybrid+context"]["by_type"]["context"]["p_at_5"]
            > s["hybrid"]["by_type"]["context"]["p_at_5"] + 0.05)
    assert (s["hybrid+context+prf"]["by_type"]["mismatch"]["p_at_5"]
            > s["hybrid+context"]["by_type"]["mismatch"]["p_at_5"] + 0.10)
    ladder = [s[c]["p_at_5"] for c in ("dense", "hybrid", "hybrid+context",
                                       "hybrid+context+prf")]
    assert all(b >= a for a, b in zip(ladder, ladder[1:])), ladder
    for cfg in ("dense", "sparse", "hybrid"):
        assert s[cfg]["p_at_5"] < 0.95


# -- the dataset sweep through both pipelines ----------------------------------------

FAKE = {
    "asr": {"backend": "fake"},
    "diarization": {"backend": "fake"},
    "embedding": {"backend": "fake"},
    "retrieval": {"backend": "tpu", "capacity_step": 128},
    "reranking": {"backend": "fake"},
    "generation": {"backend": "fake"},
    "chunking": {"min_chunk_tokens": 1, "overlap_tokens": 0},
}


def test_dataset_sweep_matches_jax():
    """The JAX ``test_sweep_with_fake_pipeline``: the reference answers
    ingested as the corpus, then ``evaluate_dataset`` with answers through
    both packages' ``AudioRAG`` (the trained NLI scoring entailment):
    equal per-sample metrics and summaries but for latency."""
    port = AudioRAG(load_config(configs_dir=NOWHERE,
                                overrides={**FAKE, "device": "cpu"}))
    ref = JaxAudioRAG(jloader.load_config(configs_dir=NOWHERE,
                                          overrides=FAKE))
    for rag, seg, ds in ((port, TranscriptSegment, tdataset),
                         (ref, JaxSegment, jdataset)):
        rag.ingestion.ingest_segments([
            seg(text=s.reference_answer, start=float(i * 30),
                end=float(i * 30 + 30), speaker=f"SPEAKER_{i % 2:02d}")
            for i, s in enumerate(ds.CS229_EVAL_DATASET)])
    ev_t = tmetrics.RAGEvaluator(embedder=port.embedder, k=5, device="cpu")
    ev_j = jmetrics.RAGEvaluator(embedder=ref._embedder, k=5)
    got = ev_t.evaluate_dataset(port, tdataset.CS229_EVAL_DATASET,
                                search_types=["dense", "hybrid"],
                                generate_answers=True)
    want = ev_j.evaluate_dataset(ref, jdataset.CS229_EVAL_DATASET,
                                 search_types=["dense", "hybrid"],
                                 generate_answers=True)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        a, b = g.to_dict(), w.to_dict()
        a.pop("latency_s"), b.pop("latency_s")
        ga, gb = a.pop("generation"), b.pop("generation")
        assert a == b
        assert ga["entailment_score"] == pytest.approx(
            gb.pop("entailment_score"), abs=1e-4)
        ga.pop("entailment_score")
        assert ga == gb
        assert g.answer == w.answer
    sg, sw = (ev.summarize_results(r) for ev, r in ((ev_t, got),
                                                     (ev_j, want)))
    for stype in sw:
        for key in ("avg_latency_s", "p95_latency_s"):
            sg[stype].pop(key), sw[stype].pop(key)
    assert sg == sw
    assert sg["hybrid"]["hit_rate"] >= 0.8 and sg["hybrid"]["mrr"] >= 0.5


# -- held-out speech through both tiny ASRs ----------------------------------------

def test_charvoice_hypotheses_match_jax():
    """The first eight utterances of the WER harness's charvoice set
    (``default_rng(777)``), the same samples in both packages, through
    both trained tiny ASRs' ``transcribe`` (f32, VAD filter and ladder
    off): equal hypotheses and WER counts."""
    from audio_rag_tpu.asr.whisper_jax import WhisperJaxASR
    from audio_rag_tpu.config.schema import ASRConfig as JaxASRConfig
    from audio_rag_tpu.audio.charvoice import (
        corpus_lexicon,
        make_utterance_texts,
        synth_text,
    )
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.config import ASRConfig
    from audio_rag_tpu_torch.evaluation import wer_sets

    sets = wer_sets.make_sets(8)
    rng = np.random.default_rng(777)
    texts = make_utterance_texts(rng, 8, corpus_lexicon())
    assert texts == sets.texts
    for text, wav in zip(texts, sets.wavs):
        ref_wav = synth_text(text, rng, noise_level=float(rng.uniform(
            0, 0.02)), gain=float(rng.uniform(0.5, 1.2)))
        assert np.array_equal(ref_wav, wav)
    jasr = WhisperJaxASR(JaxASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False, mel_sharded=False))
    jasr.load()
    asr = WhisperASR(ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False), device="cpu")
    hyps = wer_sets.transcribe_all(asr, sets.wavs)
    want = wer_sets.transcribe_all(jasr, sets.wavs)
    assert hyps == want
    assert sum(h == t for h, t in zip(hyps, texts)) >= 4
    got_c, _ = wer_sets.wer_stats(texts, hyps)
    want_c = jwer.aggregate_wer(list(zip(texts, want)))
    assert dataclasses.asdict(got_c) == dataclasses.asdict(want_c)
    # the record's JSON keys
    record = json.loads((ROOT / "docs" / "bench_runs"
                         / "wer_tiny_synth.json").read_text())
    result = wer_sets.wer_result(sets, hyps, sets.stream_refs, hyps, "cpu")
    assert set(result) == set(record)
    assert set(result["extra"]) == set(record["extra"])
    assert set(result["extra"]["tts_rendered"]) == \
        set(record["extra"]["tts_rendered"])
    assert result["extra"]["multi_window_stream"]["wer"] == 0.0
