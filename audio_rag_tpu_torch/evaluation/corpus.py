"""Synthetic retrieval-eval corpus with exact ground truth (counterpart of
``audio_rag_tpu/evaluation/corpus.py``; with the same seeds it gives the
same 240 base chunks, the same 32 appended ones and the same eval sets).

Its structure makes each retrieval stage matter in its own, mechanically
verifiable way:

* **Concept synonymy**: every concept has a lecture surface form (in
  chunks) and a query surface form (in questions); only a trained dense
  embedder connects them.
* **Rare identifiers**: every chunk carries a unique section tag
  (``s017``-style): exact IDF-weighted sparse matches, so hybrid > dense.
* **Concept-pair chunks**: each chunk covers two of its topic's four
  concepts; pair queries make one-concept chunks hard negatives that only
  the cross-encoder scores jointly, so rerank > no rerank.

Each eval sample's ``relevance_keywords`` are the section tags of the truly
relevant chunks (tags appear verbatim in chunk text, so keyword-substring
relevance is a label lookup).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from audio_rag_tpu_torch.evaluation.dataset import EvalDataset, EvalSample

__all__ = [
    "SynthCorpus", "make_corpus", "extend_corpus",
    "N_TOPICS", "CHUNKS_PER_TOPIC", "CONCEPTS_PER_TOPIC",
    "N_CONTEXT", "N_MISMATCH",
]

N_TOPICS = 30
CONCEPTS_PER_TOPIC = 4
CHUNKS_PER_TOPIC = 8
#: unordered concept pairs covered by a topic's 8 chunks (all 6 pairs, the
#: first two twice) — every pair query has 1-2 relevant chunks and six
#: one-concept-overlap hard negatives inside its own topic
_PAIRS = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2), (1, 3), (0, 1), (2, 3)]

_SYLLABLES = [
    "ba", "ce", "di", "fo", "gu", "ha", "je", "ki", "lo", "mu",
    "na", "pe", "qui", "ro", "su", "ta", "ve", "wi", "xo", "zu",
]

#: chunk-side scaffold words. DISJOINT from every query-template word by
#: construction: shared surface words between a query and random chunks
#: add VARIABLE token-overlap noise that drowns the ±1-twin signal the
#: cross-encoder must learn (measured: with overlapping scaffolds the
#: reranker plateaued at BCE 0.693 on even the tag-matching task, while
#: the same architecture learns the NLI lexical task — whose overlap is
#: all-or-nothing — in 100 steps). Real queries and transcripts also have
#: largely disjoint function-word registers; here we make it exact.
_DOC_SCAFFOLD = ["section", "covers", "alongside"]
#: per-chunk filler drawn from pseudo-words shared by all topics
#: (df = every chunk → IDF 0 → sparse-neutral)
_FILLER_SYLLABLES = 10

_QUERY_TEMPLATES_A = [
    "what does the lecture say about {q0}",
    "explain the idea of {q0} from the lecture",
    "how is {q0} described in the recording",
]
_QUERY_TEMPLATES_C = [
    "how do {q0} and {q1} relate in the lecture",
    "find the part discussing both {q0} and {q1}",
    "what is said about {q0} together with {q1}",
]
_QUERY_TEMPLATES_B = [
    "where is {tag} discussed",
    "what is said at {tag} in the recording",
]


def _pseudo_word(rng: np.random.Generator, n_syl: int = 3) -> str:
    return "".join(rng.choice(_SYLLABLES) for _ in range(n_syl))


def _make_vocab(rng: np.random.Generator, n: int,
                taken: set[int], hasher) -> list[str]:
    """n distinct pseudo-words whose hash-token ids collide with nothing
    previously issued (a lecture-form/query-form hash collision would let
    sparse matching cheat the synonymy design; a tag collision would
    corrupt the ground-truth labels)."""
    out: list[str] = []
    seen: set[str] = set()
    while len(out) < n:
        w = _pseudo_word(rng)
        if w in seen:
            continue
        tid = hasher(w)
        if tid in taken:
            continue
        seen.add(w)
        taken.add(tid)
        out.append(w)
    return out


@dataclass
class SynthCorpus:
    """Corpus + eval set + the generative structure (for training)."""

    #: chunk texts, index-aligned with ``tags``
    chunks: list[str]
    #: unique per-chunk section tag (appears verbatim in the chunk text)
    tags: list[str]
    #: chunk index → topic index
    topic_of: list[int]
    #: chunk index → (concept, concept) covered (topic-local indices)
    pair_of: list[tuple[int, int]]
    #: topic → concept → lecture-side surface form (used in chunks)
    doc_forms: list[list[str]]
    #: topic → concept → query-side surface form (used in questions)
    query_forms: list[list[str]]
    eval_set: EvalDataset = field(default=None)  # type: ignore[assignment]
    #: (start, end) chunk-index ranges forming one "recording" each —
    #: the unit ingestion contextualizes over (``extend_corpus`` sets it;
    #: base corpus: one group per topic)
    doc_groups: list[tuple[int, int]] | None = None

    def relevant_chunks(self, topic: int, concepts: tuple[int, ...]
                        ) -> list[int]:
        """Chunk indices of ``topic`` covering ALL of ``concepts``."""
        return [
            i for i in range(topic * CHUNKS_PER_TOPIC,
                             (topic + 1) * CHUNKS_PER_TOPIC)
            if all(c in self.pair_of[i] for c in concepts)
        ]


def make_corpus(seed: int = 0, vocab_size: int = 4096) -> SynthCorpus:
    """Build the deterministic 240-chunk corpus + 24-question eval set."""
    from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer

    tok = HashWordTokenizer(vocab_size)
    rng = np.random.default_rng(seed)
    taken: set[int] = {tok._word_id(w) for w in _DOC_SCAFFOLD}
    taken |= {
        tok._word_id(w)
        for t in (_QUERY_TEMPLATES_A + _QUERY_TEMPLATES_B
                  + _QUERY_TEMPLATES_C)
        for w in t.replace("{q0}", "").replace("{q1}", "")
                  .replace("{tag}", "").split()
    }

    n_concepts = N_TOPICS * CONCEPTS_PER_TOPIC
    filler = _make_vocab(rng, _FILLER_SYLLABLES, taken, tok._word_id)
    doc_flat = _make_vocab(rng, n_concepts, taken, tok._word_id)
    query_flat = _make_vocab(rng, n_concepts, taken, tok._word_id)
    n_chunks = N_TOPICS * CHUNKS_PER_TOPIC
    # tags: sNNN section numbers — must also be hash-unique
    tags: list[str] = []
    for i in range(n_chunks):
        tag = f"s{i:03d}"
        while tok._word_id(tag) in taken:
            tag += "x"
        taken.add(tok._word_id(tag))
        tags.append(tag)

    doc_forms = [doc_flat[t * CONCEPTS_PER_TOPIC:(t + 1) * CONCEPTS_PER_TOPIC]
                 for t in range(N_TOPICS)]
    query_forms = [
        query_flat[t * CONCEPTS_PER_TOPIC:(t + 1) * CONCEPTS_PER_TOPIC]
        for t in range(N_TOPICS)
    ]

    chunks: list[str] = []
    topic_of: list[int] = []
    pair_of: list[tuple[int, int]] = []
    for t in range(N_TOPICS):
        for j, (a, b) in enumerate(_PAIRS):
            i = t * CHUNKS_PER_TOPIC + j
            fill = rng.choice(filler, size=6).tolist()
            wa, wb = doc_forms[t][a], doc_forms[t][b]
            chunks.append(
                f"section {tags[i]} covers {wa} alongside {wb} "
                + " ".join(fill)
            )
            topic_of.append(t)
            pair_of.append((a, b))

    corpus = SynthCorpus(chunks, tags, topic_of, pair_of,
                         doc_forms, query_forms)
    corpus.eval_set = _make_eval_set(corpus, seed=seed + 1)
    return corpus


def _make_eval_set(c: SynthCorpus, seed: int) -> EvalDataset:
    """24 questions: 8 paraphrase (dense), 8 section-tag (sparse/hybrid),
    8 concept-pair (rerank). Relevance keywords are the ground-truth
    section tags, so keyword-substring relevance == exact labels."""
    rng = np.random.default_rng(seed)
    samples: list[EvalSample] = []
    topics = rng.permutation(N_TOPICS)

    for k in range(8):  # type A: single-concept paraphrase
        t = int(topics[k])
        concept = int(rng.integers(CONCEPTS_PER_TOPIC))
        q = _QUERY_TEMPLATES_A[k % len(_QUERY_TEMPLATES_A)].format(
            q0=c.query_forms[t][concept])
        rel = c.relevant_chunks(t, (concept,))
        samples.append(EvalSample(
            question=q,
            reference_answer=f"the lecture discusses "
                             f"{c.doc_forms[t][concept]}",
            relevance_keywords=[c.tags[i] for i in rel],
            metadata={"type": "paraphrase", "topic": t},
        ))

    for k in range(8):  # type B: rare section tag
        t = int(topics[8 + k])
        i = t * CHUNKS_PER_TOPIC + int(rng.integers(CHUNKS_PER_TOPIC))
        q = _QUERY_TEMPLATES_B[k % len(_QUERY_TEMPLATES_B)].format(
            tag=c.tags[i])
        samples.append(EvalSample(
            question=q,
            reference_answer=c.chunks[i],
            relevance_keywords=[c.tags[i]],
            metadata={"type": "tag", "topic": t},
        ))

    for k in range(8):  # type C: concept pair
        t = int(topics[22 - k])  # overlaps type-B topics; different queries
        a, b = _PAIRS[int(rng.integers(len(_PAIRS)))]
        q = _QUERY_TEMPLATES_C[k % len(_QUERY_TEMPLATES_C)].format(
            q0=c.query_forms[t][a], q1=c.query_forms[t][b])
        rel = c.relevant_chunks(t, (a, b))
        samples.append(EvalSample(
            question=q,
            reference_answer=f"sections covering {c.doc_forms[t][a]} and "
                             f"{c.doc_forms[t][b]}",
            relevance_keywords=[c.tags[i] for i in rel],
            metadata={"type": "pair", "topic": t},
        ))

    return EvalDataset(name="synthetic-discriminating-24", samples=samples)


N_CONTEXT = 8   # context-dependent intro+detail pairs (contextual stage)
N_MISMATCH = 8  # query↔document vocabulary-mismatch setups (PRF stage)


def extend_corpus(c: SynthCorpus, seed: int = 99) -> SynthCorpus:
    """Append structures that make the CONTEXTUAL and EXPANSION stages
    measurable, mirroring the reference's published ladder (dense →
    contextual+hybrid → +expansion, reference ``README.md:30-31``).
    The base corpus (and therefore the committed trained-model assets,
    ``scripts/train_retrieval.py``) is untouched — everything appends
    with a fresh RNG stream, so base generation stays byte-identical.

    * **Context pairs** — an *intro* chunk names a fresh concept (twice,
      for extractive-header salience); its *detail* neighbour discusses
      it only elliptically (a shared pronoun pseudo-word). A ``context``
      query asks about the concept: without contextual headers the detail
      chunk is unfindable; a header carrying the neighbour's concept term
      (``contextual.backend: extractive`` — or an LLM's) makes it rank.
      This is exactly the Anthropic contextual-retrieval failure mode.
    * **Mismatch bridges** — a ``mismatch`` query uses an *alias* term
      that appears only in two bridge chunks, where it co-occurs with the
      canonical concept term the truly-relevant chunks use. First-pass
      retrieval finds the bridges; RM3 feedback
      (``expansion.backend: prf``) mines the canonical term and the
      re-written query reaches the canonical chunks — the same
      vocabulary-mismatch gap HyDE closes with an LLM.
    """
    from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer

    tok = HashWordTokenizer(4096)
    taken = {tok._word_id(w) for ch in c.chunks for w in ch.split()}
    taken |= {
        tok._word_id(w)
        for s in c.eval_set
        for w in s.question.split()
    }
    rng = np.random.default_rng(seed)
    concepts = _make_vocab(rng, N_CONTEXT, taken, tok._word_id)
    aliases = _make_vocab(rng, N_MISMATCH, taken, tok._word_id)
    # one "it"-analog per pair: a SHARED pronoun word would lexically
    # alias every detail chunk to every other pair's queries the moment
    # PRF mines it from feedback (measured: context P@5 0.275 → 0.10)
    prons = _make_vocab(rng, N_CONTEXT, taken, tok._word_id)
    # reuse the base corpus's filler pool (positions 5+ of every chunk) so
    # appended chunks keep the same high-df/IDF-0 noise floor
    filler = sorted({w for ch in c.chunks for w in ch.split()[5:]})

    chunks = list(c.chunks)
    tags = list(c.tags)
    topic_of = list(c.topic_of)
    pair_of = list(c.pair_of)
    groups = [(t * CHUNKS_PER_TOPIC, (t + 1) * CHUNKS_PER_TOPIC)
              for t in range(N_TOPICS)]
    samples = list(c.eval_set.samples)

    def new_tag() -> str:
        tag = f"s{len(tags):03d}"
        while tok._word_id(tag) in taken:
            tag += "x"
        taken.add(tok._word_id(tag))
        tags.append(tag)
        return tag

    def add_chunk(words: list[str], topic: int) -> str:
        tag = tags[len(chunks)]
        fill = rng.choice(filler, size=6).tolist()
        chunks.append(f"section {tag} covers {words[0]} alongside "
                      f"{words[1]} " + " ".join(fill))
        topic_of.append(topic)
        pair_of.append((-1, -1))
        return tag

    for k in range(N_CONTEXT):
        w = concepts[k]
        t_i, t_d = new_tag(), new_tag()
        start = len(chunks)
        add_chunk([w, w], N_TOPICS + k)              # intro: concept 2×
        add_chunk([prons[k], prons[k]], N_TOPICS + k)  # detail: elliptical
        groups.append((start, len(chunks)))
        samples.append(EvalSample(
            question=_QUERY_TEMPLATES_A[k % len(_QUERY_TEMPLATES_A)]
            .format(q0=w),
            reference_answer=f"the recording introduces {w} and then "
                             f"elaborates on it",
            relevance_keywords=[t_i, t_d],
            metadata={"type": "context", "topic": N_TOPICS + k},
        ))

    for k in range(N_MISMATCH):
        x = aliases[k]
        t = k  # deterministic topic choice; disjoint query surface anyway
        cc = k % CONCEPTS_PER_TOPIC
        canon = c.doc_forms[t][cc]
        start = len(chunks)
        tb1, tb2 = new_tag(), new_tag()
        add_chunk([x, canon], t)
        add_chunk([canon, x], t)
        groups.append((start, len(chunks)))
        rel = c.relevant_chunks(t, (cc,))
        samples.append(EvalSample(
            question=_QUERY_TEMPLATES_A[k % len(_QUERY_TEMPLATES_A)]
            .format(q0=x),
            reference_answer=f"{x} is another name for {canon}",
            relevance_keywords=[c.tags[i] for i in rel] + [tb1, tb2],
            metadata={"type": "mismatch", "topic": t},
        ))

    out = SynthCorpus(chunks, tags, topic_of, pair_of,
                      c.doc_forms, c.query_forms,
                      doc_groups=groups)
    out.eval_set = EvalDataset(
        name="synthetic-discriminating-40", samples=samples)
    return out
