"""Shared pieces of the port's tests: torch on one thread for a module
that imports ``one_torch_thread`` (every test file that computes with
torch on the CPU), and the RAG prompts the trained generator answers."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager code issues thousands of small ops; beside the
    suite's other workers torch's thread pool fights them for the cores
    (a generation test took 3× as long with 6 cores busy; on an 8-core
    host the beam, Whisper, speculative and slice files took 561 s of
    wall and 4,282 CPU-seconds on 6 workers with the pool, 121 s and 724
    without), so a module that imports this fixture runs torch on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rag_prompts(n: int, seed: int = 777) -> list[str]:
    """``n`` RAG prompts (system prompt included) over the JAX package's
    evaluation corpus, with 1 to 4 excerpts, the first relevant: the
    prompts the trained generator was trained on."""
    from audio_rag_tpu.core.types import RetrievalResult
    from audio_rag_tpu.evaluation.corpus import make_corpus
    from audio_rag_tpu.generation.prompts import SYSTEM_PROMPT, build_rag_prompt

    corpus = make_corpus()
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        t = int(rng.integers(len(corpus.doc_forms)))
        concept = int(rng.integers(4))
        q = f"what does the lecture say about {corpus.query_forms[t][concept]}"
        idxs = [int(j) for j in rng.integers(0, len(corpus.chunks),
                                             size=1 + k % 4)]
        idxs[0] = int(rng.choice(corpus.relevant_chunks(t, (concept,))))
        res = [RetrievalResult(corpus.chunks[j], 0.8, 30.0 * j,
                               30.0 * j + 30, speaker="SPEAKER_00")
               for j in idxs]
        out.append(f"{SYSTEM_PROMPT}\n\n{build_rag_prompt(q, res)}")
    return out
