#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``audio_rag_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and imports nothing of JAX or of
the JAX package. Phases (any failure exits non-zero; ``--phases`` picks a
subset):

1. build    — nvcc-builds the port's seven kernels (one process per
              source, all started together), prints the seconds it took
              and a census of some SASS instructions in the flash, the
              two cross-attention and the self-attention libraries;
2. kernels  — holds each kernel against its plain PyTorch version on the
              card at small ragged shapes, at llama-3.2-3b's decode
              linears (1 and 16 rows) and at the Whisper large-v3
              shapes (beam search's too: cross-attention with 5 and 8
              queries per row, the weight matmuls at 80 rows, the cache
              reorder bit for bit at (32, 80, 20, 228, 64) and at the
              beam-outermost probe's (1, 40, 1, 72960, 128)), and the
              weight matmuls at edge shapes (1, 8, 80 and 129 rows, ragged
              din and dout), the self-attention kernel at Cp 1 to 2048,
              and the weight matmuls and the attention kernels with a
              second call's bits equal to the first's,
              printing the error, tolerance, kernel / plain / library ms
              and bound;
3. spine    — ingests three spoken turns (tiny-synth ASR + eval-small
              embedder, committed trained weights) through ``AudioRAG`` in
              five decode profiles: int8 (cross_kv_int8 + decoder_int8),
              int8 + int4 weights + int8 self cache, beam 5 with the kernel
              reorder and speculative greedy in verify blocks of 8 (whose
              transcripts must be the int8 profile's), where hybrid queries
              must retrieve the chunk with the spoken words, and the repo's
              benchmark profile (cross_kv_int4 + decoder_int8 +
              lm_head_int4), whose top hits and chunk count must equal the
              port's own CPU run of it (int4 cross K/V garbles tiny-synth's
              words in the JAX package too);
4. full     — the same ingest → query path with Whisper large-v3 shapes
              (seeded weights) in the production decode profile
              (cross_kv_int8 + decoder_int8, window batch 16) on 16 windows
              (8 min) of speech: first-step logits against the plain path on
              the card, a traced window of decode steps (host ms and device
              busy ms per step, the weight matmuls' and the cross and self
              attention's own device ms, top kernels), a traced encode,
              encode ms per window batch,
              decode ms, RTF, peak memory, kernel launches;
5. full_kv4 — the same at large-v3 shapes in the benchmark profile
              (cross_kv_int4 + decoder_int8 + lm_head_int4, window batch
              32) on 32 windows (16 min) of speech;
6. capacity — large-v3 shapes in the capacity profile (cross_kv_int4 +
              decoder_int4 + self_kv_int8, window batch 16): first-step
              logits and 8 decode steps against the plain path on the card,
              and a traced window of decode steps (no ingest);
7. beam     — large-v3 shapes, beam 5 in the benchmark profile at window
              batch 16: from one window primed at the full decode budget
              (C = 228), 8 beam steps in each reorder mode ("kernel" must
              equal "onehot" bit for bit, its logits stay within 5 % of the
              plain path's; lazy's agreement is printed), a traced window
              of beam steps and the peak memory of each mode, then 16
              windows through ``AudioRAG.ingest``/``query`` with
              ``BEAM_REORDER=kernel``;
8. diarize  — the diarized ingest: (a) the JAX package's trained
              end-to-end layout (three turns, 0.5 s gaps) through
              ``AudioRAG.ingest`` with ``diarize=True`` in the int8 profile,
              on the card and on the port's CPU, which must give the same
              chunk texts and speakers and word times within 0.02 s, with
              the spoken words in each query's top hit; (b) the trained
              speaker test's 3-voice 50 s conversation through both
              diarizers (energy VAD, 3 speakers): DER below 0.35 and
              within 0.01 of the port's CPU run; (c) a 10-minute 4-voice
              conversation (more than one 512-window embedding batch and
              one 128-clip VAD batch): VAD, embedding and clustering ms,
              windows, diarization seconds per audio second and peak
              memory;
9. fallback — the rest of greedy transcription: (a) the port's JAX PRNG
              at (16, 51866) on the card against the CPU (bits equal,
              Gumbel noise within 2 ulp of max(|g|, 1), the same
              ``categorical`` draws); (b) the ``test`` preset (seeded
              weights that fail the log-probability gate) through
              ``transcribe`` with the temperature-fallback ladder on, on
              the card and the CPU: the same final temperature per window
              and the same tokens; (c) large-v3 in the production profile
              with the port's defaults (ladder on, no language) on 4
              windows: the detected language against the plain path,
              each rung's ms, loop iterations and kernel launches;
              (d) ``condition_on_previous_text`` on 3 large-v3 windows,
              which must prime a prompt longer than 16 tokens: ms per
              window;
10. query   — the query half (no kernel runs on it): (a) the trained
              eval-small embedder and reranker on the spine's three turns
              and 21 distractors through ``AudioRAG.query``, every search
              type with rerank on and off and a filtered query, on the
              card and on the port's CPU: the same top 5 but for
              near-ties, scores within 8e-3 or two bf16 ulps; (b) BGE-M3
              (XLM-R large) and bge-reranker-base (XLM-R base), seeded,
              on ``bench.py``'s 10,000-chunk corpus: hybrid, rerank 20 →
              5 at query batch 128 (ms, QPS, the same batches without the
              reranker, a traced batch's host and device ms) and single
              stream (median of 10), peak memory, then an int8 corpus and
              a filtered query; the fused path's reranker scores of the
              first 8 queries against ``score_pairs_multi`` in f32
              (within 1e-4 relative) and in bf16 (within 8 ulps); (c) it
              fails if any kernel launched.
11. answer  — LLM generation: (a) the trained eval-small generator
              (``llm_small.npz``) on four RAG prompts over the query spine,
              greedy, in the int8 and the int8 + int4-head profiles: the
              kernels' tokens must equal the plain path's
              (``plain_kernels``) and every answer must end in EOS within
              64 tokens; (b) llama-3.2-3b (seeded) in the shipped profile
              (decoder_int8, temperature 0.7): ``AudioRAG.query(
              generate_answer=True)`` on the query spine, a scheduler wave
              of 16 concurrent prompts and a single stream (tokens/s, ms a
              decode step, prefill ms), the first decode step's logits
              within 5 % of the plain path's, a traced window of decode
              steps at 16 rows, and the wave again with the int4 head;
              each run must launch ``matmul_q8w`` 113 times a decode step
              (112 and one ``matmul_q4w`` with the int4 head) and nothing
              else. The serving engine: (a) on the trained generator, a
              greedy single stream with ``speculative_k`` 8 (the wave's
              and the plain path's tokens; verifies, tokens per verify,
              17 ``matmul_q8w`` a verify), the continuous batcher (4
              slots, segments of 8; a fifth request joins after the first
              segment; each request's greedy tokens equal to its wave's,
              the streamed text equal to the answer), and
              ``AudioRAG.ingest`` with contextual headers (llm, then
              extractive) on the card and the CPU (the same chunks, or a
              printed near-tie); (b) at 3b, a greedy single stream with
              ``speculative_k`` 8 and 0 in turns (decode tokens/s, tokens
              per verify, the tokens equal up to a near-tie), the first
              verify block's logits within 5 % of the step's, 16 requests
              of 64 tokens and a late one of 8 as waves and through the
              batcher at the shipped settings (8 slots, segments of 16,
              idle segments of 48, 2,048 frames: tokens/s and the late
              request's latency), then ``AudioRAG.unload_all`` stopping the
              batcher.
12. stream  — live transcription: (a) tiny-synth (trained, f32) in the
              JAX end-to-end streaming test's session (4 s chunks, 0.5 s
              overlap, 112 tokens): its utterance and four sessions'
              speech replayed through ``StreamingASR`` on the card and the
              CPU (the same chunks, texts and words, word times within
              0.02 s; 3 of the 4 spoken words heard), then the four
              sessions at once through one ``StreamingMux`` of 4, each
              equal to its replay alone, in f32 and the int8 profile, the
              mux run's launches checked; (b) large-v3 (seeded) in the
              shipped streaming profile (``configs/low_latency.yaml``:
              bf16, int8 cross K/V and decode weights, 3 s chunks, 0.6 s
              overlap, 40 tokens, learned VAD, languages detected per
              session, word times, the ladder on): one row's first-step
              logits at B = 8 within 5 % of the row alone, a lone chunk's
              dispatch ms, 8 sessions of 6 s fed unpaced from 8 threads
              through one mux of 8 with the ladder and without (dispatch
              ms at B = 8 and 1, chunks served and batches run,
              submit-to-result p50/p95, the detect dispatches, launches a
              dispatch with every flash call on wgmma and no plain version
              called, peak memory), and the pad rows' price (2 chunks at
              B = 8 against B = 2, in turns); (c) 32 single queries from
              their own threads through a ``QueryCoalescer`` on the query
              spine: the rankings of one direct ``query_batch``, in fewer
              batches, no kernel launched.
13. profiles — configs/production.yaml as a deployment loads it:
              ``AudioRAG.from_config(env="production")`` with the run's own
              settings as ``AUDIO_RAG__`` variables (the store in the
              phase's directory, 32 decode tokens, 64 answer tokens,
              contextual headers on), its values checked (large-v3, bf16,
              window batch 16, int8 cross K/V and decode weights, the
              ladder on, the language detected, an int8 corpus,
              llama-3.2-3b with decoder_int8 and speculative_k 8; seeded
              weights); three 30 s files through ``ingest_batch`` (diarized,
              3b headers, stage-grouped) and through the per-file ``ingest``
              loop: the same chunks and the same top 5 for three queries;
              the loop's first file checkpointed and resumed from
              "aligned" with an ASR that raises; ``status()`` (collections,
              the ``@timed`` counts, every ``ingest.*`` span) and
              ``clear_collection``. Rows 1-3 must launch (every flash call
              on wgmma, ``matmul_q8w`` at Whisper's and 3b's widths), rows
              4-7 and every plain version not at all. Prints each file's
              stage seconds, the batch's wall time against the loop's and
              the peak memory beside the card's name and power limit.
              Runs under the profile's device-memory ledger
              (``resources.max_hbm_gb`` 14 GB: large-v3 and llama-3.2-3b
              cannot both be booked), and prints each run's evictions,
              each unload's and load's seconds, each load's estimate
              beside the allocation it measured, and peak allocated and
              reserved memory; every eviction must free at least 90 % of
              the bytes the engine recorded for the model;
14. queue   — the job queue on profiles' pipeline and files:
              configs/queue.yaml through the port's YAML reader (the
              database in the phase's directory), the three files enqueued
              with validation at priorities low, normal and high, one job
              sent twice under one idempotency key (``DuplicateJobError``),
              one extra job cancelled, then ``GPUWorker.start(max_jobs=3)``
              with heartbeats: the three jobs complete, claimed high
              first, as one stage-grouped batch (``batch_claim`` 4), the
              cancelled one never runs, the stored chunks are profiles'
              batch's, the heartbeat row carries platform "cuda" and the
              card's bytes in use, each eviction frees at least 90 % of
              the model's recorded bytes, rows 1-3 launch and no plain
              version runs; ``requeue_stale`` requeues a job claimed by a
              worker without heartbeats. Prints the drain's wall beside
              profiles' batch, evictions and swap seconds, peak memory,
              ``status()["resources"]`` and the launches;
15. api     — the HTTP/WebSocket API on profiles' pipeline:
              ``create_app`` with the inline worker on 127.0.0.1 at a port
              the OS picks, driven by the tests' standard-library clients
              (``tests/torch_api_client.py``): (a) ``/health/ready`` 200, a
              query without a key 401, an empty one 422; (b) profiles'
              first file uploaded by multipart (priority high), drained by
              the inline worker to "completed" within 180 s, its chunks
              profiles' batch's for that file; (c) eight concurrent
              search-only queries: the rankings of the in-process
              ``query_batch`` (but for near-ties), coalesced into fewer
              batches, HTTP p50 ms beside a single query's in process;
              (d) an answer over HTTP equal to ``rag.query(...,
              generate_answer=True)``'s; (e) a WebSocket session of 12 s of
              that file's PCM in 1 s frames: its transcripts (text, start,
              end) equal to an in-process ``StreamingASR`` over a
              ``StreamingMux`` on a Whisper backend built from the same
              config, dispatch and submit-to-transcript ms; (f)
              ``/metrics`` parses, counts every route used, shows the
              14 GB budget and the engine gauge, and ``/api/v1/status``
              names the card; (g) rows 1-3 launch (flash on wgmma), no
              other kernel and no plain version; peak memory. The server,
              its executor, the mux, the inline worker and the coalescer
              stop before the references run;
16. eval    — evaluation and speech output, on the card against the
              port's CPU path in three worker processes of the script's
              own: (a) the WER harness's held-out sets on the trained tiny
              ASR (64 charvoice utterances from ``default_rng(777)`` in
              the f32 and int8 profiles, 16 multi-window files in f32):
              WER, CER, S/D/I beside the JAX package's record, the card's
              hypotheses equal to the CPU's; (b) the trained neural TTS on
              the TTS set (16 texts): durations equal to the CPU's (or a
              printed half-integer tie), mel within 0.0625, the vocoder on
              one mel within 1e-3, two card runs of one text the same bits,
              ms a segment batch and the TTS-rendered WER; (c) the text
              quality sweep (card = CPU within 1e-4) and the audio-in
              ladder (272 chunks spoken and transcribed on the card) beside
              the record, its separation orderings asserted; (d)
              ``RAGEvaluator.evaluate_dataset`` with answers and the judged
              quartet on 12 corpus questions through ``AudioRAG`` (eval-small
              embedder, reranker and greedy generator under decoder_int8):
              the quartet beside the record, every judge call's tokens equal
              to the CPU's on the same prompt or parted at a near-tie;
              (e) ``query(generate_answer=True, speak_answer=True)`` with
              the neural and the null TTS: a 22,050 Hz WAV and its ms. Rows
              1-3 must launch (f32 encoder flash, int8 profile's
              ``matmul_q8w`` and cross-attention, the generator's
              ``matmul_q8w``), no kernel in TTS or the text sweep, no plain
              version on the card.
17. train   — Whisper training through ``training/train.py``: (a) the
              flash kernel with a gradient (``FlashAttentionFn``) at
              tiny-synth's (64, 4, 300, 32) f32 and large-v3's
              (4, 20, 1500, 64) f32 and bf16, head-strided: dq, dk, dv
              against autograd of the plain version in full f32, the same
              bits twice, the backward's ms beside its bound, forward +
              backward against the plain version's and SDPA's; (b)
              tiny-synth from ``init_whisper`` on 512 utterances of
              ``scripts/train_asr_torch.py``'s dataset (TTS rows
              included): every encoder leaf's gradient on the card
              against the CPU's (the attention's q, k, v through the
              flash kernel), the first three steps' losses and every
              parameter after step 3 against the port's CPU run, then 300
              steps whose last 10 losses must average below 0.75x the
              first (step ms, steps/s, flash launches a step, peak
              memory); (c) large-v3 at full width, seeded f32 weights,
              B = 4, 3000 mel frames, 128 tokens, ``TrainConfig(
              warmup_steps=2)``, four steps on one batch: losses and
              gradients finite, every leaf's gradient norm nonzero, the
              fourth loss below the first (step seconds, peak memory).
              Only ``flash_attention`` may launch, 3 a tiny-synth step and
              32 a large-v3 step.
18. convert — converted checkpoints, the directories written by the
              tests' HF-layout writers (``tests/torch_hf_layout.py``;
              ``transformers`` is not needed): (a) the ``full`` phase's
              seeded large-v3 as one F16 ``model.safetensors`` in HF layout
              (3.1 GB), classified and converted by the port
              (``audio_rag_tpu_torch.convert``), every converted leaf the
              F16-rounded source bit for bit, then ``WhisperASR`` through
              ``checkpoint_path`` in the production decode profile on 16
              windows of the ``full`` phase's speech: the tokens of
              ``WhisperASR(weights=<the F16 tree>)``, flash (all wgmma),
              ``matmul_q8w`` and cross q8 launched, no plain version;
              write, convert, save and load seconds and GB/s, peak device
              and host memory; (b) an ECAPA-TDNN at the voxceleb release's
              widths as a speechbrain ``embedding_model.ckpt`` (BatchNorm
              statistics), converted, and the ``diarize`` phase's 3-voice
              conversation through ``ClusteringDiarizer(checkpoint_path=
              ...)`` on the card and the CPU: embeddings within 1e-4, the
              same segments, ms per window batch; (c)
              ``scripts/load_real_torch.py`` on the card over
              ``test_load_real.py``'s tiny directories (every kind
              converted, chunks, query results, the evaluation sweep), and
              the converted tied and untied Llama's decode step through
              ``matmul_q8w`` (decoder_int8) against the CPU within 5 % of
              the logits' range.

The native audio runtime (``audio_rag_tpu_torch/csrc/audio_native.cpp``,
g++ into ``build/native/``) is built or loaded right after the kernels;
the script fails without it, so the word-time DTW of every ingest runs in
C. ``diarize`` runs right after ``spine``, ``fallback`` after ``diarize``,
``query`` after ``fallback``, ``answer`` after ``query``, ``stream``
after ``answer``, ``profiles`` after ``stream``, ``queue`` after
``profiles`` (it needs profiles' pipeline), ``api`` after ``queue`` (on
profiles' pipeline too), ``eval`` after ``api``, ``train`` after
``eval``, ``convert`` after ``train``.
At each phase's end the device-memory manager unloads what it booked and
a fresh manager and engine replace it (:func:`free_card`). The
``answer`` phase's
generator settings and the ``stream`` phase's buffering are read from
configs/production.yaml and configs/low_latency.yaml through the port's
loader.
The spine, the diarized ingest and the large-v3 paths other than
``fallback`` run with the fallback ladder off and, at large-v3, in
English, as ``bench.py`` measures. The spine ingests with
diarization and the VAD filter off (one chunk per 6 s window). The
large-v3 ingests of ``full``, ``full_kv4`` and ``beam`` run as ``ingest``
does by default: DTW word times from the teacher-forced alignment pass and
diarization (learned VAD, speaker embeddings, spectral clustering) with
word → speaker alignment, but with the VAD filter off so that the window
count is fixed; each prints the alignment pass's seconds, the ``diarize``
and ``align`` stage seconds, the diarizer's own timings and RTF.

Each path resets the launch counters before it runs, reads them after, and
fails unless every kernel it runs was launched; on the large-v3 paths every
encoder self-attention call (32 a window batch) must have taken
``flash_attention``'s wgmma kernel. Every path runs with PyTorch's default
TF32 switches, as a user's process has them (the port scopes f32 precision
to its own calls); the script prints them. The second-to-last line is the
kernels JSON (launches summed over the paths, and by path); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense, tensor core / CUDA core

SPINE_TURNS = [
    "gradient descent minimizes the loss function",
    "the spectrogram shows harmonic structure",
    "attention layers mix token information",
]
SPINE_QUERIES = [("gradient descent loss", ("gradient", "descent")),
                 ("spectrogram harmonic", ("spectrogram", "harmonic"))]

FLASH, Q8W, Q4W = "flash_attention", "matmul_q8w", "matmul_q4w"
CROSS8, CROSS4 = "decode_cross_attention_q8", "decode_cross_attention_q4"
SELF8, REORDER = "decode_self_attention_q8", "beam_reorder_kv"

#: decode profile → (ASRConfig switches, the kernels its decode path runs)
PROFILES = {
    "int8": ({"cross_kv_int8": True, "decoder_int8": True},
             {FLASH, Q8W, CROSS8}),
    "int8+dec4+skv8": ({"cross_kv_int8": True, "decoder_int4": True,
                        "self_kv_int8": True}, {FLASH, Q4W, SELF8, CROSS8}),
    "kv4+int8+lm4": ({"cross_kv_int4": True, "decoder_int8": True,
                      "lm_head_int4": True}, {FLASH, Q8W, Q4W, CROSS4}),
    "kv4+dec4+skv8": ({"cross_kv_int4": True, "decoder_int4": True,
                       "self_kv_int8": True}, {FLASH, Q4W, SELF8, CROSS4}),
    # beam search runs with BEAM_REORDER=kernel here (see run_with_reorder)
    "beam5+int8": ({"cross_kv_int8": True, "decoder_int8": True,
                    "decode": "beam", "beam_size": 5},
                   {FLASH, Q8W, CROSS8, REORDER}),
    "spec8+int8": ({"cross_kv_int8": True, "decoder_int8": True,
                    "speculative_k": 8}, {FLASH, Q8W, CROSS8}),
    "beam5+kv4+int8+lm4": ({"cross_kv_int4": True, "decoder_int8": True,
                            "lm_head_int4": True, "decode": "beam",
                            "beam_size": 5},
                           {FLASH, Q8W, Q4W, CROSS4, REORDER}),
}
BEAM, BEAM_WB = 5, 16  # the beam phase: beam size, window batch

# the logits head pads the vocab to a multiple of 128 (51866 → 51968)
LARGE_V3_Q8W = [  # (din, dout, calls per decode step)
    (1280, 1280, 6 * 32),  # attention q/k/v/o + cross q/o, 32 layers
    (1280, 5120, 32),      # MLP up
    (5120, 1280, 32),      # MLP down
    (1280, 51968, 1),      # logits head
]
# the same matrices at int4, with the q4_group of their din
LARGE_V3_Q4W = [(din, dout, calls, 128 if din == 5120 else 80)
                for din, dout, calls in LARGE_V3_Q8W]

LLM = "llama-3.2-3b"
LLAMA_3B_Q8W = [  # (din, dout, calls per decode step) under decoder_int8
    (3072, 5120, 28),    # fused q/k/v (24 + 2·8 heads of 128)
    (3072, 3072, 28),    # attention output
    (3072, 16384, 28),   # fused gate/up
    (8192, 3072, 28),    # down
    (3072, 128256, 1),   # logits head (int4 under lm_head_int4, group 128)
]
#: a single stream, a verify block of 8 (or 8 slots), the full wave
LLM_ROWS = (1, 8, 16)
#: the stream path's dispatches: a lone chunk, a full mux of 8
STREAM_ROWS = (1, 8)


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS", "SETMAXREG", "MUFU.EX2",
            "HMMA", "IMMA", "I2F")


def sass_census(K, name: str) -> dict:
    """Counts of some SASS instructions in a built kernel library
    (``cuobjdump -sass``) and the first line of each, as evidence of what
    the compiler emitted: HGMMA (wgmma), UTMALDG (TMA tensor loads), UBLKCP
    (1-D bulk copies, cp.async.bulk), SYNCS (mbarrier), SETMAXREG
    (setmaxnreg), HMMA (mma.sync on floats), IMMA (mma.sync on integers),
    I2F (int-to-float conversions)."""
    tool = Path(K._nvcc()).with_name("cuobjdump")
    try:
        out = subprocess.run([str(tool), "-sass", str(K._lib_path(name))],
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    lines = [ln.split("/*")[1].split("*/", 1)[1].strip()
             for ln in out.splitlines() if ln.strip().startswith("/*")
             and "*/" in ln]
    return {op: {"count": sum(op in ln for ln in lines),
                 "first": next((ln.rstrip(" ;") for ln in lines if op in ln),
                               None)}
            for op in SASS_OPS}


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller that keeps only the
    tail of one still sees it) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


# -- timing --------------------------------------------------------------------

SPIN_CYCLES = 2_000_000  # ~1 ms of GPU spin at H100 clocks


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, each timed with CUDA
    events; ``flush`` (a large buffer) is rewritten before each call so the
    L2 cache is cold, as it is for decode-time weight reads. The GPU spins
    between the flush and the first event while the host enqueues the
    call, so the host's launch overhead stays outside the timed span."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels against their plain versions --------------------------------

def sm_clock_hz() -> float | None:
    """The card's highest SM clock (``nvidia-smi`` ``clocks.max.sm``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


MUFU_PER_CLOCK = 16  # exponentials a clock per SM (H100: 4 SFUs per SMSP)


def mufu_bound(torch, B: int, H: int, Tq: int, Tk: int) -> dict:
    """A second lower bound of an attention call beside ``bound_ms``,
    computed, not measured: its B·H·Tq·Tk exponentials at an assumed
    ``MUFU_PER_CLOCK`` a clock on every SM, at the card's highest SM clock
    (``nvidia-smi`` ``clocks.max.sm``)."""
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = B * H * Tq * Tk
    return {"b_h_tq_tk": [B, H, Tq, Tk], "exponentials": n,
            "mufu_bound_ms": n / (MUFU_PER_CLOCK * sms * clock) * 1e3
            if clock else None,
            "assumes": {"exponentials_per_clock_per_sm": MUFU_PER_CLOCK,
                        "sms": sms,
                        "sm_clock_mhz": clock / 1e6 if clock else None}}


def _flash_case(torch, K, shape, dtype, flush, timed, kv_len=None,
                layout="bhtd", expect=None):
    """``layout`` "bhtd": contiguous (B, H, T, D) q/k/v; "bthd": the
    encoder's head-strided view of (B, T, H, D) projections; "zero": a
    view with a zero batch stride, which no TMA map describes. ``expect``:
    the kernel the entry must run (``FLASH_VARIANTS`` key)."""
    B, H, T, D = shape
    g = torch.Generator(device="cuda").manual_seed(1)

    def make():
        if layout == "bthd":
            return torch.randn((B, T, H, D), generator=g, device="cuda") \
                .to(dtype).transpose(1, 2)
        if layout == "zero":
            return torch.randn((1, H, T, D), generator=g, device="cuda") \
                .to(dtype).expand(B, H, T, D)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = make(), make(), make()
    before = dict(K.FLASH_VARIANTS)
    got = K.flash_attention(q, k, v, kv_len)
    ran = [n for n, c in K.FLASH_VARIANTS.items() if c != before[n]]
    ref = K.flash_attention_plain(q, k, v, kv_len)
    err = (got.float() - ref.float()).abs().max().item()
    same = _same_bits(torch, got, K.flash_attention(q, k, v, kv_len))
    if dtype == torch.float32:
        # f32 sums over up to Tk keys in another order, expf vs torch.exp
        tol = 1e-4
    else:
        # bf16 output (ulp 2^-8 relative); the tensor-core path also rounds
        # the probabilities to bf16 before P·V, as a default-precision dot
        # on the TPU does: allow two output ulps at the largest value
        tol = 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
    row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "layout": layout, "kv_len": kv_len, "kernel": ran,
           "same_bits_twice": same, "max_abs_err": err, "tol": tol}
    ok = err <= tol and same and (expect is None or ran == [expect])
    if timed:
        esize = q.element_size()
        row["ms"] = time_ms(torch, lambda: K.flash_attention(q, k, v),
                            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.flash_attention_plain(q, k, v), flush=flush)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(torch, lambda: sdpa(q, k, v), flush=flush)
        row["bound_ms"], row["bound_by"] = bound_ms(
            4 * B * H * T * D * esize, 4 * B * H * T * T * D,
            "bf16" if dtype == torch.bfloat16 else "f32")
    return row, ok


def _q8w_case(torch, K, B, din, dout, xdtype, flush, timed):
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((B, din), generator=g, device="cuda").to(xdtype)
    w8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda",
                       dtype=torch.int8)
    s = torch.rand((dout,), generator=g, device="cuda") * 0.015 + 0.005
    got = K.matmul_q8w(x, w8, s)
    ref = K.matmul_q8w_plain(x, w8, s)
    err_el = (got - ref).abs()
    # exact products (bf16 × int8 fits f32); two f32 summation orders over
    # din terms differ by at most 2·din·u·Σ|x·w| per output (u = 2^-24)
    mag = torch.matmul(x.bfloat16().float().abs(), w8.float().abs()) * s
    tol_el = 2 * din * 2.0 ** -24 * mag
    # split-K adds its din slices in a fixed order: a second call, same bits
    same = _same_bits(torch, got, K.matmul_q8w(x, w8, s))
    ok = bool((err_el <= tol_el).all()) and same
    row = {"shape": [B, din, dout], "dtype": str(xdtype).split(".")[-1],
           "plan": list(K.wq_plan(B, din, dout)[:5]),
           "same_bits_twice": same, "max_abs_err": err_el.max().item(),
           "tol": "2*din*2^-24*sum|x*w|*s per element",
           "max_tol": tol_el.max().item()}
    if timed:
        w_lib = (w8.float() * s).bfloat16()
        xb = x.bfloat16()
        row["ms"] = time_ms(torch, lambda: K.matmul_q8w(x, w8, s),
                            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.matmul_q8w_plain(x, w8, s), flush=flush)
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(xb, w_lib),
                                    flush=flush)
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * din * x.element_size() + din * dout + 4 * dout
            + 4 * B * dout, 2 * B * din * dout, "bf16")
    return row, ok


def _cross_case(torch, K, B, H, M, hd, Ta, qdtype, flush, timed):
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, H, M, hd), generator=g, device="cuda").to(qdtype)
    k8 = torch.randint(-127, 128, (B, H, hd, Ta), generator=g,
                       device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (B, H, hd, Ta), generator=g,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((B, H, 1, 1), generator=g, device="cuda") * 0.015 + 0.005
    vs = torch.rand((B, H, 1, 1), generator=g, device="cuda") * 0.015 + 0.005
    got = K.decode_cross_attention_q8(q, k8, v8, ks, vs)
    ref = K.decode_cross_attention_q8_plain(q, k8, v8, ks, vs)
    err = (got - ref).abs().max().item()
    # f32 throughout; sums over Ta keys in another order (the JAX kernel
    # test's tolerance)
    tol = 1e-4 + 1e-4 * ref.abs().max().item()
    same = _same_bits(torch, got, K.decode_cross_attention_q8(q, k8, v8, ks,
                                                              vs))
    row = {"shape": [B, H, M, hd, Ta], "dtype": str(qdtype).split(".")[-1],
           "max_abs_err": err, "tol": tol, "same_bits_twice": same}
    if timed:
        row["ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q8(q, k8, v8, ks, vs),
            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q8_plain(q, k8, v8, ks, vs),
            flush=flush)
        # the library yardstick: SDPA on dequantized bf16 K/V
        kd = (k8.float() * ks).transpose(-1, -2).bfloat16()
        vd = (v8.float() * vs).transpose(-1, -2).bfloat16()
        row["library_ms"] = _sdpa_ms(torch, q, kd, vd, flush)
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * H * M * hd * q.element_size() + 2 * B * H * hd * Ta
            + 8 * B * H + 4 * B * H * M * hd, 4 * B * H * M * hd * Ta,
            "bf16")
    return row, err <= tol and same


def _q4w_case(torch, K, B, din, dout, group, xdtype, flush, timed):
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((B, din), generator=g, device="cuda").to(xdtype)
    w4 = torch.randint(-128, 128, (din // 2, dout), generator=g,
                       device="cuda", dtype=torch.int8)
    s = torch.rand((din // group, dout), generator=g, device="cuda") \
        * 0.015 + 0.005
    got = K.matmul_q4w(x, w4, s)
    ref = K.matmul_q4w_plain(x, w4, s)
    err_el = (got - ref).abs()
    # exact products (bf16 × int4·bf16 scale fits f32); two f32 summation
    # orders over din terms differ by at most 2·din·u·Σ|x·w| (u = 2^-24)
    w = K.dequant_q4w(w4, s)
    mag = torch.matmul(x.bfloat16().float().abs(), w.abs())
    tol_el = 2 * din * 2.0 ** -24 * mag
    same = _same_bits(torch, got, K.matmul_q4w(x, w4, s))
    ok = bool((err_el <= tol_el).all()) and same
    plan = K.wq_plan(B, din, dout, bits=4, group=group)
    row = {"shape": [B, din, dout], "group": group,
           "dtype": str(xdtype).split(".")[-1],
           "plan": list(plan[:5]), "group_mode": plan.group_mode,
           "same_bits_twice": same, "max_abs_err": err_el.max().item(),
           "tol": "2*din*2^-24*sum|x*w| per element",
           "max_tol": tol_el.max().item()}
    if timed:
        w_lib = w.bfloat16()
        xb = x.bfloat16()
        del w
        row["ms"] = time_ms(torch, lambda: K.matmul_q4w(x, w4, s),
                            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.matmul_q4w_plain(x, w4, s), flush=flush)
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(xb, w_lib),
                                    flush=flush)
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * din * x.element_size() + din // 2 * dout
            + 4 * (din // group) * dout + 4 * B * dout,
            2 * B * din * dout, "bf16")
    return row, ok


def _cross4_case(torch, K, B, H, M, hd, Ta, qdtype, flush, timed):
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, H, M, hd), generator=g, device="cuda").to(qdtype)
    k4, v4 = (torch.randint(-128, 128, (B, H, hd // 2, Ta), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((B, H, 1, hd), generator=g, device="cuda") * 0.09
              + 0.01 for _ in range(2))
    got = K.decode_cross_attention_q4(q, k4, v4, ks, vs)
    ref = K.decode_cross_attention_q4_plain(q, k4, v4, ks, vs)
    err = (got - ref).abs().max().item()
    # f32 throughout; sums over Ta keys in another order
    tol = 1e-4 + 1e-4 * ref.abs().max().item()
    same = _same_bits(torch, got, K.decode_cross_attention_q4(q, k4, v4, ks,
                                                              vs))
    row = {"shape": [B, H, M, hd, Ta], "dtype": str(qdtype).split(".")[-1],
           "max_abs_err": err, "tol": tol, "same_bits_twice": same}
    if timed:
        row["ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q4(q, k4, v4, ks, vs),
            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q4_plain(q, k4, v4, ks,
                                                             vs),
            flush=flush)
        # the library yardstick: SDPA on dequantized bf16 K/V
        kd, vd = ((torch.cat(K.int4_nibbles(x), dim=-2).float()
                   .transpose(-1, -2) * sc).bfloat16()
                  for x, sc in ((k4, ks), (v4, vs)))
        row["library_ms"] = _sdpa_ms(torch, q, kd, vd, flush)
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * H * M * hd * q.element_size() + B * H * hd * Ta
            + 8 * B * H * hd + 4 * B * H * M * hd, 4 * B * H * M * hd * Ta,
            "bf16")
    return row, err <= tol and same


def _self8_case(torch, K, B, H, M, hd, Cp, n_valid, qdtype, flush, timed):
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((B, H, M, hd), generator=g, device="cuda").to(qdtype)
    k8, v8 = (torch.randint(-127, 128, (B, H, hd, Cp), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    sc = torch.zeros((B, Cp, 128), device="cuda")
    sc[:, :, :2 * H] = torch.rand((B, Cp, 2 * H), generator=g,
                                  device="cuda") * 0.02 + 0.001
    valid = torch.arange(Cp, device="cuda") < n_valid
    sc[:, :, 2 * H] = torch.where(valid, 0.0, -1e30)
    got = K.decode_self_attention_q8(q, k8, v8, sc)
    ref = K.decode_self_attention_q8_plain(q, k8, v8, sc)
    err = (got - ref).abs().max().item()
    # f32 throughout; sums over Cp positions in another order
    tol = 1e-4 + 1e-4 * ref.abs().max().item()
    same = _same_bits(torch, got, K.decode_self_attention_q8(q, k8, v8, sc))
    ok = err <= tol and bool(torch.isfinite(got).all()) and same
    plan = K.self_plan(hd, Cp, M, aligned=(k8.data_ptr() % 16 == 0
                                           and v8.data_ptr() % 16 == 0))
    row = {"shape": [B, H, M, hd, Cp], "n_valid": n_valid,
           "dtype": str(qdtype).split(".")[-1], "plan": list(plan),
           "max_abs_err": err, "tol": tol, "same_bits_twice": same}
    if timed:
        # the library yardstick: SDPA on dequantized bf16 K/V, same mask
        kd = (k8.float() * sc[:, None, :, :H].permute(0, 3, 1, 2)) \
            .transpose(-1, -2).bfloat16()
        vd = (v8.float() * sc[:, None, :, H:2 * H].permute(0, 3, 1, 2)) \
            .transpose(-1, -2).bfloat16()
        qb = q.bfloat16()
        mask = valid[None, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["ms"] = time_ms(
            torch, lambda: K.decode_self_attention_q8(q, k8, v8, sc),
            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.decode_self_attention_q8_plain(q, k8, v8, sc),
            flush=flush)
        row["library_ms"] = time_ms(
            torch, lambda: sdpa(qb, kd, vd, attn_mask=mask), flush=flush)
        # the packed operand's lanes the function reads: [0, 2H]
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * H * M * hd * q.element_size() + 2 * B * H * hd * Cp
            + 4 * B * Cp * (2 * H + 1) + 4 * B * H * M * hd,
            4 * B * H * M * hd * Cp, "bf16")
    return row, ok


def _sdpa_ms(torch, q, kd, vd, flush) -> float:
    """ms of one ``scaled_dot_product_attention`` call with bf16 q over
    dequantized bf16 K/V (B, H, T, hd): the library call of the cross
    kernels' function."""
    qb = q.bfloat16()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(torch, lambda: sdpa(qb, kd, vd), flush=flush)


def _same_bits(torch, a, b) -> bool:
    ints = {2: torch.int16, 4: torch.int32}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]),
                            b.view(ints[b.element_size()])))


def _reorder_case(torch, K, shape, dtype, index, flush, timed):
    """beam_reorder_kv against its plain version, bit for bit. ``index``:
    "beams" (each group of 5 rows draws its sources from its own group,
    repeats allowed), "perm" (a permutation within each group: every
    source read once), "identity" or "fanout" (every row from row 1).
    The bound counts the bytes this index needs: every destination row
    written once, every distinct source row read once."""
    L, N = shape[:2]
    g = torch.Generator(device="cuda").manual_seed(7)
    sk, sv = (torch.randn(shape, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    grp = torch.arange(N, device="cuda") // BEAM
    if index == "identity":
        idx = torch.arange(N, device="cuda")
    elif index == "fanout":
        idx = torch.ones(N, dtype=torch.long, device="cuda")
    elif index == "perm":
        idx = torch.argsort(grp + torch.rand(N, generator=g, device="cuda"))
    else:
        idx = torch.clamp(grp * BEAM + torch.randint(
            0, BEAM, (N,), generator=g, device="cuda"), max=N - 1)
    got = K.beam_reorder_kv(sk, sv, idx)
    ref = K.beam_reorder_kv_plain(sk, sv, idx)
    ok = all(_same_bits(torch, a, b) for a, b in zip(got, ref))
    row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "index": index, "max_abs_err": max(
               (a.float() - b.float()).abs().max().item()
               for a, b in zip(got, ref)), "tol": "bit-exact"}
    del got, ref
    if timed:
        row["ms"] = time_ms(torch, lambda: K.beam_reorder_kv(sk, sv, idx),
                            iters=10, flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.beam_reorder_kv_plain(sk, sv, idx), iters=10,
            flush=flush)
        row["library_ms"] = time_ms(  # two index_select calls
            torch, lambda: (torch.index_select(sk, 1, idx),
                            torch.index_select(sv, 1, idx)),
            iters=10, flush=flush)
        onehot = torch.nn.functional.one_hot(idx, N).to(dtype)
        row["onehot_einsum_ms"] = time_ms(
            torch, lambda: (torch.einsum("nb,lbhcd->lnhcd", onehot, sk),
                            torch.einsum("nb,lbhcd->lnhcd", onehot, sv)),
            iters=5, flush=flush)
        sources = idx.unique().numel()
        slab = sk[0, 0].numel() * sk.element_size()
        row["distinct_sources"] = sources
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * L * slab * (N + sources) + 8 * N, 0, "bf16")
    return row, ok


def phase_kernels(torch, K) -> dict:
    """Every kernel against its plain version; returns the JSON rows'
    measured fields at the large-v3 main-path shapes."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    bad = []
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("flash_attention", lambda t: _flash_case(
            torch, K, (3, 4, 300, 32), torch.float32, flush, t,
            expect="cuda_cores"), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (2, 3, 77, 80), torch.bfloat16, flush, t,
            expect="mma"), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (1, 2, 333, 128), torch.bfloat16, flush, t, 300,
            expect="mma"), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (2, 3, 100, 40), torch.bfloat16, flush, t,
            expect="cuda_cores"), False),
        # the wgmma kernel: ragged tiles, one valid key in the last tile,
        # one (b, h); a view no TMA map describes takes mma.sync
        *[("flash_attention", (lambda T, kv: lambda t: _flash_case(
            torch, K, (2, 3, T, 64), bf16, flush, t, kv, expect="wgmma"))(
                T, kv), False)
          for T, kv in ((1, None), (65, None), (193, None), (300, 257))],
        ("flash_attention", lambda t: _flash_case(
            torch, K, (1, 1, 200, 64), bf16, flush, t, expect="wgmma"),
            False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (2, 3, 150, 64), bf16, flush, t, layout="zero",
            expect="mma"), False),
        # the main path: the encoder's head-strided view of its (B, T, H, D)
        # projections, and the same shape contiguous
        ("flash_attention", lambda t: _flash_case(
            torch, K, (16, 20, 1500, 64), torch.bfloat16, flush, t,
            layout="bthd", expect="wgmma"), True),
        ("flash_attention@contiguous", lambda t: _flash_case(
            torch, K, (16, 20, 1500, 64), torch.bfloat16, flush, t,
            expect="wgmma"), True),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 3, 128, 512, torch.float32, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 5, 200, 72, torch.bfloat16, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(   # two 16-row chunks of x
            torch, K, 37, 300, 260, torch.float32, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(   # byte loads, din split
            torch, K, 20, 1300, 77, torch.bfloat16, flush, t), False),
        # edges: one row, 80 rows, two row blocks of x
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 1, 200, 72, bf16, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 8, 300, 260, f32, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 80, 1300, 77, bf16, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 129, 1280, 1280, bf16, flush, t), False),
        *[("matmul_q8w", (lambda din, dout: lambda t: _q8w_case(
            torch, K, 16, din, dout, bf16, flush, t))(din, dout),
            True) for din, dout, _ in LARGE_V3_Q8W],
        # the benchmark profile's int8 blocks run at window batch 32
        *[("matmul_q8w@32", (lambda din, dout: lambda t: _q8w_case(
            torch, K, 32, din, dout, bf16, flush, t))(din, dout),
            True) for din, dout, _ in LARGE_V3_Q8W[:3]],
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 3, 4, 1, 32, 300, torch.float32, flush, t), False),
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 2, 3, 5, 64, 301, torch.bfloat16, flush, t), False),
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 16, 20, 1, 64, 1500, torch.bfloat16, flush, t), True),
        ("decode_cross_attention_q4", lambda t: _cross4_case(
            torch, K, 3, 4, 1, 32, 300, f32, flush, t), False),
        ("decode_cross_attention_q4", lambda t: _cross4_case(
            torch, K, 2, 3, 5, 64, 301, bf16, flush, t), False),
        ("decode_cross_attention_q4", lambda t: _cross4_case(  # beams
            torch, K, 32, 20, 5, 64, 1500, bf16, flush, t), False),
        ("decode_cross_attention_q4", lambda t: _cross4_case(
            torch, K, 32, 20, 1, 64, 1500, bf16, flush, t), True),
        ("matmul_q4w", lambda t: _q4w_case(
            torch, K, 3, 128, 512, 128, f32, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(   # ragged dout, byte loads
            torch, K, 5, 200, 72, 40, bf16, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(   # odd group, B > 16
            torch, K, 37, 300, 260, 3, f32, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(   # din split
            torch, K, 20, 1300, 77, 100, bf16, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(
            torch, K, 1, 200, 72, 40, bf16, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(
            torch, K, 8, 300, 260, 3, bf16, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(
            torch, K, 80, 1300, 77, 100, f32, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(   # two row blocks
            torch, K, 129, 1280, 1280, 80, bf16, flush, t), False),
        ("matmul_q4w", lambda t: _q4w_case(   # the benchmark profile's head
            torch, K, 32, 1280, 51968, 80, bf16, flush, t), True),
        # the capacity profile's all-int4 decode step at window batch 16
        *[("matmul_q4w@16", (lambda din, dout, grp: lambda t: _q4w_case(
            torch, K, 16, din, dout, grp, bf16, flush, t))(din, dout, grp),
            True) for din, dout, _, grp in LARGE_V3_Q4W],
        # llama-3.2-3b's decode step (the answer phase): every int8
        # linear at one row and at a wave of 16, and the int4 head
        *[(f"matmul_q8w@llm{B}", (lambda B, din, dout: lambda t: _q8w_case(
            torch, K, B, din, dout, bf16, flush, t))(B, din, dout), True)
          for B in LLM_ROWS for din, dout, _ in LLAMA_3B_Q8W],
        *[(f"matmul_q4w@llm{B}", (lambda B: lambda t: _q4w_case(
            torch, K, B, 3072, 128256, 128, bf16, flush, t))(B), True)
          for B in LLM_ROWS],
        # the stream path (configs/low_latency.yaml): every int8 linear,
        # the encoder's attention and the cross kernel at a lone chunk's
        # dispatch and at a full mux's
        *[(f"matmul_q8w@stream{B}", (lambda B, din, dout: lambda t:
            _q8w_case(torch, K, B, din, dout, bf16, flush, t))(B, din, dout),
            True) for B in STREAM_ROWS for din, dout, _ in LARGE_V3_Q8W],
        *[(f"flash_attention@stream{B}", (lambda B: lambda t: _flash_case(
            torch, K, (B, 20, 1500, 64), bf16, flush, t, layout="bthd",
            expect="wgmma"))(B), True) for B in STREAM_ROWS],
        *[(f"decode_cross_attention_q8@stream{B}", (lambda B: lambda t:
            _cross_case(torch, K, B, 20, 1, 64, 1500, bf16, flush, t))(B),
            True) for B in STREAM_ROWS],
        # decoder_int4's 3b block shapes (not on the answer path)
        *[("matmul_q4w", (lambda din, dout: lambda t: _q4w_case(
            torch, K, 16, din, dout, 128, bf16, flush, t))(din, dout),
            False) for din, dout, _ in LLAMA_3B_Q8W[:4]],
        ("decode_self_attention_q8", lambda t: _self8_case(
            torch, K, 2, 4, 1, 32, 128, 37, f32, flush, t), False),
        ("decode_self_attention_q8", lambda t: _self8_case(
            torch, K, 3, 5, 2, 64, 130, 100, bf16, flush, t), False),
        ("decode_self_attention_q8", lambda t: _self8_case(  # all masked
            torch, K, 1, 4, 1, 32, 128, 0, f32, flush, t), False),
        ("decode_self_attention_q8", lambda t: _self8_case(
            torch, K, 16, 20, 1, 64, 256, 40, bf16, flush, t), True),
        # the capacity profile at Whisper's longest cache, the spine's
        # int8+dec4+skv8 call (tiny-synth), and edges: the threads' copies
        # (Cp 1, 127, 129), every query count, hd 128, caches in stages
        ("decode_self_attention_q8@512", lambda t: _self8_case(
            torch, K, 16, 20, 1, 64, 512, 300, bf16, flush, t), True),
        ("decode_self_attention_q8@spine", lambda t: _self8_case(
            torch, K, 1, 4, 1, 32, 128, 9, f32, flush, t), True),
        *[("decode_self_attention_q8", (lambda M, hd, Cp, n: lambda t:
            _self8_case(torch, K, 2, 3, M, hd, Cp, n, bf16, flush, t))(
                M, hd, Cp, n), False)
          for M, hd, Cp, n in ((1, 64, 1, 1), (8, 32, 127, 0),
                               (5, 64, 129, 129), (8, 128, 448, 448),
                               (2, 64, 512, 1), (8, 128, 2048, 2000))],
        # the beam phase's decode step: K = 5 beams of 16 windows
        ("decode_cross_attention_q8@beam", lambda t: _cross_case(
            torch, K, 16, 20, BEAM, 64, 1500, bf16, flush, t), True),
        ("decode_cross_attention_q4@beam", lambda t: _cross4_case(
            torch, K, 16, 20, BEAM, 64, 1500, bf16, flush, t), True),
        # a speculative verify block, and the capacity profile's call
        ("decode_cross_attention_q8@verify", lambda t: _cross_case(
            torch, K, 16, 20, 8, 64, 1500, bf16, flush, t), True),
        ("decode_cross_attention_q4@verify", lambda t: _cross4_case(
            torch, K, 16, 20, 8, 64, 1500, bf16, flush, t), True),
        ("decode_cross_attention_q4@capacity", lambda t: _cross4_case(
            torch, K, 16, 20, 1, 64, 1500, bf16, flush, t), True),
        # a long Ta, near the plan's shared-memory limit at M = 8
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 2, 3, 8, 64, 3400, bf16, flush, t), False),
        ("decode_cross_attention_q4", lambda t: _cross4_case(
            torch, K, 2, 3, 8, 64, 3400, f32, flush, t), False),
        *[("matmul_q8w@beam", (lambda din, dout: lambda t: _q8w_case(
            torch, K, BEAM * BEAM_WB, din, dout, bf16, flush, t))(din, dout),
            True) for din, dout, _ in LARGE_V3_Q8W[:3]],
        ("matmul_q4w@beam", lambda t: _q4w_case(
            torch, K, BEAM * BEAM_WB, 1280, 51968, 80, bf16, flush, t),
            True),
        (REORDER, lambda t: _reorder_case(
            torch, K, (2, 6, 2, 4, 16), f32, "beams", flush, t), False),
        (REORDER, lambda t: _reorder_case(   # ragged slab: the byte path
            torch, K, (3, 10, 3, 7, 5), bf16, "beams", flush, t), False),
        (REORDER, lambda t: _reorder_case(
            torch, K, (3, 10, 3, 7, 5), bf16, "identity", flush, t), False),
        (REORDER, lambda t: _reorder_case(
            torch, K, (2, 12, 4, 9, 64), f32, "fanout", flush, t), False),
        # the beam-outermost layout probe of scripts/bench_beam_reorder.py
        (REORDER + "@probe", lambda t: _reorder_case(
            torch, K, (1, 40, 1, 72960, 128), bf16, "beams", flush, t),
            True),
        (REORDER + "@probe-perm", lambda t: _reorder_case(
            torch, K, (1, 40, 1, 72960, 128), bf16, "perm", flush, t),
            True),
        # the main path: large-v3, window batch 16 x beam 5, C = 228; a
        # beam step's index repeats sources, a permutation reads each once
        (REORDER, lambda t: _reorder_case(
            torch, K, (32, BEAM * BEAM_WB, 20, 228, 64), bf16, "beams",
            flush, t), True),
        (REORDER + "@perm", lambda t: _reorder_case(
            torch, K, (32, BEAM * BEAM_WB, 20, 228, 64), bf16, "perm",
            flush, t), True),
    ]
    large: dict[str, list[dict]] = {}
    for name, case, timed in cases:
        row, ok = case(timed)
        torch.cuda.synchronize()
        print(f"kernel {name} {json.dumps(row)} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            bad.append(f"{name} {row['shape']}")
        if timed:
            large.setdefault(name, []).append(row)
    if bad:
        fail("kernel disagrees with its plain version: " + ", ".join(bad))

    # one JSON row per kernel at the full-width main path's shapes: flash
    # and the attention kernels per layer call; matmul_q8w summed over one
    # decode step; matmul_q4w per call of the benchmark profile's head
    def agg(rows, weights):
        out = {"max_abs_err": max(r["max_abs_err"] for r in rows)}
        for key in ("ms", "plain_ms", "bound_ms"):
            out[key] = sum(w * r[key] for w, r in zip(weights, rows))
        libs = [r["library_ms"] for r in rows]
        out["library_ms"] = (None if any(x is None for x in libs)
                             else sum(w * x for w, x in zip(weights, libs)))
        by = {r["bound_by"] for r in rows}
        out["bound_by"] = by.pop() if len(by) == 1 else "bytes"
        return out

    llm_calls = [c for _, _, c in LLAMA_3B_Q8W]
    llm = {B: {"q8": agg(large[f"matmul_q8w@llm{B}"], llm_calls),
               "q8_blocks": agg(large[f"matmul_q8w@llm{B}"][:4],
                                llm_calls[:4]),
               "q4_head": agg(large[f"matmul_q4w@llm{B}"], [1])}
           for B in LLM_ROWS}
    for B in LLM_ROWS:
        print(f"decode-step sums {LLM} B={B}", json.dumps({
            "matmul_q8w, the 113 calls a token under decoder_int8":
                llm[B]["q8"],
            "matmul_q8w, the 112 block calls (lm_head_int4)":
                llm[B]["q8_blocks"],
            "matmul_q4w, the int4 head (lm_head_int4, group 128)":
                llm[B]["q4_head"]}), flush=True)
    for B in STREAM_ROWS:
        print(f"stream path B={B}", json.dumps({
            "matmul_q8w, the 257 calls a decode step":
                agg(large[f"{Q8W}@stream{B}"],
                    [c for _, _, c in LARGE_V3_Q8W]),
            f"flash_attention at ({B}, 20, 1500, 64) bf16, head-strided, "
            "per call": agg(large[f"{FLASH}@stream{B}"], [1]),
            f"decode_cross_attention_q8 at ({B}, 20, 1, 64), Ta 1500, per "
            "call": agg(large[f"{CROSS8}@stream{B}"], [1])}), flush=True)
    print("decode-step sums", json.dumps({
        "matmul_q8w at B=32, the benchmark profile's 256 int8 block calls":
            agg(large["matmul_q8w@32"], [c for _, _, c in LARGE_V3_Q8W[:3]]),
        "matmul_q4w at B=16, the capacity profile's 257 calls":
            agg(large["matmul_q4w@16"], [c for _, _, c, _ in LARGE_V3_Q4W]),
        "matmul_q8w at B=80, the beam phase's 256 int8 block calls":
            agg(large["matmul_q8w@beam"], [c for _, _, c in LARGE_V3_Q8W[:3]]),
        "matmul_q4w at B=80, the beam phase's int4 head":
            agg(large["matmul_q4w@beam"], [1]),
        "decode_cross_attention_q8 at (16, 20, 5, 64), Ta 1500, per call":
            agg(large["decode_cross_attention_q8@beam"], [1]),
        "decode_cross_attention_q4 at (16, 20, 5, 64), Ta 1500, per call":
            agg(large["decode_cross_attention_q4@beam"], [1]),
        "decode_cross_attention_q4 at (16, 20, 1, 64), Ta 1500, per call "
        "(the capacity profile)":
            agg(large["decode_cross_attention_q4@capacity"], [1]),
        "decode_self_attention_q8 at (16, 20, 1, 64), Cp 512, per call "
        "(the capacity profile at Whisper's longest cache)":
            agg(large[SELF8 + "@512"], [1]),
        "decode_self_attention_q8 at (1, 4, 1, 32), Cp 128, f32, per call "
        "(the spine's int8+dec4+skv8 profile)":
            agg(large[SELF8 + "@spine"], [1]),
        "decode_cross_attention_q8 at (16, 20, 8, 64), Ta 1500, per call "
        "(a speculative verify block)":
            agg(large["decode_cross_attention_q8@verify"], [1]),
        "decode_cross_attention_q4 at (16, 20, 8, 64), Ta 1500, per call "
        "(a speculative verify block)":
            agg(large["decode_cross_attention_q4@verify"], [1]),
        **{f"beam_reorder_kv at {at}, {how}": {
            **agg(large[REORDER + key], [1]),
            **{k: large[REORDER + key][0][k]
               for k in ("onehot_einsum_ms", "distinct_sources")}}
           for key, at, how in (
               ("@probe", "the probe's (1, 40, 1, 72960, 128) bf16",
                "a beam index"),
               ("@probe-perm", "the probe's (1, 40, 1, 72960, 128) bf16",
                "a permutation"),
               ("@perm", "(32, 80, 20, 228, 64) bf16", "a permutation"))},
    }), flush=True)
    print("flash_attention mufu bound (computed)",
          json.dumps(mufu_bound(torch, 16, 20, 1500, 1500)), flush=True)
    contiguous = large[FLASH + "@contiguous"][0]
    return {
        FLASH: {**agg(large[FLASH], [1]),
                "contiguous": {key: contiguous[key] for key in (
                    "ms", "plain_ms", "library_ms", "max_abs_err")},
                "per": "call at (16, 20, 1500, 64) bf16, the encoder's "
                       "head-strided view of its (B, T, H, D) projections "
                       "(one encoder layer, 16 windows); \"contiguous\": "
                       "the same shape in a (B, H, T, D) tensor"},
        Q8W: {**agg(large[Q8W], [c for _, _, c in LARGE_V3_Q8W]),
              "per": "decode step: 257 calls at B=16 (192×1280², "
                     "32×1280→5120, 32×5120→1280, 1×1280→51968)",
              "llm": {f"B={B}": llm[B]["q8"] for B in LLM_ROWS} | {
                  "per": f"{LLM} decode step under decoder_int8: 113 "
                         "calls (28 × (3072→5120, 3072→3072, 3072→16384, "
                         "8192→3072) + 3072→128256)"}},
        CROSS8: {**agg(large[CROSS8], [1]),
                 "per": "call at (16, 20, 1, 64), Ta=1500 "
                        "(one layer, one step)"},
        CROSS4: {**agg(large[CROSS4], [1]),
                 "per": "call at (32, 20, 1, 64), Ta=1500 "
                        "(one layer, one step, window batch 32)"},
        Q4W: {**agg(large[Q4W], [1]),
              "per": "call at B=32, 1280→51968, group 80 (the benchmark "
                     "profile's logits head, once per step)",
              "llm": {f"B={B}": llm[B]["q4_head"] for B in LLM_ROWS} | {
                  "per": f"call at 3072→128256, group 128 ({LLM}'s head "
                         "under lm_head_int4, once per step)"}},
        SELF8: {**agg(large[SELF8], [1]),
                "per": "call at (16, 20, 1, 64), Cp=256 (one layer, one "
                       "step of the capacity profile)"},
        REORDER: {**agg(large[REORDER], [1]),
                  "onehot_einsum_ms": large[REORDER][0]["onehot_einsum_ms"],
                  "distinct_sources": large[REORDER][0]["distinct_sources"],
                  "per": "call at (32, 80, 20, 228, 64) bf16 (both self "
                         "caches, one beam step, window batch 16 x beam 5, "
                         "C = 228, a beam index)"},
    }


# -- phases 3 and 4: the ingest → query path ----------------------------------------

def speak(turns, rng, window_s: float):
    """The JAX package's trained end-to-end test turns, rendered in the same
    order from the same rng, each starting 0.3 s into a window of its own.

    Without diarization a transcript segment is one ASR window, so turns
    that share a window share a chunk; the test's own layout (0.5 s gaps)
    puts the first two turns into one 6 s window, where both packages rank
    the "spectrogram harmonic" query's turn second."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR, synth_text

    win, lead = int(round(window_s * SR)), int(0.3 * SR)
    pieces = []
    for text in turns:
        wav = synth_text(text, rng, noise_level=0.005)
        if lead + wav.size > win:
            fail(f"turn {text!r} does not fit one {window_s} s window")
        piece = np.zeros(win, np.float32)
        piece[lead: lead + wav.size] = wav
        pieces.append(piece)
    return np.concatenate(pieces)


def spine_config(device: str, profile: str):
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, EmbeddingConfig,
        RerankingConfig, RetrievalConfig)

    return AudioRAGConfig(
        asr=ASRConfig(model_size="tiny-synth", compute_type="float32",
                      vad_filter=False, temperature_fallback=False,
                      **PROFILES[profile][0]),
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        # reranking is the query phase's; these paths hold the ASR
        reranking=RerankingConfig(backend="none"),
        # small max_tokens: each 6 s window's segment becomes its own chunk
        chunking=ChunkingConfig(max_tokens=8, min_chunk_tokens=1,
                                overlap_tokens=0),
        device=device)


@contextlib.contextmanager
def run_with_reorder(profile: str):
    """Beam profiles run with ``BEAM_REORDER=kernel`` (the reorder of the
    self caches through the kernel), restored afterwards."""
    if PROFILES[profile][0].get("decode") != "beam":
        yield
        return
    saved = os.environ.get("BEAM_REORDER")
    os.environ["BEAM_REORDER"] = "kernel"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("BEAM_REORDER", None)
        else:
            os.environ["BEAM_REORDER"] = saved


def run_spine(device: str, profile: str, workdir: Path) -> dict:
    """Ingest the three turns and run both queries; returns what it saw."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.audio.io import write_wav
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(spine_config(device, profile))
    wav_path = workdir / "lecture.wav"
    audio = speak(SPINE_TURNS, np.random.default_rng(7),
                  rag.asr.window_seconds)
    write_wav(wav_path, audio, SR)
    rag.asr  # load the models outside the timed ingest
    rag.embedder
    t0 = time.perf_counter()
    with run_with_reorder(profile):
        res = rag.ingest(str(wav_path), collection="spine", diarize=False)
    ingest_s = time.perf_counter() - t0
    out = {"chunks": res.num_chunks, "ingest_ms": ingest_s * 1e3,
           "decode_steps": rag.asr.timings["decode_steps"],
           "transcripts": [c["text"] for c in
                           rag.store._collections["spine"].payloads],
           "queries": []}
    for text, words in SPINE_QUERIES:
        t0 = time.perf_counter()
        hits = rag.query(text, top_k=2, search_type="hybrid",
                         collection="spine").results
        out["queries"].append({
            "query": text, "ms": (time.perf_counter() - t0) * 1e3,
            "top": [h.text for h in hits],
            "ok": bool(hits) and any(w in hits[0].text for w in words)})
    return out


WGMMA = FLASH + "_wgmma"  # flash launches that ran the wgmma kernel


def launch_counts(K) -> dict:
    """Launches per kernel since the last reset, and the flash launches
    that took the wgmma kernel."""
    return {**K.LAUNCHES, WGMMA: K.FLASH_VARIANTS["wgmma"]}


def check_launches(path: str, launches: dict, expect: set,
                   encoder_calls: int | None = None) -> None:
    """Fail unless every kernel of the path launched and, where
    ``encoder_calls`` is given (the large-v3 paths: 32 a window batch),
    unless the path made exactly that many flash calls, all through the
    wgmma kernel."""
    missing = sorted(name for name in expect if launches.get(name, 0) == 0)
    if missing:
        fail(f"{path}: kernels of the path never launched: {missing} "
             f"(launches {launches})")
    if encoder_calls is not None and not (
            launches[FLASH] == launches[WGMMA] == encoder_calls):
        fail(f"{path}: expected {encoder_calls} encoder flash calls, all "
             f"through the wgmma kernel; got {launches[FLASH]} calls, "
             f"{launches[WGMMA]} through it")


SPINE_PROFILES = ("int8", "int8+dec4+skv8", "kv4+int8+lm4", "beam5+int8",
                  "spec8+int8")


def phase_spine(torch, K, workdir: Path) -> dict:
    """The spine in five decode profiles; returns launches by path."""
    by_path, transcripts = {}, {}
    for profile in SPINE_PROFILES:
        K.reset_launches()
        out = run_spine("cuda", profile, workdir)
        torch.cuda.synchronize()
        launches = launch_counts(K)
        tag = f"spine[{profile}]"
        transcripts[profile] = out["transcripts"]
        print(f"{tag} transcripts (chunk texts):",
              json.dumps(out["transcripts"]))
        print(f"{tag} chunks {out['chunks']} ingest_ms "
              f"{out['ingest_ms']:.1f} decode loop iterations "
              f"{out['decode_steps']}")
        for q in out["queries"]:
            print(f"{tag} query {q['query']!r} ms {q['ms']:.1f} "
                  f"top {json.dumps(q['top'])} spoken words in the top "
                  f"hit: {'yes' if q['ok'] else 'no'}")
        print(f"{tag} launches", json.dumps(launches), flush=True)
        if out["chunks"] < 2:
            fail(f"{tag} produced {out['chunks']} chunk(s); expected several")
        if PROFILES[profile][0].get("cross_kv_int4"):
            # int4 cross K/V garbles tiny-synth's words (in the JAX package
            # too): hold the card to the port's CPU run of the same profile
            cpu = run_spine("cpu", profile, workdir)
            print(f"{tag} cpu transcripts (chunk texts):",
                  json.dumps(cpu["transcripts"]))
            print(f"{tag} cpu tops",
                  json.dumps([q["top"] for q in cpu["queries"]]), flush=True)
            same = (cpu["chunks"] == out["chunks"] and all(
                c["top"][:1] == g["top"][:1]
                for c, g in zip(cpu["queries"], out["queries"])))
            if not same:
                fail(f"{tag}: top hits or chunk count differ from the CPU "
                     "run of the same profile")
        elif not all(q["ok"] for q in out["queries"]):
            fail(f"{tag}: a query's top hit lacks its spoken words")
        if profile == "spec8+int8" and out["transcripts"] != transcripts[
                "int8"]:
            fail(f"{tag}: speculative transcripts differ from greedy's")
        check_launches(tag, launches, PROFILES[profile][1])
        by_path[tag] = launches
    return by_path


# -- phase 8: the diarized ingest ---------------------------------------------------

DIAR_PROFILE = "int8"
TIME_TOL = 0.02  # one encoder frame
DER_BOUND = 0.35  # the JAX package's trained speaker test's bound


def gap_audio():
    """The JAX package's trained end-to-end test layout: 0.3 s of silence,
    then each turn (rng 7) followed by 0.5 s of silence."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR, synth_text

    rng = np.random.default_rng(7)
    pieces = [np.zeros(int(0.3 * SR), np.float32)]
    for text in SPINE_TURNS:
        pieces.append(synth_text(text, rng, noise_level=0.005))
        pieces.append(np.zeros(int(0.5 * SR), np.float32))
    return np.concatenate(pieces)


def run_diarized(device: str, wav_path: Path) -> dict:
    """``AudioRAG.ingest(diarize=True)`` of the end-to-end layout as that
    test configures it (no VAD filter on the ASR, at most 2 speakers),
    then both queries; returns the chunks, the words and the hits."""
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, DiarizationConfig,
        EmbeddingConfig, RerankingConfig, RetrievalConfig)
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(AudioRAGConfig(
        asr=ASRConfig(model_size="tiny-synth", compute_type="float32",
                      vad_filter=False, temperature_fallback=False,
                      **PROFILES[DIAR_PROFILE][0]),
        diarization=DiarizationConfig(max_speakers=2),
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(backend="none"),
        chunking=ChunkingConfig(min_chunk_tokens=1, overlap_tokens=0),
        device=device))
    asr = rag.asr
    rag.diarizer
    rag.embedder
    words: list = []
    transcribe = asr.transcribe_with_words

    def spy(*args, **kw):
        segs = transcribe(*args, **kw)
        words.extend((w.text, float(w.start), float(w.end))
                     for s in segs for w in s.words)
        return segs

    asr.transcribe_with_words = spy
    t0 = time.perf_counter()
    res = rag.ingest(str(wav_path), collection="diar")
    ingest_ms = (time.perf_counter() - t0) * 1e3
    chunks = [(c["text"], c["speaker"], float(c["start"]), float(c["end"]))
              for c in rag.store._collections["diar"].payloads]
    out = {"chunks": chunks, "words": words, "ingest_ms": ingest_ms,
           "speakers": res.num_speakers, "stages": res.stage_timings,
           "align_pass_s": asr.timings["align_s"], "queries": []}
    for text, spoken in SPINE_QUERIES:
        hits = rag.query(text, top_k=2, search_type="hybrid",
                         collection="diar").results
        out["queries"].append({
            "query": text, "top": [h.text for h in hits],
            "ok": bool(hits) and any(w in hits[0].text for w in spoken)})
    return out


def run_der(device: str, audio, turns) -> dict:
    """Both diarizers on the conversation (energy VAD, 3 speakers):
    DER against its turns and the diarizers' stage timings."""
    from audio_rag_tpu_torch.config import DiarizationConfig
    from audio_rag_tpu_torch.core.types import TranscriptSegment
    from audio_rag_tpu_torch.diarization import create_diarizer
    from audio_rag_tpu_torch.diarization.metrics import (
        diarization_error_rate)

    ref = [TranscriptSegment("", s, e, f"REF_{k}") for s, e, k in turns]
    out = {}
    for backend in ("clustering", "ahc"):
        d = create_diarizer(DiarizationConfig(backend=backend,
                                              vad_backend="energy"),
                            device=device)
        d.load()
        t0 = time.perf_counter()
        hyp = d.diarize(audio, 16_000, num_speakers=3)
        ms = (time.perf_counter() - t0) * 1e3
        out[backend] = {"der": diarization_error_rate(ref, hyp).der,
                        "ms": ms, "segments": len(hyp), **d.timings}
    return out


def phase_diarize(torch, K, workdir: Path) -> dict:
    """The diarized ingest on the card against the port's CPU run, the DER
    case, and a 10-minute conversation; returns launches by path."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.audio.io import write_wav
    from audio_rag_tpu_torch.audio.synth import conversation, sample_voice
    from audio_rag_tpu_torch.config import DiarizationConfig
    from audio_rag_tpu_torch.core.types import TranscriptSegment
    from audio_rag_tpu_torch.diarization import create_diarizer
    from audio_rag_tpu_torch.diarization.metrics import (
        diarization_error_rate)

    # (a) the end-to-end layout, card against CPU
    wav_path = workdir / "lecture_gaps.wav"
    write_wav(wav_path, gap_audio(), SR)
    K.reset_launches()
    card = run_diarized("cuda", wav_path)
    torch.cuda.synchronize()
    launches = launch_counts(K)
    cpu = run_diarized("cpu", wav_path)
    tag = f"diarize[{DIAR_PROFILE}]"
    print(f"{tag} chunks (text, speaker, start, end):",
          json.dumps(card["chunks"]))
    print(f"{tag} cpu chunks:", json.dumps(cpu["chunks"]))
    print(f"{tag} ingest_ms {card['ingest_ms']:.1f} speakers "
          f"{card['speakers']} align_pass_s {card['align_pass_s']:.4f} "
          f"stages {json.dumps(card['stages'])}")
    for q in card["queries"]:
        print(f"{tag} query {q['query']!r} top {json.dumps(q['top'])} "
              f"spoken words in the top hit: {'yes' if q['ok'] else 'no'}")
    print(f"{tag} launches", json.dumps(launches), flush=True)
    if not card["chunks"] or not all(c[1] for c in card["chunks"]):
        fail(f"{tag}: no chunks, or chunks without a speaker")
    if [c[:2] for c in card["chunks"]] != [c[:2] for c in cpu["chunks"]]:
        fail(f"{tag}: chunk texts or speakers differ from the CPU run")
    dw = [max(abs(a[1] - b[1]), abs(a[2] - b[2]))
          for a, b in zip(card["words"], cpu["words"])]
    print(f"{tag} words {len(card['words'])} max word-time difference to "
          f"the CPU run {max(dw, default=0.0):.3f} s", flush=True)
    if ([w[0] for w in card["words"]] != [w[0] for w in cpu["words"]]
            or not dw or max(dw) > TIME_TOL):
        fail(f"{tag}: words or word times differ from the CPU run")
    if not all(q["ok"] for q in card["queries"]):
        fail(f"{tag}: a query's top hit lacks its spoken words")
    check_launches(tag, launches, PROFILES[DIAR_PROFILE][1])

    # (b) the DER case: the trained speaker test's conversation
    rng = np.random.default_rng(2024)
    voices = [sample_voice(rng) for _ in range(3)]
    audio, turns = conversation(rng, voices, duration_s=50.0)
    der_card, der_cpu = run_der("cuda", audio, turns), run_der("cpu", audio,
                                                               turns)
    for backend in der_card:
        got, ref = der_card[backend], der_cpu[backend]
        print(f"diarize[der,{backend}] card {json.dumps(got)} cpu DER "
              f"{ref['der']}", flush=True)
        if not got["der"] < DER_BOUND or abs(got["der"] - ref["der"]) > 0.01:
            fail(f"diarize[der,{backend}]: DER {got['der']} (CPU "
                 f"{ref['der']}, bound {DER_BOUND})")

    # (c) a 10-minute 4-voice conversation on the card
    t0 = time.perf_counter()
    rng = np.random.default_rng(99)
    voices = [sample_voice(rng) for _ in range(4)]
    long_audio, long_turns = conversation(rng, voices, duration_s=600.0)
    synth_s = time.perf_counter() - t0
    d = create_diarizer(DiarizationConfig(), device="cuda")
    d.load()
    d.diarize(long_audio[: 30 * SR], SR)  # first calls, outside the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    segs = d.diarize(long_audio, SR)
    wall = time.perf_counter() - t0
    tm = d.timings
    out = {"audio_s": len(long_audio) / SR, "windows": tm["windows"],
           "vad_clips": -(-len(long_audio) // (3 * SR)),
           "vad_ms": tm["vad_s"] * 1e3, "embed_ms": tm["embed_s"] * 1e3,
           "cluster_ms": tm["cluster_s"] * 1e3, "diarize_s": wall,
           "diarize_s_per_audio_s": wall / (len(long_audio) / SR),
           "speakers": len({s.speaker for s in segs}),
           "turns_voices": len({k for _, _, k in long_turns}),
           "segments": len(segs),
           "der": diarization_error_rate(
               [TranscriptSegment("", s, e, f"REF_{k}")
                for s, e, k in long_turns], segs).der,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "synth_s": synth_s}
    print("diarize[10min]", json.dumps(out), flush=True)
    if out["windows"] <= 512 or out["vad_clips"] <= 128 or not segs:
        fail(f"diarize[10min]: expected more than 512 windows and 128 VAD "
             f"clips and some segments, got {out}")
    return {tag: launches}


# -- phase 9: the fallback ladder, language detection, conditioned windows ---------

FALLBACK_PROFILE = "int8"
GUMBEL_ULPS = 2  # of max(|g|, 1): the card's log against the host's


def check_prng(torch) -> dict:
    """(a) The port's JAX PRNG at the large-v3 decode shape (16, 51866) on
    the card against the CPU: bits equal, Gumbel noise within 2 ulp of
    max(|g|, 1), and the draws of ``categorical`` on the same logits."""
    import numpy as np

    from audio_rag_tpu_torch.ops import random as R

    shape, key = (16, 51866), R.split(R.PRNGKey(40))[1]
    bits = R.random_bits(key, shape, "cuda").cpu()
    same_bits = torch.equal(bits, R.random_bits(key, shape, "cpu"))
    g_card = R.gumbel(key, shape, "cuda").cpu().numpy()
    g_cpu = R.gumbel(key, shape, "cpu").numpy()
    ulps = np.abs(g_card - g_cpu) / np.spacing(
        np.maximum(np.abs(g_cpu), 1.0).astype(np.float32))
    logits = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    logp = torch.log_softmax(logits * 3.0, dim=-1)
    draws_card = R.categorical(key, logp.cuda()).cpu()
    draws_cpu = R.categorical(key, logp)
    t0 = time.perf_counter()
    for _ in range(20):
        R.categorical(key, logp.cuda())
    torch.cuda.synchronize()
    out = {"shape": list(shape), "bits_equal": bool(same_bits),
           "gumbel_max_ulps": float(ulps.max()),
           "gumbel_elements_off": int((ulps > 0).sum()),
           "draws_equal": int((draws_card == draws_cpu).sum()),
           "rows": shape[0],
           "categorical_host_ms": (time.perf_counter() - t0) / 20 * 1e3}
    print("fallback[prng]", json.dumps(out), flush=True)
    if not same_bits or not out["gumbel_max_ulps"] <= GUMBEL_ULPS or \
            out["draws_equal"] != shape[0]:
        fail(f"fallback[prng]: the card's draws differ from the CPU's: {out}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def run_test_ladder(device: str, params, audio) -> dict:
    """The ``test`` preset (f32) with the ladder on and no language: the
    windows' final temperatures and segment texts (the token ids)."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.config import ASRConfig

    asr = WhisperASR(ASRConfig(model_size="test", compute_type="float32",
                               vad_filter=False, window_batch_size=4),
                     device)
    asr._params = _to(params, device)
    segs = asr.transcribe(audio, 16_000)
    return {"temps": asr.window_temps, "texts": [s.text for s in segs],
            "decodes": asr.timings["fallback_decodes"]}


def spy_rungs(torch, K, asr, rungs: list) -> None:
    """Record each ``_decode`` call of ``asr``: temperature, prompt length,
    host ms (synchronized), loop iterations and its kernel launches."""
    decode = asr._decode

    def spy(enc, prompt, temperature=0.0):
        torch.cuda.synchronize()
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        out = decode(enc, prompt, temperature)
        torch.cuda.synchronize()
        rungs.append({
            "temperature": temperature, "prompt_len": int(prompt.shape[1]),
            "rows": int(prompt.shape[0]),
            "ms": (time.perf_counter() - t0) * 1e3, "steps": int(out[3]),
            "launches": {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                         if K.LAUNCHES[k] > before[k]}})
        return out

    asr._decode = spy


def language_probs(torch, asr, wav):
    """The language block's probabilities of ``asr.detect_language``'s
    computation (the first window, ``<|sot|>``), all of them, on the host."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import (
        decoder_forward, encode, precompute_cross_kv)
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch

    dims, st = asr.dims, asr.tokens
    n = 2 * dims.n_audio_ctx * HOP_LENGTH
    win = np.zeros((1, n), np.float32)
    win[0, : min(len(wav), n)] = wav[:n]
    with torch.inference_mode():
        mel = log_mel_batch(torch.from_numpy(win).to(asr.device),
                            n_mels=dims.n_mels)
        enc = encode(asr._params, dims, mel, dtype=asr.dtype)
        ckv = precompute_cross_kv(asr._params, dims, enc, asr.dtype)
        sot = torch.full((1, 1), st.sot, device=asr.device)
        logits, _ = decoder_forward(asr._params, dims, sot, ckv,
                                    dtype=asr.dtype)
        probs = torch.softmax(
            logits[0, 0, st.lang_base: st.translate].float(), dim=-1)
    return probs.cpu()


def phase_fallback(torch, K) -> dict:
    """(a) the PRNG on the card; (b) the ``test`` preset's ladder on the
    card against the CPU; (c) large-v3 in the production profile with the
    port's defaults (ladder on, language detected) on 4 windows: the
    detected language against the plain path, the rungs and their
    launches; (d) ``condition_on_previous_text`` on 3 large-v3 windows.
    Returns launches by path."""
    import numpy as np

    from audio_rag_tpu_torch import native
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_LANGUAGES, WHISPER_PRESETS, init_whisper)

    if not native.native_available():
        fail("fallback: the native audio runtime did not load")
    print(f"fallback native library {native.lib_path()}", flush=True)
    check_prng(torch)

    # (b) seeded test weights made once on the host, copied to the card
    params = init_whisper(WHISPER_PRESETS["test"], seed=0)
    audio = (0.05 * np.random.default_rng(1).standard_normal(
        int(7.0 * 16_000))).astype(np.float32)
    K.reset_launches()
    card = run_test_ladder("cuda", params, audio)
    torch.cuda.synchronize()
    launches_b = launch_counts(K)
    cpu = run_test_ladder("cpu", params, audio)
    print("fallback[test] card", json.dumps(card), flush=True)
    print("fallback[test] cpu ", json.dumps(cpu), flush=True)
    print("fallback[test] launches", json.dumps(launches_b), flush=True)
    if card != cpu or not card["decodes"] or max(card["temps"]) == 0.0:
        fail("fallback[test]: the card's ladder differs from the CPU's, or "
             "no window climbed it")
    check_launches("fallback[test]", launches_b, {FLASH})

    # (c) large-v3, production profile, the port's defaults
    tag = f"fallback[{FALLBACK_PROFILE}]"
    cfg = large_v3_config("cuda", FALLBACK_PROFILE, 16, language=None,
                          temperature_fallback=True).asr
    asr = WhisperASR(cfg, "cuda")
    asr.load()
    wav = long_speech(4 * 30.0, seed=8)
    lang = asr.detect_language(wav, 16_000)
    with plain_kernels(K):
        plain = language_probs(torch, asr, wav)
    best = int(plain.argmax())
    print(f"{tag} detected language {WHISPER_LANGUAGES[lang[0]]} "
          f"(offset {lang[0]}, p {lang[1]:.6f}); plain path: "
          f"{WHISPER_LANGUAGES[best]} (offset {best}, p "
          f"{float(plain[best]):.6f}), p of the card's choice "
          f"{float(plain[lang[0]]):.6f}", flush=True)
    # random weights spread p over 100 languages: hold the card's choice
    # and its p to the plain path's within 5 % of the plain maximum
    tol = 0.05 * float(plain[best])
    if float(plain[lang[0]]) < float(plain[best]) - tol or \
            abs(lang[1] - float(plain[lang[0]])) > tol:
        fail(f"{tag}: detected language disagrees with the plain path")
    rungs: list = []
    spy_rungs(torch, K, asr, rungs)
    K.reset_launches()
    t0 = time.perf_counter()
    asr.transcribe(wav, 16_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_c = launch_counts(K)
    tm = asr.timings
    out = {"windows": tm["windows"], "window_temps": asr.window_temps,
           "transcribe_s": wall, "detect_s": tm["detect_s"],
           "encode_ms": tm["encode_s"] * 1e3,
           "decode_ms": tm["decode_s"] * 1e3,
           "fallback_ms": tm["fallback_s"] * 1e3, "rungs": rungs,
           "launches": launches_c}
    print(tag, json.dumps(out), flush=True)
    temps = [r["temperature"] for r in rungs]
    if temps != [0.0] + list(cfg.fallback_temperatures) or \
            tm["windows"] != 4:
        fail(f"{tag}: expected 4 windows and the rungs "
             f"{[0.0] + list(cfg.fallback_temperatures)}, got {temps}")
    for r in rungs:  # each rung runs the profile's decode kernels
        if not {Q8W, CROSS8} <= set(r["launches"]):
            fail(f"{tag}: rung {r['temperature']} launched {r['launches']}")
    # encoder flash calls: the language detection's and the batch's
    check_launches(tag, launches_c, PROFILES[FALLBACK_PROFILE][1],
                   2 * asr.dims.n_audio_layer)

    # (d) conditioned on previous text, 3 windows
    tag_d = f"fallback[{FALLBACK_PROFILE},conditioned]"
    asr.config.condition_on_previous_text = True
    rungs.clear()
    K.reset_launches()
    t0 = time.perf_counter()
    asr.transcribe(wav[: 3 * 30 * 16_000], 16_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_d = launch_counts(K)
    decode_ms: list[float] = []  # each window's rungs, from its 0.0 rung
    for r in rungs:
        if r["temperature"] == 0.0:
            decode_ms.append(0.0)
        decode_ms[-1] += r["ms"]
    out = {"windows": asr.timings["windows"],
           "window_temps": asr.window_temps, "transcribe_s": wall,
           "ms_per_window": wall * 1e3 / max(asr.timings["windows"], 1),
           "decode_ms_per_window": decode_ms,
           "prompt_lens": [r["prompt_len"] for r in rungs
                           if r["temperature"] == 0.0],
           "rungs": rungs, "launches": launches_d}
    print(tag_d, json.dumps(out), flush=True)
    if asr.timings["windows"] != 3 or max(out["prompt_lens"]) <= 16:
        fail(f"{tag_d}: expected 3 windows and a prompt longer than 16 "
             f"tokens, got {out['prompt_lens']}")
    check_launches(tag_d, launches_d, PROFILES[FALLBACK_PROFILE][1],
                   4 * asr.dims.n_audio_layer)
    del asr
    return {"fallback[test]": launches_b, tag: launches_c,
            tag_d: launches_d}


# -- phase 10: the query half ------------------------------------------------------

QUERY_BATCH, QUERY_BATCHES, QUERY_SINGLE = 128, 6, 10
QUERY_CORPUS = 10_000  # bench.py's corpus


def bf16_ulp(score: float) -> float:
    a = abs(float(score))
    return 2.0 ** (math.floor(math.log2(a)) - 7) if a else 0.0


def score_tol(score: float) -> float:
    """The tests' tolerance of a score: the ranking goldens' 8e-3, or two
    bf16 ulps of the score where that is more."""
    return max(8e-3, 2 * bf16_ulp(score))


def same_ranking(got: list, ref: list) -> bool:
    """(id, score) lists: the same ids, in the same order but for
    near-ties, and every score within :func:`score_tol`."""
    want = dict(ref)
    if len(got) != len(ref) or {i for i, _ in got} != set(want):
        return False
    if any(abs(s - want[i]) > score_tol(want[i]) for i, s in got):
        return False
    ranked = [want[i] for i, _ in got]
    return all(a >= b - score_tol(a) for a, b in zip(ranked, ranked[1:]))


SPINE_WORDS = ("model data signal window audio chunk query vector fusion rank "
               "weight step update noise speech meeting lecture gradient "
               "spectrogram attention").split()


def spine_corpus():
    """The spine's three turns and 21 distractor chunks (seed 11), with a
    "kind" to filter on."""
    import numpy as np

    from audio_rag_tpu_torch.core.types import AudioChunk

    rng = np.random.default_rng(11)
    texts = list(SPINE_TURNS) + [" ".join(rng.choice(SPINE_WORDS, 8).tolist())
                                 for _ in range(21)]
    return [AudioChunk(t, 6.0 * i, 6.0 * i + 5.0,
                       speaker=f"SPEAKER_{i % 2:02d}", chunk_id=f"s{i}",
                       metadata={"kind": "turn" if i < 3 else "other"})
            for i, t in enumerate(texts)]


def run_query_spine(device: str) -> dict:
    """(a) The eval-small embedder and reranker on the spine corpus
    through ``AudioRAG.query``: every search type with rerank on and off,
    and a filtered query. Returns (id, score) lists by case."""
    from audio_rag_tpu_torch.config import (
        AudioRAGConfig, EmbeddingConfig, RerankingConfig, RetrievalConfig)
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(model="eval-small"), device=device))
    chunks = spine_corpus()
    rag.store.add(chunks, rag.embedder.embed([c.text for c in chunks]),
                  "query")
    out = {}
    for text, _ in SPINE_QUERIES:
        for st in ("dense", "sparse", "hybrid"):
            for rerank in (True, False):
                res = rag.query(text, search_type=st, rerank=rerank,
                                collection="query")
                out[f"{text}|{st}|rerank={rerank}"] = [
                    (r.chunk_id, r.score) for r in res.results]
        res = rag.query(text, collection="query",
                        metadata_filter={"kind": "turn"})
        out[f"{text}|filtered"] = [(r.chunk_id, r.score)
                                   for r in res.results]
    return out


def bench_corpus(rag, rng):
    """``bench.py``'s corpus recipe (its own copy): 64 chunks of 40 words
    embedded by the model, then random dense rows and 60 random sparse
    terms up to 10,000 chunks; "part" (i mod 4) to filter on."""
    import numpy as np

    from audio_rag_tpu_torch.core.types import (
        AudioChunk, EmbeddingResult, SparseVector)

    words = [f"term{i}" for i in range(2000)]
    texts = [" ".join(rng.choice(words, size=40).tolist()) for _ in range(64)]
    real = rag.embedder.embed(texts)
    dim = real[0].dim
    chunks, embs = [], []
    for i in range(QUERY_CORPUS):
        if i < len(real):
            emb, text = real[i], texts[i]
        else:
            dense = rng.standard_normal(dim).astype(np.float32)
            ids = np.unique(rng.integers(4, 30_000, size=60)).astype(np.int32)
            emb = EmbeddingResult(dense=dense, sparse=SparseVector(
                ids, rng.random(ids.size).astype(np.float32)))
            text = " ".join(rng.choice(words, size=40).tolist())
        chunks.append(AudioChunk(text=text, start=float(i),
                                 end=float(i + 30),
                                 speaker=f"SPEAKER_{i % 4:02d}",
                                 chunk_id=f"c{i}", metadata={"part": i % 4}))
        embs.append(emb)
    return chunks, embs


def make_queries(n: int, seed: int) -> list[str]:
    """``bench.py``'s queries."""
    import numpy as np

    r = np.random.default_rng(seed)
    return [f"what is term{r.integers(2000)} and how does "
            f"term{r.integers(2000)} relate to term{r.integers(2000)}"
            for _ in range(n)]


def time_query(torch, rag, stores: dict) -> dict:
    """Through ``AudioRAG``, on each store in turns (the order alternating
    by round) after one warm batch and query each: ``QUERY_BATCHES``
    batches of 128, 3 batches without the reranker, ``QUERY_SINGLE``
    single queries, and on the first store the same single queries with a
    metadata filter (part 2). Returns the timings by store."""
    import numpy as np

    from audio_rag_tpu_torch.engine.query_engine import QueryEngine

    engines = {name: QueryEngine(rag.embedder, st)
               for name, st in stores.items()}

    def use(name):
        rag.store, rag._engine = stores[name], engines[name]

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def rounds(n):
        names = list(stores)
        return [(i, names if i % 2 == 0 else names[::-1]) for i in range(n)]

    for name in stores:
        use(name)
        rag.query_batch(make_queries(QUERY_BATCH, 99))
        rag.query(make_queries(1, 98)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {name: {"batch_ms": [], "no_rerank_batch_ms": [], "single_ms": []}
           for name in stores}
    first = next(iter(stores))
    out[first]["filtered_single_ms"] = []
    for b, names in rounds(QUERY_BATCHES):
        qs = make_queries(QUERY_BATCH, b)
        for name in names:
            use(name)
            rows = []
            out[name]["batch_ms"].append(timed(
                lambda: rows.extend(rag.query_batch(qs))))
            if len(rows) != QUERY_BATCH or any(len(r.results) != 5
                                               for r in rows):
                fail(f"query: a batch returned "
                     f"{[len(r.results) for r in rows]}")
            if not all(math.isfinite(x.score) for r in rows
                       for x in r.results):
                fail("query: non-finite scores")
    for b, names in rounds(3):  # embed + search alone
        qs = make_queries(QUERY_BATCH, b)
        for name in names:
            use(name)
            out[name]["no_rerank_batch_ms"].append(timed(
                lambda: rag.query_batch(qs, rerank=False)))
    filtered: list = []
    for i, names in rounds(QUERY_SINGLE):
        q = make_queries(QUERY_SINGLE, 77)[i]
        for name in names:
            use(name)
            out[name]["single_ms"].append(timed(lambda: rag.query(q)))
        use(first)
        out[first]["filtered_single_ms"].append(timed(
            lambda: filtered.append(rag.query(
                q, metadata_filter={"part": 2}))))
    hits = [h for res in filtered for h in res.results]
    if len(hits) != 5 * QUERY_SINGLE or any(int(h.chunk_id[1:]) % 4 != 2
                                             for h in hits):
        fail("query[full,filtered]: hits outside the filter")
    use(first)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for d in out.values():
        ms = float(np.median(d["batch_ms"]))
        d.update({f"{k}_median": float(np.median(v))
                  for k, v in list(d.items())},
                 batch=QUERY_BATCH, qps=QUERY_BATCH / ms * 1e3,
                 peak_mem_gb_all_stores=peak)
    return out


def phase_query(torch, K) -> dict:
    """(a) the trained spine's query half on the card against the port's
    CPU; (b) BGE-M3 (XLM-R large) + bge-reranker-base (XLM-R base),
    seeded, on bench.py's 10,000-chunk corpus: hybrid, rerank 20 → 5, at
    query batch 128 and single stream, then an int8 corpus and a filtered
    query, the fused scores against ``score_pairs_multi``; (c) no kernel
    launches. Returns the launches."""
    import numpy as np

    from audio_rag_tpu_torch.config import (
        AudioRAGConfig, RetrievalConfig)
    from audio_rag_tpu_torch.pipeline import AudioRAG
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    K.reset_launches()
    # (a)
    t0 = time.perf_counter()
    card = run_query_spine("cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = run_query_spine("cpu")
    bad = [case for case in card if not same_ranking(card[case], cpu[case])]
    for case in card:
        print(f"query[spine] {case} card {json.dumps(card[case])}"
              + ("" if case not in bad else
                 f" cpu {json.dumps(cpu[case])} DIFFERS"))
    print(f"query[spine] {len(card)} queries on the card in {card_s:.2f} s, "
          f"{len(card) - len(bad)} agree with the CPU", flush=True)
    if bad:
        fail(f"query[spine]: the card's rankings differ from the CPU's in "
             f"{bad}")
    # the search finds the spoken turn (the tiny reranker, trained on
    # another corpus, ranks these random-word distractors above it, on the
    # CPU as on the card)
    top = card[f"{SPINE_QUERIES[0][0]}|hybrid|rerank=False"]
    if not top or top[0][0] != "s0":
        fail(f"query[spine]: the top hit is not the spoken turn: {top}")

    # (b) full width, seeded weights
    rag = AudioRAG(AudioRAGConfig(
        retrieval=RetrievalConfig(capacity_step=4096), device="cuda"))
    t0 = time.perf_counter()
    rag.embedder, rag.reranker  # load both models
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunks, embs = bench_corpus(rag, np.random.default_rng(0))
    rag.store.add(chunks, embs)
    corpus_s = time.perf_counter() - t0
    print(f"query[full] models {rag.embedder.dims} / {rag.reranker.dims}, "
          f"loaded in {load_s:.1f} s; corpus of {rag.count()} chunks in "
          f"{corpus_s:.1f} s", flush=True)
    # an int8 copy of the corpus (quantize_dense), timed in turns with it
    qstore = VectorStore(RetrievalConfig(capacity_step=4096,
                                         quantize_dense=True), "cuda")
    qstore.add(chunks, embs)
    timings = time_query(torch, rag, {"f32": rag.store, "int8": qstore})
    out = timings["f32"]
    qs = make_queries(QUERY_BATCH, 0)
    traced = trace_steps(torch, lambda: rag.query_batch(qs), steps=1,
                         top=12)
    out["traced_batch"] = {
        "host_ms": traced["decode_ms_per_step"],
        "traced_host_ms": traced["traced_host_ms_per_step"],
        "device_busy_ms": traced["device_busy_ms_per_step"],
        "device_busy_share": traced["device_busy_share_traced"],
        "kernel_launches": traced["kernel_launches_per_step"],
        "top_kernels_ms": traced["top_kernels_ms_per_step"]}
    print("query[full] hybrid rerank 20→5", json.dumps(out), flush=True)

    # the fused path's scores against score_pairs_multi on the same
    # pairs: in f32 (the reranker's bf16 weights widened), where only the
    # order of f32 sums differs, then in bf16 as served, where the two
    # paths' other GEMM shapes round a logit by a few ulps
    for dtype in (torch.float32, torch.bfloat16):
        rag.reranker.dtype = dtype
        rows = rag.query_batch(qs[:8])
        pairs = [(q, r) for q, row in zip(qs[:8], rows)
                 for r in row.results]
        ref = rag.reranker.score_pairs_multi([q for q, _ in pairs],
                                             [r.text for _, r in pairs])
        errs = [abs(r.score - float(s)) for (_, r), s in zip(pairs, ref)]
        ulps = [e / max(bf16_ulp(s), 2.0 ** -133)
                for e, s in zip(errs, ref)]
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"query[full] fused scores vs score_pairs_multi ({tag}): "
              f"{len(pairs)} pairs, max |err| {max(errs):.7f}, max "
              f"{max(ulps):.2f} bf16 ulps, mean |err| "
              f"{sum(errs) / len(errs):.7f}, scores "
              f"{min(map(float, ref)):.4f}..{max(map(float, ref)):.4f}",
              flush=True)
        if dtype == torch.float32 and any(
                e > 1e-4 * max(1.0, abs(float(s)))
                for e, s in zip(errs, ref)):
            fail("query[full]: the fused reranker scores disagree with "
                 "score_pairs_multi in f32 (tolerance 1e-4 relative)")
        if dtype == torch.bfloat16 and any(u > 8 for u in ulps):
            fail("query[full]: the fused bf16 reranker scores are more "
                 "than 8 bf16 ulps from score_pairs_multi's")

    # the int8 corpus's top 5 against the f32 corpus's
    fstore = rag.store
    rag.store, rag._engine = qstore, None
    rows8 = rag.query_batch(qs[:8])
    rag.store, rag._engine = fstore, None
    overlap = np.mean([len({r.chunk_id for r in a.results}
                           & {r.chunk_id for r in b.results}) / 5
                       for a, b in zip(rows, rows8)])
    timings["int8"]["top5_overlap_with_f32_corpus"] = float(overlap)
    print("query[full,int8 corpus]", json.dumps(timings["int8"]),
          flush=True)
    torch.cuda.synchronize()

    # (c) nothing on the query half runs a kernel of the port
    launches = launch_counts(K)
    print("query launches", json.dumps(launches), flush=True)
    if any(launches.values()):
        fail(f"query: kernels launched on the query half: {launches}")
    del rag, qstore, fstore
    return {"query": launches}


# -- phase 11: answers --------------------------------------------------------------

ANSWER_QUESTIONS = ["gradient descent loss", "spectrogram harmonic",
                    "what do attention layers mix",
                    "what does the lecture say about the loss function"]
ANSWER_TOKENS = 64  # new tokens a wave (seeded weights seldom emit EOS)
ANSWER_WAVE = 16  # the scheduler's full wave (scheduler_max_batch)
SERVED_WORDS = 256  # a served chunk: the chunker's max_tokens
SERVED_EXCERPTS = 5  # a served prompt's excerpts: retrieval's top_k
SERVED_BUCKET = 2048  # the prompt bucket of such a prompt
ANSWER_LEFT_MAX = 128 << 20  # bytes the phase may leave allocated


def served_corpus():
    """The query spine's chunks, each grown to the chunker's 256 tokens
    with words of the spine's vocabulary (seed 12), so that a prompt of
    five of them fills the prompt bucket the shipped config serves."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(12)
    return [dataclasses.replace(c, text=" ".join(
        [c.text, *rng.choice(SPINE_WORDS, SERVED_WORDS
                             - len(c.text.split())).tolist()]))
        for c in spine_corpus()]


def answer_prompts(n: int, served: bool = False) -> list[str]:
    """``n`` RAG prompts over the query spine's corpus: a question and
    three of its short excerpts each, the spoken turns first; ``served``:
    five excerpts of 256 tokens, as the shipped config sends them."""
    from audio_rag_tpu_torch.core.types import RetrievalResult
    from audio_rag_tpu_torch.generation.prompts import build_rag_prompt

    chunks = served_corpus() if served else spine_corpus()
    k = SERVED_EXCERPTS if served else 3
    out = []
    for i in range(n):
        picked = [chunks[(i + 5 * j) % len(chunks)] for j in range(k)]
        out.append(build_rag_prompt(
            ANSWER_QUESTIONS[i % len(ANSWER_QUESTIONS)],
            [RetrievalResult(c.text, 0.8, c.start, c.end, speaker=c.speaker)
             for c in picked]))
    return out


def llm_config(**fields):
    """The shipped profile's generator settings, read from
    configs/production.yaml through the port's loader (llama-3.2-3b,
    decoder_int8, speculative_k 8 — single-row greedy waves only, so never
    at the config's temperature 0.7), with ``ANSWER_TOKENS``."""
    import dataclasses

    cfg = shipped("production").generation
    if (cfg.model, cfg.decoder_int8, cfg.speculative_k) != (LLM, True, 8):
        fail(f"configs/production.yaml's generator is not {LLM} with "
             f"decoder_int8 and speculative_k 8: {cfg}")
    return dataclasses.replace(cfg, **{"max_tokens": ANSWER_TOKENS,
                                       **fields})


def run_trained_answers(K, switches: dict) -> dict:
    """(a) The trained eval-small generator on the card, greedy: four RAG
    prompts with the kernels, then under ``plain_kernels``. Returns the
    token ids, counts, steps and the kernels run's launches."""
    from audio_rag_tpu_torch.config import GenerationConfig
    from audio_rag_tpu_torch.generation.llm import LLMGenerator
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    gen = LLMGenerator(GenerationConfig(
        model="eval-small", temperature=0.0, max_tokens=ANSWER_TOKENS,
        use_scheduler=False, **switches), device="cuda")
    gen.load()
    prompts = answer_prompts(4)
    K.reset_launches()
    texts = gen.generate_batch(prompts, system=SYSTEM_PROMPT)
    out = {"texts": texts, "ids": gen.last_token_ids,
           "counts": gen.last_token_counts, "steps": gen.last_stats["steps"],
           "launches": launch_counts(K)}
    with plain_kernels(K):
        gen.generate_batch(prompts, system=SYSTEM_PROMPT)
    out["plain_ids"] = gen.last_token_ids
    return out


def wave_stats(inner, wall_s: float) -> dict:
    st = inner.last_stats
    rows = len(inner.last_token_counts)
    return {"rows": rows, "prompt_bucket": st["prompt_bucket"],
            "steps": st["steps"], "prefill_ms": st["prefill_s"] * 1e3,
            "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["steps"], 1),
            "decode_tokens_per_s": rows * st["steps"] / st["decode_s"],
            "tokens_per_s": sum(inner.last_token_counts) / wall_s,
            "wall_ms": wall_s * 1e3}


def check_llm_launches(tag: str, launches: dict, steps: int,
                       head_bits: int, n_layers: int = 28) -> None:
    """The decode loop's linears run on the kernels: four int8 block calls
    a layer and step (112 at 3b) and the head's, int8 or int4; the prefill
    runs none."""
    want = {Q8W: 4 * n_layers * steps + (steps if head_bits == 8 else 0),
            Q4W: steps if head_bits == 4 else 0}
    got = {name: launches.get(name, 0) for name in want}
    if got != want or any(n for name, n in launches.items()
                          if name not in want and name != WGMMA):
        fail(f"{tag}: launches {launches}, expected {want} for {steps} "
             "decode steps")


def first_step_logits(torch, inner, prompts, device: str = "cuda",
                      token=None) -> object:
    """Prefill ``prompts`` as the generator batches them, then one decode
    step with its quantized weights, fed the prefill's best token (or
    ``token``, one a row): the step's f32 logits."""
    import numpy as np

    from audio_rag_tpu_torch.models.llm import llm_decode_step, llm_forward

    seqs = [inner._tok.encode(p) for p in prompts]
    P = 1 << (max(map(len, seqs)) - 1).bit_length()
    B, dims = len(seqs), inner.dims
    toks = np.full((B, P), inner._tok.eos_id, np.int64)
    mask = np.zeros((B, P), bool)
    for i, s in enumerate(seqs):
        toks[i, P - len(s):], mask[i, P - len(s):] = s, True
    toks = torch.from_numpy(toks).to(device)
    mask = torch.from_numpy(mask).to(device)
    C, hd = P + 1, dims.d_model // dims.n_heads
    cache = [torch.zeros((dims.n_layers, B, dims.n_kv_heads, C, hd),
                         dtype=inner.dtype, device=device) for _ in range(2)]
    valid = torch.cat([mask, torch.ones((B, 1), dtype=torch.bool,
                                        device=device)], 1)
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    logits, _ = llm_forward(inner._params, dims, toks, 0, tuple(cache),
                            inner.dtype, kv_valid=valid, pos_ids=pos,
                            last_pos=torch.full((B,), P - 1, device=device))
    tok = (logits[:, -1].argmax(-1) if token is None
           else torch.as_tensor(token, device=device))
    step, *_ = llm_decode_step(
        inner._params, dims, tok, P, *cache, kv_valid=valid,
        dtype=inner.dtype, rope_pos=mask.long().sum(1),
        q8=inner._params_q8)
    return step


def profile_llm_step(torch, inner, B: int, steps: int = 8) -> dict:
    """A traced window of wave decode steps at ``B`` rows after a prompt
    of the served bucket (:func:`trace_steps`)."""
    from audio_rag_tpu_torch.models.llm import llm_decode_step

    dims = inner.dims
    P = SERVED_BUCKET
    C, hd = P + 2 * steps + 4, dims.d_model // dims.n_heads
    cache = [torch.zeros((dims.n_layers, B, dims.n_kv_heads, C, hd),
                         dtype=inner.dtype, device="cuda") for _ in range(2)]
    tok = torch.full((B,), 7, dtype=torch.long, device="cuda")
    pos = P

    def step():
        nonlocal pos
        llm_decode_step(inner._params, dims, tok, pos, *cache,
                        dtype=inner.dtype, q8=inner._params_q8)
        pos += 1

    return trace_steps(torch, step, steps)


SERVE_SLOTS, SERVE_SEGMENT = 4, 8  # (a)'s batcher
SHORT_TOKENS = 8  # the request that joins a running batch
TIE_ULPS = 2  # bf16 ulps of each logit within which two choices may swap


def trained_generator(device: str = "cuda", **fields):
    """The trained eval-small generator on ``device``, unscheduled,
    greedy, int8 decode weights."""
    from audio_rag_tpu_torch.config import GenerationConfig
    from audio_rag_tpu_torch.generation.llm import LLMGenerator

    gen = LLMGenerator(GenerationConfig(**{
        "model": "eval-small", "temperature": 0.0, "decoder_int8": True,
        "max_tokens": ANSWER_TOKENS, "use_scheduler": False, **fields}),
        device=device)
    gen.load()
    return gen


def run_trained_speculative(K, gen) -> dict:
    """(a) Greedy single streams with ``speculative_k`` 8 on four RAG
    prompts: the tokens of the wave (``speculative_k`` 0) and of the plain
    path, the verify count, tokens per verify and ``matmul_q8w`` launches
    per verify."""
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    out = {"ids": [], "wave_ids": [], "plain_ids": [], "stats": [],
           "q8_launches": [], "q8_per_verify": []}
    for p in answer_prompts(4):
        gen.config.speculative_k = 8
        K.reset_launches()
        gen.generate(p, system=SYSTEM_PROMPT)
        st = gen.last_spec_stats
        out["ids"].append(gen.last_token_ids[0])
        out["stats"].append(st)
        out["q8_launches"].append(K.LAUNCHES[Q8W])
        out["q8_per_verify"].append(K.LAUNCHES[Q8W] / st["block_verifies"])
        with plain_kernels(K):
            gen.generate(p, system=SYSTEM_PROMPT)
        out["plain_ids"].append(gen.last_token_ids[0])
        gen.config.speculative_k = 0
        gen.generate(p, system=SYSTEM_PROMPT)
        out["wave_ids"].append(gen.last_token_ids[0])
    return out


def serve_continuous(batcher, prompts: list[str], late: str,
                     late_tokens: int, **kw) -> dict:
    """``prompts`` into ``batcher`` at once (their text streamed), then
    ``late`` once the first segment has been read back: each request's
    text and raw tokens, the streamed text, the late request's latency
    and the wall time."""
    tokens: dict[str, list[int]] = {}
    orig = batcher._finish

    def record(slot):
        tokens[slot.request.prompt] = list(slot.tokens)
        orig(slot)

    batcher._finish = record
    streamed = {p: [] for p in prompts}
    seg0 = batcher.segments_run
    t0 = time.perf_counter()
    futures = [batcher.submit(p, on_delta=streamed[p].append, **kw)
               for p in prompts]
    while batcher.segments_run == seg0 and not all(f.done()
                                                  for f in futures):
        time.sleep(0.001)
    t_late = time.perf_counter()
    late_f = batcher.submit(late, max_tokens=late_tokens,
                            **{k: v for k, v in kw.items()
                               if k != "max_tokens"})
    late_text = late_f.result()
    late_ms = (time.perf_counter() - t_late) * 1e3
    texts = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    del batcher._finish
    return {"texts": texts, "late_text": late_text, "late_ms": late_ms,
            "wall_s": wall, "tokens": tokens,
            "streamed": ["".join(streamed[p]) for p in prompts]}


def eos_trim(ids: list[int], eos: int, n: int) -> list[int]:
    return (ids[:ids.index(eos)] if eos in ids else ids)[:n]


def run_trained_batcher(K, gen) -> dict:
    """(a) The continuous batcher (4 slots, segments of 8) on four RAG
    prompts, a fifth joining after the first segment: each request's
    greedy tokens against its single-row wave's, the streamed text against
    the answer."""
    from audio_rag_tpu_torch.engine.continuous import ContinuousBatcher
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    prompts = answer_prompts(5)
    b = ContinuousBatcher(gen, n_slots=SERVE_SLOTS,
                          segment_tokens=SERVE_SEGMENT)
    try:
        K.reset_launches()
        out = serve_continuous(b, prompts[:4], prompts[4], ANSWER_TOKENS,
                               system=SYSTEM_PROMPT)
        out["launches"] = launch_counts(K)
        out["segments"] = b.segments_run
    finally:
        b.stop()
    eos = gen._tok.eos_id
    out["ids"] = [eos_trim(out["tokens"][p], eos, ANSWER_TOKENS)
                  for p in prompts]
    out["wave_ids"] = []
    for p in prompts:
        gen.generate(p, system=SYSTEM_PROMPT)
        out["wave_ids"].append(gen.last_token_ids[0])
    return out


def wave_scores(torch, gen, texts: list[str], ids: list[list[int]],
                row: int, temp: float, max_new: int | None = None):
    """``gen``'s sampled scores (logits·(1/T) plus the step's Gumbel noise,
    ``llm_generate``'s key chain) and f32 logits of ``row`` at each of its
    new tokens, its batch ``texts`` rebuilt as ``generate_batch`` builds
    it and teacher-forced on ``ids`` (one list a row). ``max_new``: the
    cache is the one ``llm_generate`` allocates for that many new tokens
    (the prefill attends over all of it, so its length is in the bits)."""
    import numpy as np

    from audio_rag_tpu_torch.models.llm import llm_decode_step, llm_forward
    from audio_rag_tpu_torch.ops import random as jrandom

    tok, dims, dev = gen._tok, gen.dims, gen.device
    cap = min(gen.config.max_prompt_tokens, dims.max_len - 8)
    seqs = [tok.encode(t)[-cap:] for t in texts]
    P = min(1 << (max(map(len, seqs)) - 1).bit_length(), cap)
    B = 1 << (len(seqs) - 1).bit_length()
    n = max(map(len, ids)) + 1  # room for a parting at a row's end
    rows = [(s, (i + [tok.eos_id] * n)[:n]) for s, i in zip(seqs, ids)]
    rows += [rows[0]] * (B - len(rows))
    batch = np.full((B, P + n), tok.eos_id, np.int64)
    mask = np.zeros((B, P), bool)
    for i, (s, new) in enumerate(rows):
        s = s[-P:]
        batch[i, P - len(s):P], batch[i, P:] = s, new
        mask[i, P - len(s):] = True
    toks = torch.from_numpy(batch).to(dev)
    m = torch.from_numpy(mask).to(dev)
    hd = dims.d_model // dims.n_heads
    C = P + n + 1
    if max_new is not None:  # generate_batch's quota, llm_generate's cache
        C = min(dims.max_len, P + min(max_new, dims.max_len - P - 1))
    cache = [torch.zeros((dims.n_layers, B, dims.n_kv_heads, C, hd),
                         dtype=gen.dtype, device=dev) for _ in range(2)]
    valid = torch.cat([m, torch.ones((B, C - P), dtype=torch.bool,
                                     device=dev)], 1)
    pos = torch.clamp(torch.cumsum(m.long(), 1) - 1, min=0)
    logits, _ = llm_forward(gen._params, dims, toks[:, :P], 0, tuple(cache),
                            gen.dtype, kv_valid=valid, pos_ids=pos,
                            last_pos=torch.full((B,), P - 1, device=dev))
    outs = [logits[:, 0]]
    offset = P - m.long().sum(1)
    for i in range(P, P + n - 1):
        lg, *cache = llm_decode_step(
            gen._params, dims, toks[:, i], i, *cache, kv_valid=valid,
            dtype=gen.dtype, rope_pos=i - offset, q8=gen._params_q8)
        outs.append(lg)
    inv = float(np.float32(1) / np.float32(temp))
    rng = jrandom.PRNGKey(abs(hash(tuple(texts))) % (2 ** 31))
    scores = []
    for lg in outs:
        key, rng = jrandom.split(rng)
        scores.append((lg * inv + jrandom.gumbel(key, tuple(lg.shape),
                                                 dev))[row].cpu().numpy())
    return scores, [lg[row].cpu().numpy() for lg in outs]


def check_header_calls(torch, tag: str, gen, got: list, ref: list,
                       temp: float, max_new: int | None = None) -> int:
    """The card's generator batches (prompts, ids) against the CPU's: equal,
    or a row parts at a near-tie of the card's own scores — the two tokens
    its best two, within ``TIE_ULPS`` bf16 ulps of each logit over T (the
    logits themselves at T = 0, greedy) — after which the row is not
    compared. ``max_new``: the batches' new-token quota (``wave_scores``).
    Prints each parting; returns how many there were."""
    import numpy as np

    parted = 0
    if [p for p, _ in got] != [p for p, _ in ref]:
        fail(f"{tag}: the card's header prompts differ from the CPU's")
    for (texts, gids), (_, rids) in zip(got, ref):
        for row, (a, b) in enumerate(zip(gids, rids)):
            if a == b:
                continue
            eos = gen._tok.eos_id
            a2, b2 = a + [eos], b + [eos]
            step = next(i for i, (x, y) in enumerate(zip(a2, b2)) if x != y)
            sc, lg = wave_scores(torch, gen, texts, gids, row, temp or 1.0,
                                 max_new)
            if not temp:
                sc = lg
            top2 = np.argsort(-sc[step])[:2].tolist()
            mag = np.maximum(np.abs(lg[step][top2]), 2.0 ** -100)
            bound = TIE_ULPS * float(
                (2.0 ** (np.floor(np.log2(mag)) - 7)).sum()) / (temp or 1.0)
            gap = float(sc[step][top2[0]] - sc[step][top2[1]])
            print(f"{tag}: row {row} parts from the CPU's at token "
                  f"{step} ({a2[step]} against {b2[step]}): the card's "
                  f"best two {top2}, score gap {gap:.5f}, near-tie bound "
                  f"{bound:.5f}", flush=True)
            if set(top2) != {a2[step], b2[step]} or gap > bound:
                fail(f"{tag}: row {row} parts from the CPU's at "
                     f"token {step} without a near-tie")
            parted += 1
    return parted


def run_contextual(device: str, workdir: Path, K=None) -> dict:
    """The spine's three turns through ``AudioRAG.ingest`` with contextual
    headers from the trained generator (backend "llm", unscheduled, int8
    decode weights), then extractive ones: each collection's chunk texts,
    the generator's header batches (prompts, ids) and the stage times.
    With the kernels module ``K``, each header batch's launches are read
    from 0 just before it to just after it and held to its decode steps
    (the ingest's ASR runs ``matmul_q8w`` too, so the ingest's total
    cannot show that the headers did)."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.audio.io import write_wav
    from audio_rag_tpu_torch.config import ContextualConfig
    from audio_rag_tpu_torch.pipeline import AudioRAG

    cfg = spine_config(device, "int8")
    cfg.contextual = ContextualConfig(enabled=True)
    cfg.generation = llm_config(model="eval-small", use_scheduler=False,
                                speculative_k=0)
    rag = AudioRAG(cfg)
    wav = workdir / f"ctx_{device}.wav"
    write_wav(wav, speak(SPINE_TURNS, np.random.default_rng(7),
                         rag.asr.window_seconds), SR)
    gen = rag.generator
    calls = []
    orig = gen.generate_batch

    def spy(prompts, **kw):
        before = None if K is None else launch_counts(K)
        res = orig(prompts, **kw)
        calls.append((list(prompts), list(gen.last_token_ids)))
        if K is not None:
            after = launch_counts(K)
            check_llm_launches(
                f"answer[eval-small,contextual] header batch {len(calls)}",
                {k: after[k] - before[k] for k in after},
                gen.last_stats["steps"], 8, gen.dims.n_layers)
            header_q8[0] += after[Q8W] - before[Q8W]
        return res

    header_q8 = [0]
    gen.generate_batch = spy
    out = {"calls": calls, "gen": gen, "timings": {}, "header_q8": header_q8}
    for backend in ("llm", "extractive"):
        cfg.contextual.backend = backend
        res = rag.ingest(str(wav), collection=backend, diarize=False)
        out[backend] = [c["text"] for c in rag.store._coll(backend).payloads]
        out["timings"][backend] = res.stage_timings.get("contextualize")
    del gen.generate_batch
    return out


def check_trained_serving(torch, K, workdir: Path) -> dict:
    """(a) continued: the speculative single stream, the continuous batcher
    and contextual headers on the trained generator. Returns launches by
    path."""
    by_path = {}
    gen = trained_generator()
    L = gen.dims.n_layers
    spec = run_trained_speculative(K, gen)
    print(f"answer[eval-small,spec8] verifies "
          f"{[s['block_verifies'] for s in spec['stats']]} tokens per verify "
          f"{[s['tokens_per_verify'] for s in spec['stats']]} accept "
          f"{[s['accept_rate'] for s in spec['stats']]} matmul_q8w a verify "
          f"{spec['q8_per_verify']}", flush=True)
    if spec["ids"] != spec["wave_ids"] or spec["ids"] != spec["plain_ids"]:
        fail(f"answer[eval-small,spec8]: speculative tokens {spec['ids']}, "
             f"wave {spec['wave_ids']}, plain {spec['plain_ids']}")
    if any(n != 4 * L + 1 for n in spec["q8_per_verify"]):
        fail(f"answer[eval-small,spec8]: {spec['q8_per_verify']} "
             f"matmul_q8w launches a verify, not {4 * L + 1}")
    by_path["answer[eval-small,spec8]"] = {Q8W: sum(spec["q8_launches"])}

    cont = run_trained_batcher(K, gen)
    print(f"answer[eval-small,continuous] segments {cont['segments']} "
          f"late request ms {cont['late_ms']:.1f} wall s "
          f"{cont['wall_s']:.3f} tokens {[len(i) for i in cont['ids']]} "
          f"launches {json.dumps(cont['launches'])}", flush=True)
    if cont["ids"] != cont["wave_ids"]:
        fail(f"answer[eval-small,continuous]: the batcher's greedy tokens "
             f"{cont['ids']} differ from the waves' {cont['wave_ids']}")
    if [s.strip() for s in cont["streamed"]] != cont["texts"]:
        fail("answer[eval-small,continuous]: the streamed deltas do not "
             f"join to the answers: {cont['streamed']} {cont['texts']}")
    check_launches("answer[eval-small,continuous]", cont["launches"], {Q8W})
    by_path["answer[eval-small,continuous]"] = cont["launches"]
    gen.unload()
    free_card(torch)

    K.reset_launches()
    card = run_contextual("cuda", workdir, K)
    launches = launch_counts(K)
    cpu = run_contextual("cpu", workdir)
    print(f"answer[eval-small,contextual] llm {json.dumps(card['llm'])} "
          f"extractive {json.dumps(card['extractive'])} contextualize s "
          f"{json.dumps(card['timings'])} launches {json.dumps(launches)} "
          f"header matmul_q8w {card['header_q8'][0]} in "
          f"{len(card['calls'])} batches", flush=True)
    parted = check_header_calls(torch, "answer[eval-small,contextual]",
                                card["gen"], card["calls"], cpu["calls"],
                                0.3)
    if not parted and card["llm"] != cpu["llm"]:
        fail(f"answer[eval-small,contextual]: llm-headed chunks "
             f"{card['llm']} differ from the CPU's {cpu['llm']}")
    if card["extractive"] != cpu["extractive"]:
        fail(f"answer[eval-small,contextual]: extractive chunks differ: "
             f"{card['extractive']} against {cpu['extractive']}")
    if not any(t.startswith("[Context: ") for t in card["llm"]):
        fail("answer[eval-small,contextual]: no header was written")
    check_launches("answer[eval-small,contextual]", launches, {Q8W})
    if not card["header_q8"][0]:
        fail("answer[eval-small,contextual]: the header batches launched no "
             "matmul_q8w")
    by_path["answer[eval-small,contextual]"] = launches
    card["gen"].unload()
    del card, cpu
    free_card(torch)
    return by_path


def first_verify_logits(torch, inner, prompt: str, k: int = 8):
    """One prompt prefilled as the generator batches it, then its first
    decode step and, from the same cache, a verify block of ``k`` (the
    step's token and ``k`` - 1 drafts): (step logits, the block's first
    logits), both with the quantized weights."""
    from audio_rag_tpu_torch.models.llm import (
        llm_block_verify, llm_decode_step, llm_forward)
    from audio_rag_tpu_torch.models.whisper import ngram_draft

    dims, dev = inner.dims, inner.device
    s = inner._tok.encode(prompt)
    P = 1 << (len(s) - 1).bit_length()
    toks = torch.full((1, P), inner._tok.eos_id, device=dev)
    toks[0, P - len(s):] = torch.tensor(s, device=dev)
    mask = torch.zeros((1, P), dtype=torch.bool, device=dev)
    mask[0, P - len(s):] = True
    C, hd = P + k, dims.d_model // dims.n_heads
    cache = [torch.zeros((dims.n_layers, 1, dims.n_kv_heads, C, hd),
                         dtype=inner.dtype, device=dev) for _ in range(2)]
    valid = torch.cat([mask, torch.ones((1, k), dtype=torch.bool,
                                        device=dev)], 1)
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    logits, _ = llm_forward(inner._params, dims, toks, 0, tuple(cache),
                            inner.dtype, kv_valid=valid, pos_ids=pos,
                            last_pos=torch.full((1,), P - 1, device=dev))
    tok = logits[:, -1].argmax(-1)
    rope = mask.long().sum(1)
    step, *_ = llm_decode_step(
        inner._params, dims, tok, P, *(c.clone() for c in cache),
        kv_valid=valid, dtype=inner.dtype, rope_pos=rope,
        q8=inner._params_q8)
    seq = torch.cat([toks, tok[:, None]], 1)
    block = torch.cat([tok[:, None], ngram_draft(
        seq, torch.full((1,), P, device=dev), k - 1)], 1)
    verify, *_ = llm_block_verify(
        inner._params, dims, block, torch.full((1,), P, device=dev),
        *cache, kv_valid=valid, rope_pos=rope, dtype=inner.dtype,
        q8=inner._params_q8)
    return step, verify[:, 0]


def single_streams(torch, K, gen, prompt: str) -> dict:
    """A greedy single stream through the wave scheduler with
    ``speculative_k`` 8, then 0, twice in turns: decode tokens/s, verify
    count and tokens per verify, and each run's tokens."""
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    inner, out = gen.inner, {}
    for rnd in range(2):
        for k in (8, 0):
            inner.config.speculative_k = k
            K.reset_launches()
            gen.scheduler.submit(prompt, system=SYSTEM_PROMPT,
                                 temperature=0.0).result()
            st = inner.last_stats
            n = inner.last_token_counts[0]
            run = {"tokens": n, "prefill_ms": st["prefill_s"] * 1e3,
                   "decode_tokens_per_s": (n - 1) / st["decode_s"],
                   "loop_iterations": st["steps"],
                   "ids": inner.last_token_ids[0],
                   "q8_launches": K.LAUNCHES[Q8W]}
            if k:
                run.update(inner.last_spec_stats)
            out[f"spec{k}#{rnd}"] = run
    inner.config.speculative_k = 8
    return out


def held_to_step_path(torch, inner, prompt: str, ids: list) -> list:
    """A greedy stream ``ids`` of ``prompt`` teacher-forced through the
    step path (:func:`wave_scores`: the wave's decode step with the
    quantized weights, the prompt batched as ``generate_batch`` batches
    it, in a cache of the same length): each token, and the EOS after a
    stream that ended before its quota, must be the step path's best on
    the stream's own prefix, or trail the best by at most ``TIE_ULPS``
    bf16 ulps of each of the two logits. Returns the near-ties met,
    (index, token, best, gap, bound) each, and the tokens that are
    neither (the same tuple)."""
    import numpy as np

    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    quota = inner.config.max_tokens
    _, logits = wave_scores(torch, inner, [f"{SYSTEM_PROMPT}\n\n{prompt}"],
                            [list(ids)], 0, 1.0, max_new=quota)
    want = list(ids)
    if len(want) < quota:
        want.append(inner._tok.eos_id)
    ties, wrong = [], []
    for i, t in enumerate(want):
        lg = logits[i]
        best = int(lg.argmax())
        if t == best:
            continue
        mag = np.maximum(np.abs(lg[[best, t]]), 2.0 ** -100)
        bound = TIE_ULPS * float((2.0 ** (np.floor(np.log2(mag)) - 7)).sum())
        gap = float(lg[best] - lg[t])
        (ties if gap <= bound else wrong).append((i, t, best, gap, bound))
    return ties, wrong


def waves_with_late(gen, prompts: list[str]) -> dict:
    """``prompts`` but the last as one scheduler wave (the config's
    temperature) and the last, of ``SHORT_TOKENS``, submitted once the
    wave has started: aggregate tokens/s and the late request's
    latency."""
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    inner, sched = gen.inner, gen.scheduler
    counts = []
    orig = inner.generate_batch

    def spy(batch, **kw):
        res = orig(batch, **kw)
        counts.append(sum(inner.last_token_counts))
        return res

    inner.generate_batch = spy
    try:
        t0 = time.perf_counter()
        futures = [sched.submit(p, system=SYSTEM_PROMPT)
                   for p in prompts[:-1]]
        time.sleep(0.05)  # past the scheduler's 10 ms collection window
        t_late = time.perf_counter()
        late = sched.submit(prompts[-1], system=SYSTEM_PROMPT,
                            max_tokens=SHORT_TOKENS)
        late.result()
        now = time.perf_counter()
        for f in futures:
            f.result()
    finally:
        del inner.generate_batch
    if len(counts) != 2:
        fail(f"answer[{LLM},waves+late]: {len(counts)} waves, not 2")
    return {"requests": len(prompts), "waves": len(counts),
            "late_ms": (now - t_late) * 1e3,
            "tokens_per_s": sum(counts) / (now - t0), "wall_s": now - t0}


def continuous_with_late(torch, K, rag, prompts: list[str]) -> dict:
    """The shipped continuous settings (8 slots, segments of 16, idle
    segments of 48, 2,048 frames a slot) in place of ``rag``'s wave
    scheduler, around the same loaded generator: ``prompts`` at the
    config's temperature and a request of ``SHORT_TOKENS`` joining once
    the first segment is read back. Aggregate tokens/s, the late request's
    latency, segments and launches; the batcher stays in ``rag`` for
    ``unload_all``."""
    from audio_rag_tpu_torch.engine.scheduler import ScheduledGenerator
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT

    wave = rag.generator
    wave.scheduler.stop()
    if wave.scheduler._thread.is_alive():
        fail(f"answer[{LLM}]: the wave scheduler's thread outlived stop")
    cfg = rag.config.generation
    cfg.scheduler_mode = "continuous"
    gen = ScheduledGenerator(
        wave.inner, mode="continuous", n_slots=cfg.scheduler_slots,
        segment_tokens=cfg.scheduler_segment_tokens,
        context_tokens=cfg.scheduler_context_tokens,
        idle_segment_tokens=cfg.scheduler_idle_segment_tokens)
    rag._generator = gen
    b = gen.scheduler
    K.reset_launches()
    out = serve_continuous(b, prompts[:-1], prompts[-1], SHORT_TOKENS,
                           system=SYSTEM_PROMPT)
    res = {"requests": len(prompts), "late_ms": out["late_ms"],
           "tokens_per_s": b.tokens_generated / out["wall_s"],
           "tokens": b.tokens_generated,
           "segments": b.segments_run, "wall_s": out["wall_s"],
           "slots": b.n_slots, "segment": b.segment,
           "idle_segment": b.idle_segment, "context": b.ctx,
           "launches": launch_counts(K)}
    if [s.strip() for s in out["streamed"]] != out["texts"]:
        fail(f"answer[{LLM},continuous]: the streamed deltas do not join "
             "to the answers")
    return res


def phase_answer(torch, K) -> dict:
    """(a) The trained eval-small generator on the card, with the kernels
    and under ``plain_kernels``, int8 and int8 + int4 head: the same
    greedy tokens, every answer ending in EOS. (b) llama-3.2-3b, seeded,
    in the shipped profile (decoder_int8, temperature 0.7), on prompts of
    the served length (five 256-token excerpts, the 2048-token bucket)
    and 64 of the served 1024 new tokens:
    ``AudioRAG.query(generate_answer=True)`` on the query spine's chunks
    grown to 256 tokens; a wave of 16 concurrent prompts through the
    scheduler and a single stream (tokens/s, ms a decode step); the
    first step's logits against the plain path; a traced window of
    decode steps at 16 rows; the same wave with an int4 head. Every
    run's launches are checked against its decode steps and its prompt
    bucket against the served one. The serving engine
    (:func:`check_trained_serving` on the trained generator; at 3b
    :func:`single_streams`, :func:`first_verify_logits`,
    :func:`waves_with_late`, :func:`continuous_with_late`).
    ``AudioRAG.unload_all`` then has to stop the batcher and give the
    card's memory back. Returns launches by path."""
    from audio_rag_tpu_torch.config import (
        AudioRAGConfig, EmbeddingConfig, RerankingConfig, RetrievalConfig)
    from audio_rag_tpu_torch.engine.scheduler import ScheduledGenerator
    from audio_rag_tpu_torch.generation.llm import LLMGenerator
    from audio_rag_tpu_torch.generation.prompts import SYSTEM_PROMPT
    from audio_rag_tpu_torch.pipeline import AudioRAG

    free_card(torch)
    base = torch.cuda.memory_allocated()
    by_path = {}
    # (a)
    for tag, switches, head_bits in (
            ("int8", {"decoder_int8": True}, 8),
            ("int8+lm4", {"decoder_int8": True, "lm_head_int4": True}, 4)):
        out = run_trained_answers(K, switches)
        path = f"answer[eval-small,{tag}]"
        print(f"{path} answers {json.dumps(out['texts'])} tokens "
              f"{out['counts']} launches {json.dumps(out['launches'])}",
              flush=True)
        if out["ids"] != out["plain_ids"]:
            fail(f"{path}: the kernels' greedy tokens differ from the plain "
                 f"path's: {out['ids']} against {out['plain_ids']}")
        if any(n >= ANSWER_TOKENS for n in out["counts"]):
            fail(f"{path}: an answer did not end in EOS within "
                 f"{ANSWER_TOKENS} tokens: {out['counts']}")
        check_llm_launches(path, out["launches"], out["steps"], head_bits,
                           n_layers=4)
        by_path[path] = out["launches"]
    free_card(torch)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(check_trained_serving(torch, K, Path(tmp)))

    # (b) full width
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(model="eval-small"),
        generation=llm_config(), device="cuda"))
    chunks = served_corpus()
    rag.store.add(chunks, rag.embedder.embed([c.text for c in chunks]),
                  "answer")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = rag.generator
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not isinstance(gen, ScheduledGenerator):
        fail(f"answer: the default generator is {type(gen).__name__}, "
             "not the wave scheduler")
    inner = gen.inner
    print(f"answer[{LLM}] {inner.dims} seeded and quantized (int8) in "
          f"{load_s:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "on the card", flush=True)

    K.reset_launches()
    t0 = time.perf_counter()
    res = rag.query(SPINE_QUERIES[0][0], collection="answer",
                    generate_answer=True)
    query_s = time.perf_counter() - t0
    launches = launch_counts(K)
    steps = inner.last_stats["steps"]
    print(f"answer[{LLM},query] top {[r.chunk_id for r in res.results]} "
          f"answer {res.answer[:80]!r}... tokens "
          f"{inner.last_token_counts} stage ms "
          f"{json.dumps({k: v * 1e3 for k, v in res.stage_timings.items()})}"
          f" query ms {query_s * 1e3:.1f} launches {json.dumps(launches)}",
          flush=True)
    if res.answer is None or not inner.last_token_counts[0]:
        fail(f"answer[{LLM},query]: no answer")
    if inner.last_stats["prompt_bucket"] != SERVED_BUCKET:
        fail(f"answer[{LLM},query]: prompt bucket "
             f"{inner.last_stats['prompt_bucket']}, not the served "
             f"{SERVED_BUCKET}")
    check_llm_launches(f"answer[{LLM},query]", launches, steps, 8,
                       inner.dims.n_layers)
    by_path[f"answer[{LLM},query]"] = launches

    prompts = answer_prompts(ANSWER_WAVE, served=True)
    waves = {}
    for tag, batch in (("wave16", prompts), ("single", prompts[:1])):
        before = gen.scheduler.batches_run
        K.reset_launches()
        t0 = time.perf_counter()
        futures = [gen.scheduler.submit(p, system=SYSTEM_PROMPT)
                   for p in batch]
        answers = [f.result() for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(K)
        waves[tag] = wave_stats(inner, wall)
        print(f"answer[{LLM},{tag}] {json.dumps(waves[tag])} waves "
              f"{gen.scheduler.batches_run - before} answers "
              f"{len(answers)} launches {json.dumps(launches)}", flush=True)
        if gen.scheduler.batches_run - before != 1:
            fail(f"answer[{LLM},{tag}]: {len(batch)} concurrent requests "
                 "were not one wave")
        if waves[tag]["prompt_bucket"] != SERVED_BUCKET:
            fail(f"answer[{LLM},{tag}]: prompt bucket "
                 f"{waves[tag]['prompt_bucket']}, not {SERVED_BUCKET}")
        check_llm_launches(f"answer[{LLM},{tag}]", launches,
                           inner.last_stats["steps"], 8, inner.dims.n_layers)
        by_path[f"answer[{LLM},{tag}]"] = launches

    # the first decode step against the plain path (the checks' launches
    # are not the path's)
    got = first_step_logits(torch, inner, prompts[:4])
    with plain_kernels(K):
        ref = first_step_logits(torch, inner, prompts[:4])
    check_logits(f"answer[{LLM}]", [got], [ref])
    del got, ref

    # a greedy single stream: speculative (k = 8) and step decode in turns
    streams = single_streams(torch, K, gen, prompts[0])
    print(f"answer[{LLM},single-greedy] " + json.dumps(
        {tag: {k: v for k, v in run.items() if k != "ids"}
         for tag, run in streams.items()}), flush=True)
    for tag, run in streams.items():
        want = run["loop_iterations"] * (4 * inner.dims.n_layers + 1)
        if run["q8_launches"] != want:
            fail(f"answer[{LLM},{tag}]: {run['q8_launches']} matmul_q8w "
                 f"launches for {run['loop_iterations']} iterations")
    by_path[f"answer[{LLM},single-greedy]"] = {
        Q8W: sum(run["q8_launches"] for run in streams.values())}
    # every stream teacher-forced through the step path: the step
    # stream itself must come back exactly, the others token by token up
    # to a near-tie (distinct streams only: each costs a decode loop)
    step_ids = streams["spec0#0"]["ids"]
    held: dict[tuple, tuple] = {}
    for tag in ("spec0#0", "spec8#0", "spec8#1", "spec0#1"):
        ids = tuple(streams[tag]["ids"])
        if ids not in held:
            held[ids] = held_to_step_path(torch, inner, prompts[0], ids)
        ties, wrong = held[ids]
        at = next((i for i, (x, y) in enumerate(zip(ids, step_ids))
                   if x != y), min(len(ids), len(step_ids)))
        print(f"answer[{LLM},{tag}] tokens equal the step path's through "
              f"{at} of {len(step_ids)}; teacher-forced through the step "
              f"path, near-ties (index, token, best, gap, bound) {ties}, "
              f"beyond {TIE_ULPS} ulps {wrong}", flush=True)
        if wrong or (tag == "spec0#0" and ties):
            fail(f"answer[{LLM},{tag}]: greedy tokens that are not the step "
                 f"path's best on their own prefix: {ties + wrong}")
    step, verify = first_verify_logits(torch, inner, prompts[0])
    check_logits(f"answer[{LLM},verify]", [verify], [step])
    del step, verify

    # 16 requests and a late short one: one wave, then the batcher
    late_prompts = answer_prompts(ANSWER_WAVE + 1, served=True)
    waves["waves+late"] = waves_with_late(gen, late_prompts)
    print(f"answer[{LLM},waves+late] {json.dumps(waves['waves+late'])}",
          flush=True)
    traced = profile_llm_step(torch, inner, ANSWER_WAVE)
    print(f"answer[{LLM}] traced decode steps at B={ANSWER_WAVE} "
          f"{json.dumps(traced)}", flush=True)
    cont = continuous_with_late(torch, K, rag, late_prompts)
    launches = cont.pop("launches")
    waves["continuous+late"] = cont
    print(f"answer[{LLM},continuous+late] {json.dumps(cont)} launches "
          f"{json.dumps(launches)}", flush=True)
    check_launches(f"answer[{LLM},continuous]", launches, {Q8W})
    if launches[Q8W] % (4 * inner.dims.n_layers + 1):
        fail(f"answer[{LLM},continuous]: {launches[Q8W]} matmul_q8w "
             "launches, not whole decode steps")
    by_path[f"answer[{LLM},continuous]"] = launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    batcher = rag.generator.scheduler
    rag.unload_all()  # stops the batcher and frees its cache, drops weights
    if batcher._thread.is_alive() or batcher._cache is not None:
        fail(f"answer[{LLM}]: the batcher's thread or cache outlived "
             "unload_all")
    del rag, gen, inner, batcher
    free_card(torch)

    # the same wave with the int4 head
    gen4 = LLMGenerator(llm_config(lm_head_int4=True), device="cuda")
    gen4.load()
    K.reset_launches()
    t0 = time.perf_counter()
    gen4.generate_batch(prompts, system=SYSTEM_PROMPT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(K)
    waves["wave16,lm4"] = wave_stats(gen4, wall)
    print(f"answer[{LLM},wave16,lm4] {json.dumps(waves['wave16,lm4'])} "
          f"launches {json.dumps(launches)}", flush=True)
    check_llm_launches(f"answer[{LLM},wave16,lm4]", launches,
                       gen4.last_stats["steps"], 4, gen4.dims.n_layers)
    if gen4.last_stats["prompt_bucket"] != SERVED_BUCKET:
        fail(f"answer[{LLM},wave16,lm4]: prompt bucket "
             f"{gen4.last_stats['prompt_bucket']}, not {SERVED_BUCKET}")
    by_path[f"answer[{LLM},wave16,lm4]"] = launches
    gen4.unload()
    del gen4
    free_card(torch)
    left = torch.cuda.memory_allocated()
    print(f"answer[{LLM}] summary", json.dumps(
        {"card": card_line(), "peak_gb": peak, "allocated_before_gb":
         base / 1e9, "allocated_after_gb": left / 1e9, **waves}),
        flush=True)
    # what may stay: the rope tables (4 MB at 3b) and the cuBLAS workspace
    # of the scheduler's thread
    if left - base > ANSWER_LEFT_MAX:
        fail(f"answer: {(left - base) / 1e9:.3f} GB stay on the card after "
             f"unload_all (at most {ANSWER_LEFT_MAX / 1e9:.3f})")
    return by_path


# -- phase 12: live transcription ---------------------------------------------------

#: the JAX end-to-end streaming test's session and utterance
STREAM_TINY = {"chunk_duration": 4.0, "overlap_duration": 0.5,
               "max_decode_tokens": 112}
STREAM_E2E = "the model learns fast and stops"
STREAM_PHRASES = SPINE_TURNS + [STREAM_E2E]
#: live sessions (the schema's max_sessions) and seconds of speech each:
#: 6 s is three chunks a session at 3 s chunks and 0.6 s overlap, three
#: full dispatches of 8 (15 s, six of them, took 70 s with the ladder on
#: a slow host and pushed the script past 1,000 s)
STREAM_SESSIONS, STREAM_SECONDS = 8, 6.0
STREAM_QUERIES = 32


def stream_rows(results) -> list:
    """StreamingResults as plain rows: text, chunk bounds, final, words."""
    return [{"text": r.text, "start": r.start, "end": r.end,
             "final": r.is_final,
             "words": [(w.text, w.start, w.end) for w in r.words]}
            for r in results]


def stream_gap(got: list, ref: list) -> float | None:
    """The largest word-time difference of two replays with the same
    chunks, texts and words; None where those differ."""
    key = [(r["text"], r["start"], r["end"], r["final"],
            [w[0] for w in r["words"]]) for r in ref]
    if [(r["text"], r["start"], r["end"], r["final"],
         [w[0] for w in r["words"]]) for r in got] != key:
        return None
    return max((abs(a[i] - b[i]) for g, r in zip(got, ref)
                for a, b in zip(g["words"], r["words"]) for i in (1, 2)),
               default=0.0)


def same_stream(tag: str, got: list, ref: list) -> None:
    """Fail unless two replays agree: chunks, texts and words equal, word
    times within :data:`TIME_TOL`."""
    gap = stream_gap(got, ref)
    if gap is None or gap > TIME_TOL:
        fail(f"{tag}: {json.dumps(got)} differs from {json.dumps(ref)}")


def stream_utterances():
    """The end-to-end test's utterance (its draw: seed 3) and four
    sessions' speech, two phrases each."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR, synth_text

    e2e = synth_text(STREAM_E2E, np.random.default_rng(3),
                     noise_level=0.005)
    rng = np.random.default_rng(17)
    gap = np.zeros(int(0.3 * SR), np.float32)
    sessions = [np.concatenate([
        synth_text(STREAM_PHRASES[i], rng, noise_level=0.005), gap,
        synth_text(STREAM_PHRASES[(i + 1) % 4], rng, noise_level=0.005)])
        for i in range(4)]
    return e2e, sessions


def run_tiny_stream(device: str, profile: str):
    """Tiny-synth (trained, f32, VAD and ladder off) in ``profile``
    ("fp32" or a :data:`PROFILES` key): the end-to-end replay and each
    session's speech replayed alone through one ``StreamingASR``.
    Returns the rows and the backend."""
    from audio_rag_tpu_torch.asr.streaming import (
        StreamingASR, StreamingConfig)
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.config import ASRConfig

    switches = {} if profile == "fp32" else PROFILES[profile][0]
    asr = WhisperASR(ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False,
        max_decode_tokens=STREAM_TINY["max_decode_tokens"], **switches),
        device)
    e2e, sessions = stream_utterances()
    sess = StreamingASR(asr.config, StreamingConfig(**STREAM_TINY),
                        backend=asr)
    sess.load()
    try:
        out = {"e2e": stream_rows(sess.process_stream(e2e, SR)),
               "alone": [stream_rows(sess.process_stream(a, SR))
                         for a in sessions]}
    finally:
        sess.unload()
    return out, asr


def run_sessions(mux, config, stream_cfg, audios) -> tuple[list, float,
                                                          list]:
    """One ``StreamingASR`` per audio on ``mux``, all loaded (the mux warms
    once), then replayed at once from their own threads, unpaced. Returns
    each session's results, the wall seconds of the replays and each
    session's language."""
    import threading

    from audio_rag_tpu_torch.asr.streaming import StreamingASR
    from audio_rag_tpu_torch.audio.charvoice import SR

    sessions = [StreamingASR(config, stream_cfg, mux=mux) for _ in audios]
    for s in sessions:
        s.load()
    results: list = [None] * len(audios)
    errors: list = []
    start = threading.Barrier(len(audios) + 1)

    def run(i):
        try:
            start.wait(timeout=60)
            results[i] = list(sessions[i].process_stream(audios[i], SR))
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), name=f"session{i}")
               for i in range(len(audios))]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    langs = [s._session_lang for s in sessions]
    for s in sessions:
        s.unload()
    if any(t.is_alive() for t in threads):
        fail("stream: a session did not finish within 900 s")
    if errors:
        raise errors[0]
    return results, wall, langs


@contextlib.contextmanager
def plain_calls(K, names):
    """Count calls of the named kernels' plain versions (their wrappers
    look them up in the module at each call)."""
    counts = {name: 0 for name in names}
    saved = {name: getattr(K, name + "_plain") for name in names}

    def spy(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for name in names:
        setattr(K, name + "_plain", spy(name, saved[name]))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(K, name + "_plain", fn)


def stream_tiny(torch, K, device: str = "cuda") -> dict:
    """(a) tiny-synth sessions: the end-to-end replay on ``device`` against
    the CPU, then four sessions sharing a mux of 4 against their replays
    alone, in f32 and the int8 profile. Returns launches by path."""
    from audio_rag_tpu_torch.asr.mux import StreamingMux
    from audio_rag_tpu_torch.asr.streaming import StreamingConfig

    by_path = {}
    _, sessions = stream_utterances()
    for profile in ("fp32", "int8"):
        tag = f"stream[tiny,{profile}]"
        got, asr = run_tiny_stream(device, profile)
        ref, _ = run_tiny_stream("cpu", profile)
        print(f"{tag} e2e {json.dumps(got['e2e'])}", flush=True)
        same_stream(f"{tag} e2e against the CPU", got["e2e"], ref["e2e"])
        for i, (g, r) in enumerate(zip(got["alone"], ref["alone"])):
            same_stream(f"{tag} session {i} against the CPU", g, r)
        text = " ".join(r["text"] for r in got["e2e"])
        heard = [w for w in ("model", "learns", "fast", "stops")
                 if w in text]
        if len(heard) < 3:
            fail(f"{tag}: heard {heard} of the 4 words in {text!r}")
        mux = StreamingMux(asr, max_batch=4, linger_ms=50.0)
        try:
            mux.ensure_ready(16_000, STREAM_TINY["chunk_duration"])
            K.reset_launches()
            with plain_calls(K, K.KERNELS) as plain:
                muxed, wall, _ = run_sessions(
                    mux, asr.config, StreamingConfig(**STREAM_TINY), sessions)
            sync(torch, device)
            launches = launch_counts(K)
        finally:
            mux.stop()
        gaps = [stream_gap(stream_rows(m), a)
                for m, a in zip(muxed, got["alone"])]
        print(f"{tag} mux of 4: {mux.chunks_served} chunks in "
              f"{mux.batches_run} batches, {wall:.2f} s; word-time gaps to "
              f"the replays alone {gaps}; launches {json.dumps(launches)}; "
              f"plain calls {json.dumps(plain)}", flush=True)
        for i, (m, a) in enumerate(zip(muxed, got["alone"])):
            same_stream(f"{tag} muxed session {i}", stream_rows(m), a)
        if mux.batches_run >= mux.chunks_served:
            fail(f"{tag}: the mux batched nothing")
        if device == "cuda":
            expect = {FLASH} if profile == "fp32" else PROFILES[profile][1]
            check_launches(f"{tag} mux", launches, expect)
            if any(plain[name] for name in expect):
                fail(f"{tag}: kernels fell back to plain versions: {plain}")
        by_path[f"{tag} mux"] = launches
        del asr
    return by_path


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def stream_shipped(torch, K, device: str = "cuda",
                   model_size: str = "large-v3",
                   seconds: float = STREAM_SECONDS) -> dict:
    """(b) the shipped streaming profile (configs/low_latency.yaml: bf16,
    int8 cross K/V and decode weights, 3 s chunks, 0.6 s overlap, 40
    tokens, learned VAD, languages detected per session, word times, the
    ladder on) with seeded weights: one row's first-step logits at B = 8
    against B = 1; a lone chunk's dispatch; 8 sessions through one mux of
    8, with the ladder and without; the pad rows' price. Returns launches
    by path."""
    import dataclasses

    import numpy as np

    from audio_rag_tpu_torch.asr.mux import StreamingMux
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.config import ASRConfig
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH

    tag = f"stream[{model_size}]"
    # configs/low_latency.yaml's streaming section (3 s chunks, 0.6 s
    # overlap, 40 tokens)
    stream_cfg = shipped("low_latency").streaming.to_runtime()
    config = ASRConfig(model_size=model_size, compute_type="bfloat16",
                       seed=0, **PROFILES["int8"][0])
    # the backend a session builds: the decode budget capped by the stream
    t0 = time.perf_counter()
    asr = WhisperASR(dataclasses.replace(
        config, max_decode_tokens=stream_cfg.max_decode_tokens), device)
    asr.load()
    sync(torch, device)
    print(f"{tag} load_s {time.perf_counter() - t0:.2f}", flush=True)
    audios = [long_speech(seconds, seed=40 + i)
              for i in range(STREAM_SESSIONS)]
    chunk = int(stream_cfg.chunk_duration * SR)
    chunks = [a[:chunk] for a in audios]
    n = 2 * asr.dims.n_audio_ctx * HOP_LENGTH

    def windows(rows):
        win = np.zeros((len(rows), n), np.float32)
        for j, r in enumerate(rows):
            win[j, : min(len(r), n)] = r[:n]
        return win.reshape(-1)

    # first-step logits at both dispatch sizes: the kernels against their
    # plain versions on the same windows, then one row in a batch of 8
    # against the row alone
    first = {}
    for B, rows in ((STREAM_SESSIONS, chunks), (1, chunks[:1])):
        asr.config.window_batch_size = B
        wav = windows(rows)
        first[B] = decode_window(torch, asr, wav)[0][0]
        with plain_kernels(K):
            ref = decode_window(torch, asr, wav)[0][0]
        check_logits(f"{tag} B = {B}", [first[B]], [ref])
        del ref
    asr.config.window_batch_size = config.window_batch_size
    check_logits(f"{tag} row 0 at B = {STREAM_SESSIONS} against B = 1",
                 [first[STREAM_SESSIONS][:1]], [first[1]])
    del first

    mux = StreamingMux(asr, max_batch=STREAM_SESSIONS)
    dispatches: list = []
    detects: list = []
    run_batch, detect_rows = mux._run_batch, asr.detect_language_rows

    def timed_batch(payloads, key):
        sync(torch, device)
        t = time.perf_counter()
        out = run_batch(payloads, key)
        sync(torch, device)
        dispatches.append({
            "chunks": len(payloads), "ms": (time.perf_counter() - t) * 1e3,
            "ladder": asr.config.temperature_fallback,
            "windows": asr.timings["windows"],
            "fallback_decodes": asr.timings["fallback_decodes"],
            "decode_steps": asr.timings["decode_steps"]})
        return out

    def timed_detect(rows, pad_to=None):
        sync(torch, device)
        t = time.perf_counter()
        out = detect_rows(rows, pad_to)
        sync(torch, device)
        detects.append({"rows": len(rows), "pad_to": pad_to,
                        "ms": (time.perf_counter() - t) * 1e3})
        return out

    mux._run_batch = timed_batch
    asr.detect_language_rows = timed_detect
    by_path: dict = {}
    try:
        t0 = time.perf_counter()
        mux.ensure_ready(SR, stream_cfg.chunk_duration)
        print(f"{tag} warm-up (B = 1 and {STREAM_SESSIONS}, on the mux's "
              f"thread) {time.perf_counter() - t0:.2f} s", flush=True)

        def lone():
            sync(torch, device)
            t = time.perf_counter()
            asr.transcribe_chunk_batch([chunks[0]], SR, word_timestamps=True,
                                       language="en", pad_to=1)
            sync(torch, device)
            return (time.perf_counter() - t) * 1e3

        for ladder in (True, False):
            asr.config.temperature_fallback = ladder
            setting = "shipped, ladder on" if ladder else "ladder off"
            print(f"{tag} lone chunk, B = 1 ({setting}): dispatch ms "
                  f"{mux.call(lone).result():.1f}", flush=True)

            path = f"{tag} sessions ({setting})"
            d0, n0 = len(dispatches), len(detects)
            served0, batches0 = mux.chunks_served, mux.batches_run
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            with plain_calls(K, K.KERNELS) as plain:
                results, wall, langs = run_sessions(mux, config, stream_cfg,
                                                    audios)
            sync(torch, device)
            launches = launch_counts(K)
            runs, dets = dispatches[d0:], detects[n0:]
            lat = sorted(r.processing_time_ms for rs in results for r in rs)
            served = mux.chunks_served - served0
            batches = mux.batches_run - batches0
            b8 = [d["ms"] for d in runs if d["chunks"] > 1]
            b1 = [d["ms"] for d in runs if d["chunks"] == 1]
            out = {
                "card": card_line() if device == "cuda" else device,
                "sessions": len(audios), "seconds_each": seconds,
                "wall_s": wall, "chunks_served": served,
                "batches_run": batches,
                "mean_chunks_a_batch": served / max(batches, 1),
                "dispatch_ms_B8": b8, "dispatch_ms_B1": b1,
                "mean_dispatch_ms_B8": (sum(b8) / len(b8) if b8 else None),
                "submit_to_result_ms_p50": float(np.percentile(lat, 50)),
                "submit_to_result_ms_p95": float(np.percentile(lat, 95)),
                "detect_dispatches": dets,
                "session_languages": langs,
                "fallback_decodes_a_dispatch": [d["fallback_decodes"]
                                                for d in runs],
                "launches": launches, "plain_calls": plain,
                "launches_a_dispatch": {
                    name: launches[name] / max(len(runs), 1)
                    for name in (FLASH, Q8W, CROSS8)},
                "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if device == "cuda" else None)}
            print(path, json.dumps(out), flush=True)
            texts = [r.text for rs in results for r in rs]
            if served != sum(len(rs) for rs in results) or not lat:
                fail(f"{path}: {served} chunks served for "
                     f"{sum(len(rs) for rs in results)} results")
            if device == "cuda":
                check_launches(path, launches, PROFILES["int8"][1],
                               asr.dims.n_audio_layer
                               * (len(runs) + len(dets)))
                if any(plain.values()):
                    fail(f"{path}: plain versions ran: {plain}")
            if not any(texts):
                fail(f"{path}: every chunk came back empty")
            by_path[path] = launches

        # the pad rows' price: 2 chunks at B = 8 against B = 2, ladder off,
        # every call on the mux's thread (cuBLAS handles are per thread)
        pair = chunks[:2]

        def at(B):
            sync(torch, device)
            t = time.perf_counter()
            asr.transcribe_chunk_batch(pair, SR, word_timestamps=True,
                                       language="en", pad_to=B)
            sync(torch, device)
            return {"B": B, "ms": (time.perf_counter() - t) * 1e3,
                    **{k: asr.timings[k] for k in (
                        "decode_steps", "windows", "fallback_decodes",
                        "vad_s", "mel_s", "encode_s", "decode_s",
                        "align_s")}}

        # the mux warmed B = 8; the first call at B = 2 picks its GEMMs
        warm = mux.call(lambda: at(2)).result()
        runs = [mux.call(lambda B=B: at(B)).result()
                for B in (STREAM_SESSIONS, 2, 2, STREAM_SESSIONS,
                          STREAM_SESSIONS, 2)]
        for r in runs:
            r["ms_a_step"] = r["ms"] / max(r["decode_steps"], 1)
        ms = {B: [r["ms"] for r in runs if r["B"] == B]
              for B in (2, STREAM_SESSIONS)}
        same_steps = len({r["decode_steps"] for r in runs}) == 1
        price = (float(np.median(ms[STREAM_SESSIONS]))
                 / float(np.median(ms[2])) - 1.0)
        if not same_steps:
            verdict = "the decode steps differ: compare ms_a_step"
        elif price >= 0.0:
            verdict = (f"B = 2 no slower than B = 8 (medians) at equal "
                       f"decode steps: the pad rows cost {price:+.3f}")
        else:
            verdict = ("B = 2 slower than B = 8 (medians) at equal decode "
                       "steps: unresolved")
        print(f"{tag} pad rows (ladder off, in turns, on the mux's "
              f"thread)", json.dumps({"warm_up_B2": warm, "runs": runs,
                                      "verdict": verdict}), flush=True)
    finally:
        mux.stop()
    return by_path


def stream_queries(torch, K, device: str = "cuda") -> dict:
    """(c) 32 single queries from their own threads through a
    ``QueryCoalescer`` on the eval-small query spine: the rankings of one
    direct ``AudioRAG.query_batch``, in fewer batches than queries, and no
    kernel launched. Returns the launches."""
    import threading

    import numpy as np

    from audio_rag_tpu_torch.config import (
        AudioRAGConfig, EmbeddingConfig, RerankingConfig, RetrievalConfig)
    from audio_rag_tpu_torch.engine.query_coalescer import QueryCoalescer
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(model="eval-small"), device=device))
    chunks = spine_corpus()
    rag.store.add(chunks, rag.embedder.embed([c.text for c in chunks]),
                  "query")
    rng = np.random.default_rng(23)
    queries = [" ".join(rng.choice(SPINE_WORDS, 3).tolist())
               for _ in range(STREAM_QUERIES)]
    K.reset_launches()
    ref = rag.query_batch(queries, collection="query")
    coalescer = QueryCoalescer(rag)
    got: list = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def ask(i):
        start.wait(timeout=60)
        got[i] = coalescer.query(queries[i], collection="query")

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(queries))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        coalescer.stop()
    wall = time.perf_counter() - t0
    sync(torch, device)
    launches = launch_counts(K)
    bad = [q for q, g, r in zip(queries, got, ref) if g is None or
           not same_ranking([(x.chunk_id, x.score) for x in g.results],
                            [(x.chunk_id, x.score) for x in r.results])]
    print("stream[queries]", json.dumps({
        "queries": len(queries), "batches_run": coalescer.batches_run,
        "requests_served": coalescer.requests_served, "wall_s": wall,
        "differ_from_query_batch": bad, "launches": launches}), flush=True)
    if bad:
        fail(f"stream[queries]: coalesced rankings differ from query_batch "
             f"for {bad}")
    if coalescer.batches_run >= len(queries):
        fail("stream[queries]: the coalescer batched nothing")
    if any(launches.values()):
        fail(f"stream[queries]: kernels launched on the query half: "
             f"{launches}")
    return {"stream[queries]": launches}


def phase_stream(torch, K, device: str = "cuda") -> dict:
    """Live transcription: (a) :func:`stream_tiny`, (b)
    :func:`stream_shipped` at large-v3, (c) :func:`stream_queries`.
    Returns launches by path."""
    t0 = time.perf_counter()
    by_path = stream_tiny(torch, K, device)
    if device == "cuda":
        free_card(torch)
    by_path.update(stream_shipped(torch, K, device))
    if device == "cuda":
        free_card(torch)
    by_path.update(stream_queries(torch, K, device))
    print(f"stream_s {time.perf_counter() - t0:.1f}", flush=True)
    return by_path


# -- phase 13: a shipped profile through the pipeline's entry points --------------------

#: files of speech the phase ingests, turns a file, seconds a turn's window
PROFILE_FILES, PROFILE_TURNS, PROFILE_TURN_S = 3, 5, 6.0
PROFILE_QUERIES = ["gradient descent loss", "spectrogram harmonic",
                   "attention token layer"]
#: the run's own settings, set as a deployment sets them (the store's
#: directory is added in the phase's workdir)
PROFILE_ENV = {"AUDIO_RAG__ASR__MAX_DECODE_TOKENS": "32",
               "AUDIO_RAG__GENERATION__MAX_TOKENS": "64",
               "AUDIO_RAG__CONTEXTUAL__ENABLED": "true"}
PROFILE_SPANS = ("ingest.transcribe", "ingest.diarize",
                 "ingest.contextualize", "ingest.embed", "ingest.index")
#: the decode linears' input widths: Whisper large-v3's, llama-3.2-3b's
WHISPER_DIN, LLAMA_DIN = 1280, 3072


@contextlib.contextmanager
def env_vars(values: dict):
    """``values`` in ``os.environ`` for the block, the old ones restored."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def shipped(env: str, **env_values):
    """``configs/{env}.yaml`` over ``base.yaml``, through the port's loader
    (the run's settings in ``env_values`` as ``AUDIO_RAG__`` variables)."""
    from audio_rag_tpu_torch.config import load_config

    with env_vars(env_values):
        return load_config(env=env, configs_dir=ROOT / "configs")


def profile_files(workdir: Path) -> list[str]:
    """``PROFILE_FILES`` WAV files of ``PROFILE_TURNS`` spoken turns each
    (:func:`speak`, a seed a file)."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.audio.io import write_wav

    paths = []
    for i in range(PROFILE_FILES):
        rng = np.random.default_rng(60 + i)
        turns = [" ".join(rng.choice(SPINE_WORDS, 6).tolist())
                 for _ in range(PROFILE_TURNS - 1)] + [SPINE_TURNS[i]]
        paths.append(str(workdir / f"talk{i}.wav"))
        write_wav(paths[-1], speak(turns, rng, PROFILE_TURN_S), SR)
    return paths


def check_production(cfg, persist_dir: Path, full: bool) -> None:
    """Fail unless ``cfg`` holds configs/production.yaml's values (``full``:
    its model names too) and the run's own settings."""
    want = {
        "asr.compute_type": "bfloat16", "asr.window_batch_size": 16,
        "asr.cross_kv_int8": True, "asr.decoder_int8": True,
        "asr.temperature_fallback": True, "asr.language": None,
        "asr.max_decode_tokens": 32, "retrieval.quantize_dense": True,
        "retrieval.persist_dir": str(persist_dir),
        "generation.decoder_int8": True, "generation.speculative_k": 8,
        "generation.max_tokens": 64, "contextual.enabled": True,
        "contextual.backend": "llm", "log_level": "INFO",
    }
    if full:
        want.update({"asr.model_size": "large-v3",
                     "generation.model": LLM,
                     "embedding.model": "BAAI/bge-m3",
                     "reranking.model": "BAAI/bge-reranker-base"})
    got = {k: getattr(getattr(cfg, k.split(".")[0]), k.split(".")[1])
           if "." in k else getattr(cfg, k) for k in want}
    if got != want:
        fail("profiles: the loaded config is not production.yaml's: "
             f"{ {k: (got[k], v) for k, v in want.items() if got[k] != v} }")


def stored_rows(rag, collection: str) -> list:
    """A collection's chunks as (text, speaker, start, end) in order."""
    return [(p["text"], p["speaker"], round(float(p["start"]), 3),
             round(float(p["end"]), 3))
            for p in rag.store._coll(collection).payloads]


def top5(rag, collection: str) -> list:
    return [[r.text for r in rag.query(q, collection=collection).results]
            for q in PROFILE_QUERIES]


@contextlib.contextmanager
def q8w_widths(K):
    """Count ``matmul_q8w`` calls by the weight's input width (the wrapper
    is looked up in the module at each call); launches only on a card."""
    import collections

    widths: collections.Counter = collections.Counter()
    wrapper = K.matmul_q8w

    def spy(x, w8, s):
        widths[int(w8.shape[0])] += 1
        return wrapper(x, w8, s)

    K.matmul_q8w = spy
    try:
        yield widths
    finally:
        K.matmul_q8w = wrapper


def ledger_events(rm, start: int) -> list[dict]:
    """The manager's load and eviction events from ``start`` on."""
    return [dict(e) for e in rm.events[start:]]


def print_ledger(tag: str, events: list[dict], card: str) -> None:
    """A run's evictions, each swap's unload and (re)load seconds, and each
    load's estimate beside the allocation change it measured."""
    ev = [e for e in events if e["kind"] == "evict"]
    print(f"{tag} evictions {len(ev)}: " + json.dumps(
        [(e["name"], round(e["seconds"], 4),
          None if e["allocated_delta"] is None
          else round(-e["allocated_delta"] / 1e9, 4),
          round(-e["engine_delta"] / 1e9, 4)) for e in ev])
        + " (name, unload s, GB freed on the card, GB the engine had; "
        f"{card})", flush=True)
    loads = [e for e in events if e["kind"] == "load"]
    print(f"{tag} loads {len(loads)}: " + json.dumps(
        [(e["name"], round(e["seconds"], 3), round(e["gb"], 4),
          None if e["allocated_delta"] is None
          else round(e["allocated_delta"] / 1e9, 4)) for e in loads])
        + f" (name, load s, estimate GB, GB allocated by the load; {card})",
        flush=True)


def check_evictions(tag: str, events: list[dict]) -> None:
    """Fail unless each eviction gave back at least 90 % of the bytes the
    engine had recorded for the model (a reference left behind keeps a
    model alive)."""
    for e in events:
        if e["kind"] != "evict" or e["allocated_delta"] is None:
            continue
        if -e["engine_delta"] <= 0:
            fail(f"{tag}: the eviction of {e['name']} dropped nothing from "
                 f"the engine: {e}")
        if -e["allocated_delta"] < 0.9 * -e["engine_delta"]:
            fail(f"{tag}: the eviction of {e['name']} freed "
                 f"{-e['allocated_delta'] / 1e9:.4f} GB of the "
                 f"{-e['engine_delta'] / 1e9:.4f} GB it held")


def production_rag(device: str, workdir: Path, rehearse: dict | None):
    """``AudioRAG.from_config(env="production")`` with the run's settings
    (``rehearse``: AUDIO_RAG__ values that shrink the models for a CPU
    rehearsal), its values checked."""
    from audio_rag_tpu_torch.pipeline import AudioRAG

    persist = workdir / "collections"
    values = {**PROFILE_ENV, "AUDIO_RAG__RETRIEVAL__PERSIST_DIR":
              str(persist), **(rehearse or {})}
    with env_vars(values):
        rag = AudioRAG.from_config(env="production",
                                   configs_dir=ROOT / "configs")
    check_production(rag.config, persist, full=not rehearse)
    if str(rag.device) != device and rag.device.type != device:
        fail(f"profiles: AudioRAG runs on {rag.device}, not {device}")
    return rag


def run_profiles(torch, K, device: str, workdir: Path,
                 rehearse: dict | None = None,
                 budget_gb: float | None = None) -> dict:
    """The phase's work: from_config(env="production") → ingest_batch with
    headers → queries, then the per-file loop, a checkpointed ingest
    resumed from "aligned" with an ASR that raises, ``status()`` and
    ``clear_collection``, all under the profile's device-memory ledger
    (``budget_gb`` replaces its 14 GB, for a CPU rehearsal that evicts).
    ``rehearse`` (AUDIO_RAG__ values) shrinks the models for a CPU
    rehearsal. Returns what it measured, with the pipeline (``rag``,
    loaded) and the files for the queue phase."""
    from audio_rag_tpu_torch.resources.manager import get_resource_manager
    from audio_rag_tpu_torch.utils.decorators import reset_stage_timings
    from audio_rag_tpu_torch.utils.tracing import reset_traces

    rag = production_rag(device, workdir, rehearse)
    rm = get_resource_manager()
    if budget_gb is not None:
        rm.max_hbm_gb = budget_gb
    files = profile_files(workdir)
    reset_stage_timings()
    reset_traces()
    t0 = time.perf_counter()
    n0 = len(rm.events)
    for stage in ("asr", "diarizer", "embedder", "generator", "reranker"):
        getattr(rag, stage)  # loaded outside the timed runs
    sync(torch, device)
    out = {"load_s": time.perf_counter() - t0, "rag": rag, "files": files,
           "budget_gb": rm.max_hbm_gb, "load_events": ledger_events(rm, n0)}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def timed_run(tag, fn):
        K.reset_launches()
        n0 = len(rm.events)
        with q8w_widths(K) as widths, plain_calls(K, K.KERNELS) as plain:
            t0 = time.perf_counter()
            results = fn()
            sync(torch, device)
            wall = time.perf_counter() - t0
            events = ledger_events(rm, n0)
            tops = top5(rag, tag)
            sync(torch, device)
        out[tag] = {"wall_s": wall, "results": results, "tops": tops,
                    "rows": stored_rows(rag, tag),
                    "launches": launch_counts(K), "q8w_widths": dict(widths),
                    "plain_calls": dict(plain), "events": events}

    # (b) the staged batch, then the per-file loop; the loop's first file
    # is checkpointed, for (c)
    timed_run("batch", lambda: rag.ingest_batch(files, collection="batch"))
    ckpt: dict = {}

    def loop():
        first = rag.ingestion.ingest(files[0], collection="loop",
                                     checkpoint_cb=ckpt.__setitem__)
        return [first] + [rag.ingest(f, None, "loop") for f in files[1:]]

    timed_run("loop", loop)
    # (c) resume from "aligned": the audio stages must not run again
    asr = rag.asr

    def refuse(*args, **kw):
        raise AssertionError("the ASR ran on a resumed ingest")

    asr.transcribe_with_words = refuse
    try:
        resumed = rag.ingestion.ingest(
            files[0], collection="resumed",
            resume={"stage": "aligned", **json.loads(json.dumps(
                ckpt["aligned"]))})
    finally:
        del asr.transcribe_with_words
    out["checkpoints"] = list(ckpt)
    out["resumed"] = {"rows": stored_rows(rag, "resumed"),
                      "stage_timings": resumed.stage_timings}
    out["first_file_rows"] = out["loop"]["rows"][
        : out["loop"]["results"][0].num_chunks]
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    # (d)
    out["status"] = rag.status()
    out["counts"] = {c: rag.count(c) for c in ("batch", "loop", "resumed")}
    out["cleared"] = {c: (rag.clear_collection(c), rag.count(c))
                      for c in ("batch", "loop", "resumed")}
    return out


def phase_profiles(torch, K, workdir: Path) -> dict:
    """(13) configs/production.yaml through ``from_config`` at full width
    (seeded weights) under its 14 GB device-memory ledger: three 30 s
    files through ``ingest_batch`` with 3b headers (stage-grouped) and
    through the per-file loop (the same chunks and top 5), resume from a
    checkpoint, ``status()``; launches checked; evictions, swap seconds,
    estimates against allocations and peak memory printed. Returns
    launches by path ("launches"), the loaded pipeline ("rag"), the files
    and the batch run for the queue phase."""
    t0 = time.perf_counter()
    out = run_profiles(torch, K, "cuda", workdir)
    card = card_line()
    batch, loop = out["batch"], out["loop"]
    print_ledger(f"profiles[load] (budget {out['budget_gb']} GB)",
                 out["load_events"], card)
    for tag, run in (("batch", batch), ("loop", loop)):
        for i, res in enumerate(run["results"]):
            print(f"profiles[{tag}] file {i} chunks {res.num_chunks} "
                  f"speakers {res.num_speakers} stage s "
                  f"{json.dumps(res.stage_timings)} ({card})", flush=True)
        print(f"profiles[{tag}] wall_s {run['wall_s']:.3f} launches "
              f"{json.dumps(run['launches'])} matmul_q8w by din "
              f"{json.dumps(run['q8w_widths'])} ({card})", flush=True)
        print_ledger(f"profiles[{tag}]", run["events"], card)
        check_evictions(f"profiles[{tag}]", run["events"])
    print(f"profiles load_s {out['load_s']:.1f} batch/loop wall "
          f"{batch['wall_s']:.3f} / {loop['wall_s']:.3f} s "
          f"({batch['wall_s'] / loop['wall_s']:.3f}x) peak allocated "
          f"{out['peak_mem_gb']:.2f} GB, reserved "
          f"{out['peak_reserved_gb']:.2f} GB ({card})", flush=True)
    print("profiles batch chunks (text's first 60 characters, speaker, "
          "start, end)", json.dumps([(t[:60], *rest) for t, *rest in
                                     batch["rows"]]), flush=True)
    print("profiles top 5 a query (first 60 characters)", json.dumps(
        [[t[:60] for t in top] for top in batch["tops"]]), flush=True)
    if not batch["rows"] or any(not res.num_chunks
                                for res in batch["results"]):
        fail(f"profiles: a file stored no chunk: {batch['rows']}")
    if not all(r[0].startswith("[Context: ") for r in batch["rows"]):
        fail("profiles: a chunk of the batch has no header")
    if batch["rows"] != loop["rows"]:
        fail("profiles: the staged batch's chunks differ from the per-file "
             f"loop's: {batch['rows']} against {loop['rows']}")
    if batch["tops"] != loop["tops"]:
        fail(f"profiles: the top 5 differ: {batch['tops']} against "
             f"{loop['tops']}")
    want_n = min(5, len(batch["rows"]))
    if not all(len(t) == want_n for t in batch["tops"]):
        fail(f"profiles: a query returned other than {want_n} hits: "
             f"{batch['tops']}")
    for tag, run in (("batch", batch), ("loop", loop)):
        n = run["launches"]
        if not (n[FLASH] and n[FLASH] == n[WGMMA] and n[Q8W] and n[CROSS8]):
            fail(f"profiles[{tag}]: rows 1-3 did not all launch, or a flash "
                 f"call missed wgmma: {n}")
        idle = {k: n[k] for k in (CROSS4, Q4W, SELF8, REORDER) if n[k]}
        if idle:
            fail(f"profiles[{tag}]: kernels off this path launched: {idle}")
        if not (run["q8w_widths"].get(WHISPER_DIN)
                and run["q8w_widths"].get(LLAMA_DIN)):
            fail(f"profiles[{tag}]: matmul_q8w did not run at both "
                 f"Whisper's and 3b's shapes: {run['q8w_widths']}")
        if any(run["plain_calls"].values()):
            fail(f"profiles[{tag}]: plain versions were called: "
                 f"{run['plain_calls']}")
    if out["checkpoints"] != ["aligned", "contextualized"]:
        fail(f"profiles: checkpoints fired {out['checkpoints']}")
    if out["resumed"]["rows"] != out["first_file_rows"]:
        fail("profiles: the resumed ingest's chunks differ from the first "
             f"run's: {out['resumed']['rows']} against "
             f"{out['first_file_rows']}")
    if "transcribe" in out["resumed"]["stage_timings"]:
        fail("profiles: the resumed ingest transcribed again")
    st = out["status"]
    if st["collections"] != out["counts"] or out["counts"]["batch"] != sum(
            r.num_chunks for r in batch["results"]):
        fail(f"profiles: status() counts {st['collections']} against "
             f"{out['counts']}")
    n_ingests = st["stage_timings"].get("IngestionPipeline.ingest", {}).get(
        "count")
    if n_ingests != PROFILE_FILES + 1:
        fail(f"profiles: status() counted {n_ingests} ingests, expected "
             f"{PROFILE_FILES + 1}")
    missing = [s for s in PROFILE_SPANS if s not in st["traces"]]
    if missing:
        fail(f"profiles: status() traces lack {missing}")
    if any(ok is not True or n for ok, n in out["cleared"].values()):
        fail(f"profiles: clear_collection left {out['cleared']}")
    for key in ("engine", "resources"):
        if not st[key].get("models"):
            fail(f"profiles: status()[{key!r}] books no model: {st[key]}")
    print(f"profiles status {json.dumps({k: st[k] for k in ('config', 'engine', 'resources', 'collections')})}",
          flush=True)
    print(f"profiles_s {time.perf_counter() - t0:.1f}", flush=True)
    return {"launches": {"profiles[batch]": batch["launches"],
                         "profiles[loop]": loop["launches"]},
            "rag": out["rag"], "files": out["files"], "batch": batch}


# -- queue: the job queue drains profiles' files -----------------------------------------

QUEUE_PRIORITIES = ("LOW", "NORMAL", "HIGH")  # profiles' files, in order


def rows_by_source(rag, collection: str) -> dict:
    """A collection's chunks (text, speaker, start, end) by source file."""
    out: dict = {}
    for p in rag.store._coll(collection).payloads:
        out.setdefault(p["metadata"]["source"], []).append(
            (p["text"], p["speaker"], round(float(p["start"]), 3),
             round(float(p["end"]), 3)))
    return out


def run_queue(torch, K, device: str, rag, files: list[str],
              workdir: Path) -> dict:
    """The queue phase's work on profiles' pipeline and files:
    configs/queue.yaml through the port's reader (the database in
    ``workdir``); the three files enqueued with validation at priorities
    low, normal and high into collection "queue"; one job sent twice
    under one idempotency key; one extra job cancelled; the drain by
    ``GPUWorker(...).start(max_jobs=3)`` with heartbeats; then a job
    claimed by a worker without heartbeats, requeued by the reaper.
    Returns what it measured."""
    from audio_rag_tpu_torch.jobqueue import (
        AudioRAGQueue, IngestJob, JobStatus)
    from audio_rag_tpu_torch.jobqueue.config import load_queue_config
    from audio_rag_tpu_torch.jobqueue.exceptions import DuplicateJobError
    from audio_rag_tpu_torch.jobqueue.store import JobStore
    from audio_rag_tpu_torch.jobqueue.worker import GPUWorker
    from audio_rag_tpu_torch.resources.manager import get_resource_manager

    cfg = load_queue_config(ROOT / "configs" / "queue.yaml")
    cfg.storage.db_path = str(workdir / "queue.db")
    store = JobStore(cfg.storage.db_path)
    queue = AudioRAGQueue(cfg, store=store)
    out: dict = {"batch_claim": cfg.worker.batch_claim}
    jids = [queue.enqueue(IngestJob(f"tenant-{i}", f, priority=prio,
                                    collection="queue"))
            for i, (f, prio) in enumerate(zip(files, QUEUE_PRIORITIES))]
    try:
        queue.enqueue(IngestJob("tenant-0", files[0], priority="HIGH",
                                collection="queue"))
        out["duplicate"] = "accepted"
    except DuplicateJobError as exc:
        out["duplicate"] = exc.existing_job_id
    extra = queue.enqueue(IngestJob("tenant-extra", files[1],
                                    collection="queue"))
    queue.cancel(extra)

    claims, beats, batches = [], [], []
    claim, beat = store.claim_next, store.heartbeat

    def claim_spy(wid, queues=None):
        job = claim(wid, queues)
        if job is not None:
            claims.append(job.job_id)
        return job

    def beat_spy(wid, info):
        beat(wid, info)
        beats.append(store.live_workers(cfg.worker.heartbeat_ttl_s)[wid])

    ingest_batch = rag.ingestion.ingest_batch

    def batch_spy(audios, *a, **kw):
        batches.append(list(audios))
        return ingest_batch(audios, *a, **kw)

    store.claim_next, store.heartbeat = claim_spy, beat_spy
    rag.ingestion.ingest_batch = batch_spy
    rm = get_resource_manager()
    n0 = len(rm.events)
    K.reset_launches()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    worker = GPUWorker(cfg, store, rag_factory=lambda: rag)
    try:
        with plain_calls(K, K.KERNELS) as plain:
            t0 = time.perf_counter()
            worker.start(max_jobs=3)
            sync(torch, device)
            out["drain_s"] = time.perf_counter() - t0
    finally:
        store.claim_next, store.heartbeat = claim, beat
        del rag.ingestion.ingest_batch
    out.update({
        "launches": launch_counts(K), "plain_calls": dict(plain),
        "events": ledger_events(rm, n0), "claims": claims,
        "jids": jids, "extra": extra, "beats": beats, "batches": batches,
        "files": files, "jobs_processed": worker.jobs_processed,
        "statuses": {j: queue.get_status(j) for j in [*jids, extra]},
        "results": {j: queue.get_result(j) for j in [*jids, extra]},
        "rows": rows_by_source(rag, "queue"),
        "resources": rag.status()["resources"],
        "live_after": store.live_workers()})
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    # the reaper: a job claimed by a worker that never beat goes back
    stale = queue.enqueue(IngestJob("tenant-stale", files[2],
                                    collection="queue"))
    store.claim_next("worker-without-heartbeats")
    out["requeued"] = store.requeue_stale(cfg.worker.heartbeat_ttl_s)
    out["stale"] = stale
    out["stale_status"] = queue.get_status(stale)["status"]
    queue.cancel(stale)
    store.close()
    rag.clear_collection("queue")
    out["statuses"] = {j: {k: st[k] for k in ("status", "stage", "queue")}
                       for j, st in out["statuses"].items()}
    out["done"] = JobStatus.COMPLETED.value
    return out


def phase_queue(torch, K, prof: dict, workdir: Path,
                device: str = "cuda") -> dict:
    """(14) The job queue on profiles' pipeline and files
    (:func:`run_queue`): the three jobs complete, claimed high first, as
    one stage-grouped batch; the cancelled one never runs; the stored
    chunks are profiles' batch's; the heartbeat row carries the card's
    memory; each eviction frees at least 90 % of the evicted model's
    recorded bytes; rows 1-3 launch and no plain version runs; the reaper
    requeues a job claimed by a worker without heartbeats. Returns
    launches by path. ``device="cpu"`` rehearses it (on the output of
    :func:`run_profiles` on the CPU; no kernel check there)."""
    t0 = time.perf_counter()
    out = run_queue(torch, K, device, prof["rag"], prof["files"], workdir)
    card = card_line() if device == "cuda" else "cpu"
    batch = prof["batch"]
    jids, files = out["jids"], out["files"]
    print(f"queue drain_s {out['drain_s']:.3f} beside profiles' batch "
          f"{batch['wall_s']:.3f} s "
          f"({out['drain_s'] / batch['wall_s']:.3f}x); batch_claim "
          f"{out['batch_claim']}, jobs {out['jobs_processed']}; peak "
          f"allocated {out.get('peak_mem_gb', 0):.2f} GB, reserved "
          f"{out.get('peak_reserved_gb', 0):.2f} GB ({card})", flush=True)
    print_ledger("queue", out["events"], card)
    print(f"queue launches {json.dumps(out['launches'])} ({card})",
          flush=True)
    print(f"queue resources {json.dumps(out['resources'])}", flush=True)
    print(f"queue heartbeats {json.dumps(out['beats'])}", flush=True)
    for j, f in zip(jids, files):
        res = out["results"][j]
        print(f"queue job {QUEUE_PRIORITIES[jids.index(j)]} "
              f"{out['statuses'][j]} chunks "
              f"{res.num_chunks if res else None} stage s "
              f"{json.dumps(res.metrics if res else None)}", flush=True)
    if out["duplicate"] != jids[0]:
        fail(f"queue: the second enqueue under one idempotency key gave "
             f"{out['duplicate']}, not DuplicateJobError for {jids[0]}")
    if out["claims"] != [jids[2], jids[1], jids[0]]:
        fail(f"queue: claims {out['claims']}, not high → normal → low "
             f"{jids[::-1]}")
    if out["batches"] != [[files[2], files[1], files[0]]]:
        fail(f"queue: not one stage-grouped batch of the three: "
             f"{out['batches']}")
    for j in jids:
        st, res = out["statuses"][j], out["results"][j]
        if st["status"] != out["done"] or res is None \
                or res.status.value != out["done"] or not res.num_chunks \
                or "contextualize" not in res.metrics:
            fail(f"queue: job {j} ended {st} with {res}")
    if out["statuses"][out["extra"]]["status"] != "cancelled" or \
            out["results"][out["extra"]] is not None:
        fail(f"queue: the cancelled job ran or left the state "
             f"{out['statuses'][out['extra']]}")
    want = dict(zip(files, [[] for _ in files]))
    for (text, speaker, start, end), res in zip(
            batch["rows"], [r for r in batch["results"]
                            for _ in range(r.num_chunks)]):
        want[res.source].append((text, speaker, start, end))
    if out["rows"] != want:
        fail(f"queue: the stored chunks differ from profiles' batch: "
             f"{out['rows']} against {want}")
    if not out["beats"] or not all(
            b.get("platform") == device and (
                device == "cpu" or (b.get("bytes_in_use") or 0) > 0)
            for b in out["beats"]):
        fail(f"queue: a heartbeat row lacks the card's memory: "
             f"{out['beats']}")
    if out["live_after"]:
        fail(f"queue: workers left registered: {out['live_after']}")
    check_evictions("queue", out["events"])
    n = out["launches"]
    if device == "cuda":  # on the CPU the wrappers run the plain versions
        if not (n[FLASH] and n[FLASH] == n[WGMMA] and n[Q8W]
                and n[CROSS8]):
            fail(f"queue: rows 1-3 did not all launch, or a flash call "
                 f"missed wgmma: {n}")
        idle = {k: n[k] for k in (CROSS4, Q4W, SELF8, REORDER) if n[k]}
        if idle:
            fail(f"queue: kernels off this path launched: {idle}")
        if any(out["plain_calls"].values()):
            fail(f"queue: plain versions were called: {out['plain_calls']}")
    if out["requeued"] != [out["stale"]] or out["stale_status"] != "queued":
        fail(f"queue: requeue_stale gave {out['requeued']} "
             f"({out['stale_status']}), not [{out['stale']}]")
    print(f"queue_s {time.perf_counter() - t0:.1f}", flush=True)
    return {"queue": n}


# -- api: the HTTP/WebSocket server on profiles' pipeline ---------------------------------

API_KEY = {"x-api-key": "dev-key-basic"}
API_QUERIES = PROFILE_QUERIES + ["model data window", "signal noise speech",
                                 "weight update step", "meeting lecture rank",
                                 "vector fusion chunk"]
API_STREAM_S = 12  # seconds of the uploaded file streamed over the WebSocket
API_ROUTES = ("/health/ready", "/api/v1/query", "/api/v1/ingest",
              "/api/v1/jobs/{job_id}", "/api/v1/status",
              "/api/v1/streaming/status")


def api_clients():
    """The standard-library clients the tests use (``tests/
    torch_api_client.py``)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_api_client

    return torch_api_client


def stream_over_ws(C, port: int, frames: list[bytes]) -> dict:
    """One WebSocket session: ``frames`` sent back to back, then "stop";
    every message with the seconds it arrived, and each frame's send time."""
    sent, msgs = [], []
    with C.WSClient(port, "/api/v1/ws/transcribe", headers=API_KEY) as ws:
        first = ws.recv_json()
        for f in frames:
            ws.send_bytes(f)
            sent.append(time.perf_counter())
        ws.send_json({"command": "stop"})
        sent.append(time.perf_counter())
        while not msgs or msgs[-1][1].get("status") != "stopped":
            msg = ws.recv_json()
            msgs.append((time.perf_counter(), msg))
    return {"first": first, "sent": sent, "msgs": msgs}


def reference_stream(rag, frames: list[bytes], device: str) -> list:
    """The route's session in process: a ``StreamingASR`` over a
    ``StreamingMux`` on a Whisper backend built from the pipeline's
    config as the route builds it; (text, start, end) a transcript. The
    mux is marked warm once its backend is loaded (the reference's times
    are not reported)."""
    import asyncio
    import dataclasses

    from audio_rag_tpu_torch.asr.mux import StreamingMux
    from audio_rag_tpu_torch.asr.streaming import StreamingASR
    from audio_rag_tpu_torch.asr.whisper import WhisperASR

    cfg = rag.config
    asr_cfg = cfg.asr
    if asr_cfg.max_decode_tokens is None:
        asr_cfg = dataclasses.replace(
            asr_cfg, max_decode_tokens=cfg.streaming.max_decode_tokens)
    backend = WhisperASR(asr_cfg, device=device)
    mux = StreamingMux(backend)
    session = StreamingASR(cfg.asr, cfg.streaming.to_runtime(), mux=mux)

    async def run():
        out = []
        await session.start()
        for f in frames:
            r = await session.add_audio(f)
            if r is not None:
                out.append(r)
        r = await session.stop()
        return out + ([r] if r is not None else [])

    try:
        mux.call(backend.load).result()
        mux.warmed = True
        session.load()
        loop = asyncio.new_event_loop()
        try:
            results = loop.run_until_complete(run())
        finally:
            loop.close()
    finally:
        mux.stop()
        session.unload()
        backend.unload()
    return [(r.text, r.start, r.end) for r in results]


def run_api(torch, K, device: str, rag, files: list[str], workdir: Path,
            card: str = "cpu") -> dict:
    """The api phase's work on profiles' pipeline: ``create_app`` with the
    inline worker on 127.0.0.1 at a port the OS picks, driven by
    standard-library clients: (a) probes, (b) an upload drained by the
    inline worker, (c) eight concurrent search-only queries, (d) an
    answer, (e) a WebSocket session, (f) ``/metrics`` and ``/api/v1/
    status``; the kernel launches of (a)-(f). Then the server, its
    executor, the mux, the inline worker and the coalescer stop, and the
    in-process references run: ``query_batch``, single queries, the
    answer and the session. Returns what it measured."""
    import threading

    from audio_rag_tpu_torch.api import create_app
    from audio_rag_tpu_torch.api.config import APIConfig
    from audio_rag_tpu_torch.audio.io import decode_audio
    from audio_rag_tpu_torch.resources.manager import get_resource_manager

    C = api_clients()
    out: dict = {}
    rm = get_resource_manager()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with plain_calls(K, K.KERNELS) as plain:
        t_phase = time.perf_counter()
        app = create_app(APIConfig(upload_dir=str(workdir / "uploads"),
                                   queue_db_path=str(workdir / "api.db"),
                                   inline_worker=True), rag=rag)
        served = C.Served(app)
        port = served.port
        try:
            # (a)
            out["ready"] = C.request_json(port, "GET", "/health/ready")[:3:2]
            out["no_key"] = C.request_json(port, "POST", "/api/v1/query",
                                           {"query": "x"})[0]
            out["empty"] = C.request_json(port, "POST", "/api/v1/query",
                                          {"query": ""}, API_KEY)[0]
            # (b)
            n0 = len(rm.events)
            body, ctype = C.multipart(
                {"priority": "high", "collection": "api"},
                [("file", "talk0.wav", Path(files[0]).read_bytes(),
                  "audio/wav")])
            t0 = time.perf_counter()
            status, _, up = C.request_json(
                port, "POST", "/api/v1/ingest",
                headers={**API_KEY, "content-type": ctype}, raw=body)
            out["upload"] = (status, up)
            st = None
            while status == 202 and time.perf_counter() - t0 < 180:
                st = C.request_json(port, "GET",
                                    f"/api/v1/jobs/{up['job_id']}",
                                    headers=API_KEY)[2]
                if st["status"] in ("completed", "failed", "cancelled"):
                    break
                time.sleep(0.25)
            out["upload_s"] = time.perf_counter() - t0
            out["job"] = st
            out["upload_events"] = ledger_events(rm, n0)
            out["rows"] = stored_rows(rag, "api") \
                if rag.store.collection_exists("api") else []
            # (c)
            gate = threading.Barrier(len(API_QUERIES))
            http: dict = {}

            def ask(q):
                gate.wait(timeout=60)
                t = time.perf_counter()
                s, _, b = C.request_json(
                    port, "POST", "/api/v1/query",
                    {"query": q, "collection": "api"}, API_KEY)
                http[q] = (s, b, (time.perf_counter() - t) * 1e3)

            threads = [threading.Thread(target=ask, args=(q,))
                       for q in API_QUERIES]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            out["http_queries"] = http
            c = app.state.get("query_coalescer")
            out["coalescer"] = (c.requests_served, c.batches_run) if c \
                else (0, 0)
            # (d)
            t = time.perf_counter()
            out["http_answer"] = C.request_json(
                port, "POST", "/api/v1/query",
                {"query": PROFILE_QUERIES[0], "collection": "api",
                 "generate_answer": True}, API_KEY)[::2]
            out["http_answer_ms"] = (time.perf_counter() - t) * 1e3
            # (e)
            audio, _ = decode_audio(files[0])
            frames = C.pcm_frames(audio[:API_STREAM_S * 16000])
            out["frames"] = frames
            out["ws"] = stream_over_ws(C, port, frames)
            out["ws_status"] = C.request_json(
                port, "GET", "/api/v1/streaming/status", headers=API_KEY)[2]
            # (f)
            out["status"] = C.request_json(port, "GET", "/api/v1/status",
                                           headers=API_KEY)[::2]
            s, _, text = C.request(port, "GET", "/metrics")
            out["metrics_status"] = s
            out["metrics"] = C.parse_metrics(text.decode())
            sync(torch, device)
            out["api_s"] = time.perf_counter() - t_phase
            out["launches"] = launch_counts(K)
        finally:
            served.stop()
            app.state["executor"].shutdown(wait=True)
            for t in threading.enumerate():
                if t.name == "inline-worker":
                    t.join(timeout=60)
        out["plain_calls"] = dict(plain)
    mux = app.state.get("streaming_mux")
    out["threads_left"] = sorted(
        t.name for t in threading.enumerate()
        if t.name in ("inline-worker", "query-coalescer", "asr-mux")
        and t.is_alive())
    if mux is not None:
        mux.backend.unload()  # the route's own Whisper, outside the ledger
    del app, served, mux
    gc.collect()
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    # the in-process references
    batch = rag.query_batch(API_QUERIES, collection="api")
    out["ref_queries"] = {q: [(r.chunk_id, r.score) for r in res.results]
                          for q, res in zip(API_QUERIES, batch)}
    single = []
    for q in API_QUERIES[:5]:
        t = time.perf_counter()
        rag.query(q, collection="api")
        sync(torch, device)
        single.append((time.perf_counter() - t) * 1e3)
    out["single_ms"] = single
    out["ref_answer"] = rag.query(PROFILE_QUERIES[0], collection="api",
                                  generate_answer=True).answer
    out["ref_stream"] = reference_stream(rag, out.pop("frames"), device)
    rag.clear_collection("api")
    out["card"] = card
    return out


def phase_api(torch, K, prof: dict, workdir: Path,
              device: str = "cuda") -> dict:
    """(15) The API on profiles' pipeline (:func:`run_api`): every check
    (a)-(g) fails the run on a mismatch. Returns launches by path.
    ``device="cpu"`` rehearses it (no kernel check there)."""
    import numpy as np

    t0 = time.perf_counter()
    card = card_line() if device == "cuda" else "cpu"
    out = run_api(torch, K, device, prof["rag"], prof["files"], workdir,
                  card)
    # (a)
    if out["ready"][0] != 200 or out["no_key"] != 401 or out["empty"] != 422:
        fail(f"api: /health/ready {out['ready']}, a query without a key "
             f"{out['no_key']}, an empty query {out['empty']}")
    # (b)
    status, up = out["upload"]
    job = out["job"] or {}
    batch = prof["batch"]
    first = batch["results"][0]
    want = [r[0] for r in batch["rows"][: first.num_chunks]]
    print(f"api upload_to_completed_s {out['upload_s']:.3f} (status "
          f"{status}, job {job.get('status')}, chunks "
          f"{(job.get('result') or {}).get('num_chunks')}; profiles' batch "
          f"stage s of that file {json.dumps(first.stage_timings)}, the "
          f"job's {json.dumps((job.get('result') or {}).get('metrics'))}; "
          f"{card})", flush=True)
    print_ledger("api[upload]", out["upload_events"], card)
    if status != 202 or job.get("status") != "completed":
        fail(f"api: the upload answered {status} {up} and ended {job}")
    if [r[0] for r in out["rows"]] != want:
        fail(f"api: the uploaded file's chunks differ from profiles' "
             f"batch: {out['rows']} against {want}")
    check_evictions("api[upload]", out["upload_events"])
    # (c)
    http, ref = out["http_queries"], out["ref_queries"]
    bad = {q: r for q, r in http.items() if r[0] != 200}
    if bad or len(http) != len(API_QUERIES):
        fail(f"api: queries failed: {bad or sorted(http)}")
    exact = sum([r["chunk_id"] for r in http[q][1]["results"]]
                == [i for i, _ in ref[q]] for q in API_QUERIES)
    for q in API_QUERIES:
        got = [(r["chunk_id"], r["score"]) for r in http[q][1]["results"]]
        if not same_ranking(got, ref[q]):
            fail(f"api: {q!r} over HTTP ranked {got}, in process {ref[q]}")
    served, batches = out["coalescer"]
    ms = sorted(r[2] for r in http.values())
    print(f"api queries: {exact} of {len(API_QUERIES)} rankings equal to "
          f"query_batch's, the rest within near-ties; coalescer "
          f"{served} served in {batches} batches; HTTP p50 "
          f"{ms[len(ms) // 2]:.1f} ms (max {ms[-1]:.1f}) against "
          f"{float(np.median(out['single_ms'])):.1f} ms a single query in "
          f"process ({card})", flush=True)
    if served < len(API_QUERIES) or batches >= len(API_QUERIES):
        fail(f"api: the coalescer served {served} in {batches} batches")
    # (d)
    status, body = out["http_answer"]
    print(f"api answer {out['http_answer_ms']:.1f} ms over HTTP: "
          f"{json.dumps((body or {}).get('answer'))[:120]}", flush=True)
    if status != 200 or body.get("answer") != out["ref_answer"]:
        fail(f"api: the HTTP answer ({status}) {body and body.get('answer')!r}"
             f" is not the in-process {out['ref_answer']!r}")
    # (e)
    ws = out["ws"]
    texts = [(t, m) for t, m in ws["msgs"] if m["type"] == "transcript"]
    got = [(m["text"], m["start"], m["end"]) for _, m in texts]
    lat = []
    for t, m in texts:
        # the frame whose arrival completed the chunk, or the stop
        k = min(int(round(m["end"])), len(ws["sent"])) - 1
        lat.append(round((t - ws["sent"][k if not m["is_final"]
                                          else -1]) * 1e3, 1))
    print(f"api ws: {len(got)} transcripts, dispatch ms "
          f"{[round(m['processing_time_ms'], 1) for _, m in texts]}, "
          f"submit-to-transcript ms {lat}, chunks_served "
          f"{out['ws_status'].get('chunks_served')} in "
          f"{out['ws_status'].get('batches_run')} batches ({card})",
          flush=True)
    print(f"api ws transcripts {json.dumps(got)}", flush=True)
    if ws["first"] != {"type": "status", "status": "listening"} or not got:
        fail(f"api: the WebSocket session gave {ws['first']}, {got}")
    if got != out["ref_stream"]:
        fail(f"api: the WebSocket transcripts {got} differ from the "
             f"in-process session's {out['ref_stream']}")
    # (f)
    m = out["metrics"]
    routes = {dict(lbl).get("route") for name, lbl in m
              if name == "audio_rag_requests_total"}
    status, st = out["status"]
    engine = (st or {}).get("engine", {}).get("device", {})
    print(f"api metrics: {len(m)} series, routes {sorted(routes)}, "
          f"hbm budget {m.get(('audio_rag_hbm_budget_gb', ()))} GB, engine "
          f"{m.get(('audio_rag_engine_hbm_gb', ()))} GB; status engine "
          f"{json.dumps(engine)}", flush=True)
    if out["metrics_status"] != 200 or set(API_ROUTES) - routes:
        fail(f"api: /metrics {out['metrics_status']} lacks routes "
             f"{set(API_ROUTES) - routes}")
    if m.get(("audio_rag_hbm_budget_gb", ())) != 14.0 or \
            ("audio_rag_engine_hbm_gb", ()) not in m:
        fail("api: /metrics lacks the 14 GB budget or the engine gauge")
    if device == "cuda" and (status != 200 or engine.get("name")
                             != torch.cuda.get_device_name(0)):
        fail(f"api: /api/v1/status names the engine's device {engine}")
    # (g)
    n = out["launches"]
    print(f"api launches {json.dumps(n)}; plain calls "
          f"{json.dumps(out['plain_calls'])}; peak allocated "
          f"{out.get('peak_mem_gb', 0):.2f} GB, reserved "
          f"{out.get('peak_reserved_gb', 0):.2f} GB ({card})", flush=True)
    if out["threads_left"]:
        fail(f"api: threads left running: {out['threads_left']}")
    if device == "cuda":
        if not (n[FLASH] and n[FLASH] == n[WGMMA] and n[Q8W]
                and n[CROSS8]):
            fail(f"api: rows 1-3 did not all launch, or a flash call "
                 f"missed wgmma: {n}")
        idle = {k: n[k] for k in (CROSS4, Q4W, SELF8, REORDER) if n[k]}
        if idle:
            fail(f"api: kernels off this path launched: {idle}")
        if any(out["plain_calls"].values()):
            fail(f"api: plain versions were called: {out['plain_calls']}")
    print(f"api_s {time.perf_counter() - t0:.1f} (the server's part "
          f"{out['api_s']:.1f})", flush=True)
    return {"api": n}


# -- eval: the quality numbers ---------------------------------------------------------

EVAL_N = 64  # the WER harness's charvoice utterances (default_rng(777))
EVAL_SAMPLES = 12  # the RAG evaluator's samples: 4 each of three query types
EVAL_WORKERS = 3  # CPU reference processes, 2 torch threads each
EVAL_CHUNK = 8  # utterances a CPU reference task transcribes
TTS_MEL_MAX, TTS_MEL_MEAN = 0.0625, 2e-3  # the CPU tests' bounds to JAX
TTS_AUDIO_MAX, TTS_AUDIO_CORR = 1e-3, 0.99999  # the vocoder on one mel
METRIC_TOL = 1e-4  # a quality metric, card against CPU
RECORDS = ROOT / "docs" / "bench_runs"  # the JAX package's CPU records
EVAL_KERNELS = (FLASH, Q8W, CROSS8)

_EVAL_STATE: dict = {}  # a CPU reference process's models and sets


def eval_worker_init() -> None:
    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT))


def eval_generator_config():
    """The judge and answer generator of ``eval``: the trained eval-small
    LLM, greedy, unscheduled, int8 decode weights, 64 new tokens."""
    from audio_rag_tpu_torch.config import GenerationConfig

    return GenerationConfig(model="eval-small", temperature=0.0,
                            decoder_int8=True, use_scheduler=False,
                            speculative_k=0, max_tokens=ANSWER_TOKENS)


def tts_mels(tts, text: str) -> list:
    """``text``'s batches through the TTS model, as ``synthesize`` runs
    them: mel, frame mask, log-durations and durations (numpy)."""
    import torch

    from audio_rag_tpu_torch.models.tts import apply_tts, predict_durations

    tts.load()
    out = []
    for dims, toks in tts.segment_batches(text):
        t = torch.from_numpy(toks).to(tts.device)
        mel, valid, log_dur = apply_tts(tts._params, dims, t)
        dur = predict_durations(dims, log_dur, t)
        out.append({k: v.cpu().numpy() for k, v in (
            ("mel", mel), ("valid", valid), ("log_dur", log_dur),
            ("dur", dur))})
    return out


def eval_cpu(task: tuple):
    """One CPU reference task of ``eval``, in a worker process: ("wer",
    profile, set, n, lo, hi) → hypotheses (of ``make_sets(n)``); ("tts", text) → ``tts_mels``;
    ("vocode", mel) → audio; ("sweep",) → the text sweep; ("judge", texts,
    max_tokens) → greedy token ids."""
    import torch

    from audio_rag_tpu_torch.evaluation import wer_sets

    st = _EVAL_STATE
    kind, *args = task
    if kind == "wer":
        profile, which, n, lo, hi = args
        if n not in st:
            st[n] = wer_sets.make_sets(n)
        if profile not in st:
            st[profile] = wer_sets.tiny_asr(profile, "cpu")
        sets = st[n]
        wavs = sets.wavs if which == "charvoice" else sets.stream_wavs
        return wer_sets.transcribe_all(st[profile], wavs[lo:hi])
    if kind == "tts":
        if "tts" not in st:
            st["tts"] = eval_tts("cpu")
        return tts_mels(st["tts"], args[0])
    if kind == "vocode":
        from audio_rag_tpu_torch.models.tts import mel_to_audio

        return mel_to_audio(torch.from_numpy(args[0])).numpy()
    if kind == "sweep":
        from audio_rag_tpu_torch.evaluation.quality import run_quality_sweep

        return run_quality_sweep(device="cpu")
    if kind == "judge":
        from audio_rag_tpu_torch.generation.llm import LLMGenerator

        if "gen" not in st:
            st["gen"] = LLMGenerator(eval_generator_config(), device="cpu")
        texts, max_tokens = args
        st["gen"].generate_batch(texts, max_tokens=max_tokens,
                                 temperature=0.0)
        return st["gen"].last_token_ids
    raise ValueError(kind)


def eval_tts(device: str):
    from audio_rag_tpu_torch.config import TTSConfig
    from audio_rag_tpu_torch.tts.neural import NeuralTTS

    tts = NeuralTTS(TTSConfig(backend="jax"), device=device)
    tts.load()
    return tts


def record(name: str) -> dict:
    return json.loads((RECORDS / name).read_text())


def sweep_gaps(got: dict, ref: dict) -> list:
    """(config, type, metric, got, ref) where two sweeps differ by more
    than ``METRIC_TOL``."""
    out = []
    for cfg in ref:
        for t in [None, *ref[cfg]["by_type"]]:
            g = got[cfg] if t is None else got[cfg]["by_type"].get(t, {})
            w = ref[cfg] if t is None else ref[cfg]["by_type"][t]
            for m in ("p_at_5", "mrr", "ndcg", "hit_rate"):
                if abs(g.get(m, -1.0) - w[m]) > METRIC_TOL:
                    out.append((cfg, t, m, g.get(m), w[m]))
    return out


def ladder_orderings(s: dict) -> list[str]:
    """The separation orderings of
    ``tests/unit/evaluation/test_quality_separation.py`` that ``s``
    breaks."""
    eps = 1e-9
    bt = {c: s[c]["by_type"] for c in s}
    checks = {
        "hybrid mrr > dense + 0.10":
            s["hybrid"]["mrr"] > s["dense"]["mrr"] + 0.10,
        "hybrid tag mrr >= 0.5": bt["hybrid"]["tag"]["mrr"] >= 0.5 - eps,
        "dense tag mrr <= 0.2": bt["dense"]["tag"]["mrr"] <= 0.2 + eps,
        "dense paraphrase mrr >= 0.6":
            bt["dense"]["paraphrase"]["mrr"] >= 0.6 - eps,
        "sparse paraphrase mrr <= 0.3":
            bt["sparse"]["paraphrase"]["mrr"] <= 0.3 + eps,
        "rerank pair ndcg >= hybrid's": bt["hybrid+rerank"]["pair"]["ndcg"]
        >= bt["hybrid"]["pair"]["ndcg"] - eps,
        "rerank pair mrr > hybrid's + 0.05": bt["hybrid+rerank"]["pair"][
            "mrr"] > bt["hybrid"]["pair"]["mrr"] + 0.05,
        "context p@5 > hybrid's + 0.05": bt["hybrid+context"]["context"][
            "p_at_5"] > bt["hybrid"]["context"]["p_at_5"] + 0.05,
        "prf mismatch p@5 > context's + 0.10": bt["hybrid+context+prf"][
            "mismatch"]["p_at_5"] > bt["hybrid+context"]["mismatch"][
            "p_at_5"] + 0.10,
    }
    for t in ("paraphrase", "tag", "pair"):
        checks[f"context keeps {t} p@5"] = bt["hybrid+context"][t][
            "p_at_5"] >= bt["hybrid"][t]["p_at_5"] - 0.05 - eps
        checks[f"prf keeps {t} p@5"] = bt["hybrid+context+prf"][t][
            "p_at_5"] >= bt["hybrid+context"][t]["p_at_5"] - 0.05 - eps
    ladder = [s[c]["p_at_5"] for c in ("dense", "hybrid", "hybrid+context",
                                       "hybrid+context+prf")]
    checks["ladder monotone"] = all(b >= a - eps
                                    for a, b in zip(ladder, ladder[1:]))
    checks["not saturated"] = all(s[c]["p_at_5"] < 0.95
                                  for c in ("dense", "sparse", "hybrid"))
    checks["configs differ"] = len({round(s[c]["mrr"], 4) for c in (
        "dense", "sparse", "hybrid", "hybrid+rerank")}) >= 3
    return [name for name, ok in checks.items() if not ok]


def eval_rag(device: str, samples: int):
    """``AudioRAG`` with the eval-small stack on ``device`` (the generator
    of :func:`eval_generator_config`), the extended corpus's 272 chunks
    loaded through ``ingest_segments`` (one chunk a segment), and
    ``samples`` samples of its eval set (the first paraphrase, tag and pair
    questions in turn)."""
    from audio_rag_tpu_torch.config import (
        AudioRAGConfig,
        ChunkingConfig,
        EmbeddingConfig,
        RerankingConfig,
    )
    from audio_rag_tpu_torch.core.types import TranscriptSegment
    from audio_rag_tpu_torch.evaluation import EvalDataset
    from audio_rag_tpu_torch.evaluation.corpus import (
        extend_corpus,
        make_corpus,
    )
    from audio_rag_tpu_torch.pipeline import AudioRAG

    corpus = extend_corpus(make_corpus())
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        reranking=RerankingConfig(model="eval-small"),
        generation=eval_generator_config(),
        chunking=ChunkingConfig(min_chunk_tokens=1, overlap_tokens=0),
        device=device))
    rag.ingestion.ingest_segments([
        TranscriptSegment(text=t, start=30.0 * i, end=30.0 * (i + 1),
                          speaker=f"SPEAKER_{i % 2:02d}")
        for i, t in enumerate(corpus.chunks)])
    by_type = {t: [s for s in corpus.eval_set
                   if s.metadata["type"] == t]
               for t in ("paraphrase", "tag", "pair")}
    picked = [by_type[t][i] for i in range(-(-samples // len(by_type)))
              for t in by_type][:samples]
    return rag, EvalDataset("corpus-eval-12", picked), len(corpus.chunks)


def spy_generator(gen) -> list:
    """Record each ``generate_batch`` call of ``gen``: (texts as encoded,
    temperature, max_tokens, token ids)."""
    calls = []
    orig = gen.generate_batch

    def spy(prompts, system=None, max_tokens=None, temperature=None):
        res = orig(prompts, system=system, max_tokens=max_tokens,
                   temperature=temperature)
        texts = [f"{system}\n\n{p}" if system else p for p in prompts]
        temp = gen.config.temperature if temperature is None else temperature
        calls.append((texts, temp, max_tokens or gen.config.max_tokens,
                      list(gen.last_token_ids)))
        return res

    gen.generate_batch = spy
    return calls


def phase_eval(torch, K, device: str = "cuda", n: int = EVAL_N,
               samples: int = EVAL_SAMPLES) -> dict:
    """(14) evaluation and speech output on the card, against the port's
    CPU path in ``EVAL_WORKERS`` processes of their own: (a) the WER
    harness's sets, (b) the TTS set, (c) the quality ladders, (d) the RAG
    evaluator's quartet, (e) spoken answers. ``device="cpu"`` with small
    ``n`` and ``samples`` rehearses it. Returns launches by path."""
    import multiprocessing

    import numpy as np

    from audio_rag_tpu_torch.evaluation import RAGEvaluator, wer_sets
    from audio_rag_tpu_torch.evaluation.quality import (
        build_eval_setup_audio,
        run_quality_sweep,
    )

    t0 = time.perf_counter()
    card = card_line()
    on_card = device == "cuda"
    sets = wer_sets.make_sets(n)
    tts_set = wer_sets.tts_texts(sets)
    by_path: dict[str, dict] = {}
    pool = multiprocessing.get_context("spawn").Pool(
        EVAL_WORKERS, initializer=eval_worker_init)
    try:
        # the CPU references that need nothing of the card's, queued first
        cpu_wer = {(p, w): [pool.apply_async(eval_cpu, ((
            "wer", p, w, n, lo, min(lo + EVAL_CHUNK, hi)),))
            for lo in range(0, hi, EVAL_CHUNK)]
            for p, w, hi in (("f32", "charvoice", n), ("int8", "charvoice", n),
                             ("f32", "stream", len(sets.stream_wavs)))}
        cpu_tts = [pool.apply_async(eval_cpu, (("tts", t),)) for t in tts_set]
        cpu_sweep = pool.apply_async(eval_cpu, (("sweep",),))

        def path(name: str, fn):
            K.reset_launches()
            out = fn()
            by_path[name] = launch_counts(K)
            return out

        with plain_calls(K, EVAL_KERNELS) as plain:
            # (a) the WER sets, f32 (the record's) and int8
            hyps, wall = {}, {}
            for profile in ("f32", "int8"):
                asr = wer_sets.tiny_asr(profile, device)
                t1 = time.perf_counter()
                hyps[(profile, "charvoice")] = path(
                    f"eval[wer {profile}]",
                    lambda: wer_sets.transcribe_all(asr, sets.wavs))
                wall[profile] = time.perf_counter() - t1
                if profile == "f32":
                    hyps[("f32", "stream")] = path(
                        "eval[wer f32 multi-window]",
                        lambda: wer_sets.transcribe_all(asr,
                                                        sets.stream_wavs))
                    f32_asr = asr
            print(f"eval[wer] card s: f32 {wall['f32']:.1f}, int8 "
                  f"{wall['int8']:.1f}", flush=True)
            # (b) the TTS set: synthesized, then transcribed
            tts = eval_tts(device)
            t1 = time.perf_counter()
            pcm = path("eval[tts]", lambda: [tts._synthesize_pcm(t)
                                             for t in tts_set])
            tts_s = time.perf_counter() - t1
            tts_hyps = path("eval[wer tts-rendered]",
                            lambda: wer_sets.transcribe_all(f32_asr, pcm))
            card_mels = [tts_mels(tts, t) for t in tts_set]
            same_bits = (tts.synthesize(tts_set[0])
                         == tts.synthesize(tts_set[0]))
            # (c) the text sweep and the audio-in ladder
            text_sweep = path("eval[sweep]",
                              lambda: run_quality_sweep(device=device))
            t1 = time.perf_counter()
            engines, corpus = path("eval[audio ladder]",
                                   lambda: build_eval_setup_audio(
                                       device=device))
            audio_sweep = run_quality_sweep(engines, corpus.eval_set)
            audio_s = time.perf_counter() - t1
            del engines
            print(f"eval card s so far {time.perf_counter() - t0:.1f}",
                  flush=True)
            # (d) the RAG evaluator over AudioRAG, the quartet judged
            rag, dataset, n_chunks = eval_rag(device, samples)
            calls = spy_generator(rag.generator)
            evaluator = RAGEvaluator(embedder=rag.embedder,
                                     generator=rag.generator, device=device)
            t1 = time.perf_counter()
            results = path("eval[ragas]", lambda: evaluator.evaluate_dataset(
                rag, dataset, search_types=["hybrid"], generate_answers=True,
                compute_ragas=True))
            ragas_s = time.perf_counter() - t1
            summary = evaluator.summarize_results(results)["hybrid"]
            # (e) spoken answers, the neural backend and the null tone
            spoken = {}
            for backend in ("jax", "null"):
                rag.config.tts.backend = backend
                rag.querying.unload()
                spoken[backend] = path(f"eval[speak {backend}]",
                                       lambda: rag.query(
                                           dataset.samples[0].question,
                                           generate_answer=True,
                                           speak_answer=True))
            peak = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                    else 0.0)

        # the CPU's judges on the card's prompts: greedy calls in the
        # workers, sampled ones here (their key hashes the prompts with
        # this process's salt)
        greedy = [c for c in calls if not c[1]]
        cpu_judge = [pool.apply_async(eval_cpu, (("judge", c[0], c[2]),))
                     for c in greedy]
        from audio_rag_tpu_torch.generation.llm import LLMGenerator

        host_gen = LLMGenerator(eval_generator_config(), device="cpu")
        sampled_ref = []
        for texts, temp, max_tokens, _ in (c for c in calls if c[1]):
            host_gen.generate_batch(texts, max_tokens=max_tokens,
                                    temperature=temp)
            sampled_ref.append(host_gen.last_token_ids)
        cpu_audio = [pool.apply_async(eval_cpu, (("vocode", m[0]["mel"]),))
                     for m in card_mels[:2]]
        ref_hyps = {k: sum((r.get() for r in v), []) for k, v in
                    cpu_wer.items()}
        ref_mels = [r.get() for r in cpu_tts]
        ref_sweep = cpu_sweep.get()
        ref_judge = [r.get() for r in cpu_judge]
        ref_audio = [r.get() for r in cpu_audio]
    finally:
        pool.terminate()
        pool.join()

    # (a)
    wer_rec = record("wer_tiny_synth.json")
    for profile in ("f32", "int8"):
        counts, cer_ = wer_sets.wer_stats(sets.texts,
                                          hyps[(profile, "charvoice")])
        print(f"eval[wer {profile}] charvoice WER {counts.wer:.4f} (record "
              f"{wer_rec['value']}, JAX CPU, f32) CER {cer_:.4f} S/D/I "
              f"{counts.substitutions}/{counts.deletions}/"
              f"{counts.insertions} of {counts.n_ref} words, "
              f"{len(sets.texts)} utterances in {wall[profile]:.2f} s "
              f"({card})", flush=True)
    stream, _ = wer_sets.wer_stats(sets.stream_refs,
                                   hyps[("f32", "stream")])
    print(f"eval[wer f32] multi-window WER {stream.wer:.4f} of "
          f"{stream.n_ref} words (record "
          f"{wer_rec['extra']['multi_window_stream']['wer']})", flush=True)
    for key, got in hyps.items():
        if got != ref_hyps[key]:
            bad = [i for i, (a, b) in enumerate(zip(got, ref_hyps[key]))
                   if a != b]
            fail(f"eval[wer {key[0]} {key[1]}]: the card's hypotheses differ "
                 f"from the CPU's at {bad}: {[got[i] for i in bad[:3]]} "
                 f"against {[ref_hyps[key][i] for i in bad[:3]]}")
    print(f"eval[wer] card = CPU hypotheses: f32 {n} + {len(sets.stream_wavs)}"
          f" files, int8 {n}", flush=True)

    # (b)
    t_counts, t_cer = wer_sets.wer_stats(tts_set, tts_hyps)
    frames = sum(int(m[0]["valid"].sum()) for m in card_mels)
    print(f"eval[tts] {len(tts_set)} texts, one segment batch each, in "
          f"{tts_s:.3f} s ({1e3 * tts_s / len(tts_set):.1f} ms a batch, "
          f"{frames * 160 / 16000:.1f} s of speech); TTS-rendered WER "
          f"{t_counts.wer:.4f} (record {wer_rec['extra']['tts_rendered']['wer']}"
          f") CER {t_cer:.4f} of {t_counts.n_ref} words ({card})", flush=True)
    worst, ties = 0.0, 0
    for text, got, ref in zip(tts_set, card_mels, ref_mels):
        for g, r in zip(got, ref):
            parted = np.argwhere(g["dur"] != r["dur"])
            for b, s_ in parted:
                f = float(np.exp(r["log_dur"][b, s_]))
                print(f"eval[tts] duration tie in {text!r} symbol {s_}: "
                      f"CPU exp(log_dur) {f:.5f}, {r['dur'][b, s_]} against "
                      f"{g['dur'][b, s_]}", flush=True)
                if abs(f - np.floor(f) - 0.5) > 2 * f * 2 ** -8:
                    fail(f"eval[tts]: a duration differs from the CPU's away "
                         f"from a half-integer in {text!r}")
                ties += 1
            if not len(parted):
                d = np.abs(g["mel"] - r["mel"])
                worst = max(worst, float(d.max()))
                if d.max() > TTS_MEL_MAX or d.mean() > TTS_MEL_MEAN:
                    fail(f"eval[tts]: mel of {text!r} off the CPU's by "
                         f"{d.max():.4f} (mean {d.mean():.5f})")
    for m, ref in zip(card_mels, ref_audio):
        from audio_rag_tpu_torch.models.tts import mel_to_audio

        got = mel_to_audio(torch.from_numpy(m[0]["mel"]).to(device)).cpu() \
            .numpy()
        for row in range(got.shape[0]):
            k = int(m[0]["valid"][row].sum()) * 160
            gap = float(np.abs(got[row, :k] - ref[row, :k]).max())
            corr = float(np.corrcoef(got[row, :k], ref[row, :k])[0, 1])
            print(f"eval[tts] vocoder on one mel, card against CPU: max "
                  f"|d| {gap:.2e} corr {corr:.8f}", flush=True)
            if gap > TTS_AUDIO_MAX or corr < TTS_AUDIO_CORR:
                fail(f"eval[tts]: the card's vocoder is off the CPU's: "
                     f"{gap} {corr}")
    print(f"eval[tts] mel card against CPU max |d| {worst:.4f}, duration "
          f"ties {ties}; two card runs same bits: {same_bits}", flush=True)
    if not same_bits:
        fail("eval[tts]: two card runs of one text gave other bits")

    # (c)
    gaps = sweep_gaps(text_sweep, ref_sweep)
    if gaps:
        fail(f"eval[sweep]: the card's text sweep differs from the CPU's: "
             f"{gaps[:6]}")
    audio_rec = record("quality_audio_in.json")["sweep"]
    for label, m in audio_sweep.items():
        r = audio_rec[label]
        print(f"eval[audio ladder] {label:>18} P@5 {m['p_at_5']:.4f} MRR "
              f"{m['mrr']:.4f} NDCG {m['ndcg']:.4f} hit {m['hit_rate']:.4f}"
              f" (record P@5 {r['p_at_5']} MRR {r['mrr']} NDCG "
              f"{r['ndcg']})", flush=True)
    print(f"eval[sweep] text sweep card = CPU within {METRIC_TOL}: hybrid "
          f"{json.dumps({k: text_sweep['hybrid'][k] for k in ('p_at_5', 'mrr', 'ndcg')})}"
          f"; audio ladder built in {audio_s:.1f} s", flush=True)
    broken = ladder_orderings(audio_sweep)
    if broken:
        fail(f"eval[audio ladder]: orderings broken: {broken}")

    # (d)
    rag_rec = record("ragas_trained.json")["extra"]["averages"]
    print(f"eval[ragas] {samples} samples over {n_chunks} chunks in "
          f"{ragas_s:.1f} s, {len(calls)} generator calls: "
          + ", ".join(f"{k} {summary.get(k, float('nan')):.4f} (record "
                      f"{rag_rec[k]})" for k in rag_rec)
          + f"; retrieval P@5 {summary['precision_at_k']:.4f} MRR "
          f"{summary['mrr']:.4f} ({card})", flush=True)
    parted = 0
    for (texts, temp, max_tokens, ids), ref in zip(
            greedy + [c for c in calls if c[1]], ref_judge + sampled_ref):
        parted += check_header_calls(torch, "eval[ragas]", rag.generator,
                                     [(texts, ids)], [(texts, ref)], temp,
                                     max_tokens)
    print(f"eval[ragas] the card's judge tokens = the CPU's in "
          f"{len(calls) - parted} of {len(calls)} calls ({len(greedy)} "
          f"greedy), {parted} parted at a near-tie", flush=True)
    if set(summary) < {"faithfulness", "context_recall"}:
        fail(f"eval[ragas]: no quartet: {summary}")

    # (e)
    for backend, out in spoken.items():
        if out.audio is None or out.audio[8:12] != b"WAVE" or int.from_bytes(
                out.audio[24:28], "little") != 22050:
            fail(f"eval[speak {backend}]: no 22,050 Hz WAV")
        print(f"eval[speak {backend}] {len(out.audio)} WAV bytes for a "
              f"{len(out.answer.split())}-word answer, tts "
              f"{out.stage_timings['tts']:.3f} s of "
              f"{out.elapsed_s:.3f} s", flush=True)

    if on_card:
        for name, n_ in by_path.items():
            print(f"{name} launches {json.dumps(n_)}", flush=True)
        expect = {"eval[wer f32]": {FLASH}, "eval[wer int8]": {
            FLASH, Q8W, CROSS8}, "eval[ragas]": {Q8W},
            "eval[audio ladder]": {FLASH}}
        for name, kernels in expect.items():
            check_launches(name, by_path[name], kernels)
        for name in ("eval[tts]", "eval[sweep]"):
            if any(by_path[name].values()):
                fail(f"{name}: kernels launched: {by_path[name]}")
        if any(plain.values()):
            fail(f"eval: plain versions were called on the card: {plain}")
        print(f"eval peak {peak:.2f} GB ({card})", flush=True)
    print(f"eval_s {time.perf_counter() - t0:.1f}", flush=True)
    return by_path


def large_v3_config(device: str, profile: str, window_batch: int,
                    model_size: str = "large-v3", **asr_fields):
    """The large-v3 paths' config: greedy at temperature 0 in English, as
    ``bench.py`` measures it, unless ``asr_fields`` say otherwise (another
    ``model_size`` rehearses a path on the CPU)."""
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, EmbeddingConfig,
        RerankingConfig)

    fields = {"language": "en", "temperature_fallback": False, **asr_fields}
    return AudioRAGConfig(
        asr=ASRConfig(model_size=model_size, compute_type="bfloat16",
                      window_batch_size=window_batch, max_decode_tokens=32,
                      seed=0, vad_filter=False, **fields,
                      **PROFILES[profile][0]),
        embedding=EmbeddingConfig(model="eval-small"),
        reranking=RerankingConfig(backend="none"),
        chunking=ChunkingConfig(min_chunk_tokens=1, overlap_tokens=0),
        device=device)


def long_speech(seconds: float, seed: int = 5):
    """``seconds`` of charvoice speech from a fixed word list."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR, synth_text

    words = ("gradient descent loss spectrogram harmonic attention token "
             "layer model search hybrid window speech audio chunk query "
             "vector dense sparse fusion rank").split()
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    pieces, have = [], 0
    while have < n:
        text = " ".join(rng.choice(words, 8))
        wav = synth_text(text, rng, noise_level=0.005)
        pieces.append(wav)
        have += wav.size
    return np.concatenate(pieces)[:n]


@contextlib.contextmanager
def plain_kernels(K):
    """Route the models' kernel calls to the plain versions (the reference
    path of the logits checks only)."""
    saved = {name: getattr(K, name) for name in K.KERNELS}
    for name in K.KERNELS:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def decode_window(torch, asr, wav, steps: int = 0, tokens=None,
                  cache_len: int = 36):
    """Encode the first window batch, prime the decoder with the prompt as
    the ASR's decode profile does (quantized cross K/V and weights, the
    self cache converted to int8 after priming in the self_kv_int8
    profile), then run ``steps`` greedy steps (feeding ``tokens`` when
    given). Returns the logits after the prompt and after each step, the
    tokens fed, and the decoder state."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import (
        decoder_step, encode, precompute_cross_kv, quantize_self_cache)
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch

    dims, st = asr.dims, asr.tokens
    n = 2 * dims.n_audio_ctx * HOP_LENGTH
    B = asr.config.window_batch_size
    skv8 = asr.config.self_kv_int8
    dev = asr.device
    win = torch.from_numpy(np.ascontiguousarray(
        wav[: B * n].reshape(B, n))).to(dev)
    with torch.inference_mode():
        mel = log_mel_batch(win, n_mels=dims.n_mels)
        enc = encode(asr._params, dims, mel, dtype=asr.dtype)
        ckv = precompute_cross_kv(asr._params, dims, enc, asr.dtype,
                                  quantize=True, bits=asr.cross_kv_bits)
        del enc
        hd = dims.n_text_state // dims.n_text_head
        sk = torch.zeros((dims.n_text_layer, B, dims.n_text_head, cache_len,
                          hd), dtype=asr.dtype, device=dev)
        sv = torch.zeros_like(sk)
        prompt = torch.tensor([[st.sot, st.lang_base, st.transcribe,
                                st.no_timestamps]] * B, device=dev)
        P = prompt.shape[1]
        for t in range(P):
            logits, (sk, sv) = decoder_step(
                asr._params, dims, prompt[:, t:t + 1], ckv, t, (sk, sv),
                dtype=asr.dtype, q8=asr._params_q8)
        out = [logits.float()]
        cache = quantize_self_cache(sk, sv, P) if skv8 else (sk, sv)
        del sk, sv
        fed = []
        for i in range(steps):
            tok = (out[-1].argmax(-1, keepdim=True) if tokens is None
                   else tokens[i])
            fed.append(tok)
            logits, cache = decoder_step(
                asr._params, dims, tok, ckv, P + i, cache, dtype=asr.dtype,
                q8=asr._params_q8, self_kv_int8=skv8)
            out.append(logits.float())
    return out, fed, {"ckv": ckv, "cache": cache, "pos": P + steps}


def check_logits(tag: str, got: list, ref: list) -> None:
    """bf16 activations through 32+32 layers: a one-ulp flip early on
    grows; hold the kernels' logits within 5% of the logits' range."""
    for i, (g, r) in enumerate(zip(got, ref)):
        err = (g - r).abs().max().item()
        scale = r.abs().max().item()
        agree = (g.argmax(-1) == r.argmax(-1)).float().mean().item()
        tol = 0.05 * scale
        what = "first-step" if i == 0 else f"step {i}"
        print(f"{tag} {what} logits max_abs_err {err:.5f} tol {tol:.5f} "
              f"(max|logit| {scale:.4f}) argmax agreement {agree:.3f}",
              flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"{tag}: {what} logits disagree with the plain path")


def trace_steps(torch, step, steps: int = 8, top: int = 6) -> dict:
    """``steps`` calls of ``step`` timed on the host clock, then ``steps``
    more under torch.profiler: device kernel time per step, the device's
    busy share of the traced window, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        host_ms = run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_ms = run()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the weight-quantized matmuls (csrc/wq_matmul.cuh), the decode
    # cross-attention (csrc/decode_cross.cuh) and self-attention
    # (csrc/decode_self_q8.cu): one launch a call each
    mm = [e for e in kernels if "wq_kernel" in e.name]
    xa = [e for e in kernels if "cross_kernel" in e.name]
    sa = [e for e in kernels if "self_q8_kernel" in e.name]
    return {"steps": steps, "decode_ms_per_step": host_ms / steps,
            "wq_matmul_device_ms_per_step": sum(
                e.time_range.elapsed_us() for e in mm) / 1e3 / steps,
            "wq_matmul_launches_per_step": len(mm) / steps,
            "cross_attention_device_ms_per_step": sum(
                e.time_range.elapsed_us() for e in xa) / 1e3 / steps,
            "cross_attention_launches_per_step": len(xa) / steps,
            "self_attention_device_ms_per_step": sum(
                e.time_range.elapsed_us() for e in sa) / 1e3 / steps,
            "self_attention_launches_per_step": len(sa) / steps,
            "traced_host_ms_per_step": traced_ms / steps,
            "device_busy_ms_per_step": (busy_ms / steps if kernels
                                        else "not measured"),
            "device_busy_share_traced": (busy_ms / traced_ms if kernels
                                         else None),
            "kernel_launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": {name[:60]: ms / steps
                                        for name, ms in ranked}}


def profile_decode(torch, asr, logits, state, steps: int = 8) -> dict:
    """A traced window of greedy decode steps (:func:`trace_steps`)."""
    from audio_rag_tpu_torch.models.whisper import decoder_step

    tok = logits.argmax(-1, keepdim=True)
    pos, cache = state["pos"], state["cache"]

    def step():
        nonlocal tok, pos, cache
        out, cache = decoder_step(
            asr._params, asr.dims, tok, state["ckv"], pos, cache,
            dtype=asr.dtype, q8=asr._params_q8,
            self_kv_int8=asr.config.self_kv_int8)
        tok = out.argmax(-1, keepdim=True)
        pos += 1

    return trace_steps(torch, step, steps)


def free_card(torch, phase: str | None = None) -> None:
    """Give the card's memory back. At a phase's end (``phase`` named),
    first print the phase's evictions and release the device-memory
    ledger: the manager unloads every backend it booked (its entries
    would keep a finished phase's models alive, and the next phase would
    "evict" them) and a fresh manager and engine replace the old ones."""
    if phase is not None:
        from audio_rag_tpu_torch.engine.engine import set_engine
        from audio_rag_tpu_torch.resources.manager import (
            get_resource_manager, set_resource_manager)

        rm = get_resource_manager()
        evicted = [e["name"] for e in rm.events if e["kind"] == "evict"]
        print(f"{phase} ledger: {rm.eviction_count} evictions {evicted}, "
              f"booked at the end {sorted(rm.status()['models'])}",
              flush=True)
        rm.unload_all()
        set_resource_manager(None)
        set_engine(None)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_full(torch, K, tag: str, profile: str, window_batch: int,
               n_windows: int) -> dict:
    """Large-v3 shapes through ``AudioRAG.ingest``/``query`` on
    ``n_windows`` windows of speech; returns the ingest's launches."""
    from audio_rag_tpu_torch.pipeline import AudioRAG

    wav = long_speech(n_windows * 30.0)
    rag = AudioRAG(large_v3_config("cuda", profile, window_batch))
    t0 = time.perf_counter()
    asr = rag.asr
    rag.embedder
    torch.cuda.synchronize()
    print(f"{tag} load_s {time.perf_counter() - t0:.2f} (seeded large-v3 "
          f"weights + {profile} decode tree)", flush=True)

    # first-step logits: kernels against plain versions, same inputs
    got, _, state = decode_window(torch, asr, wav)
    with plain_kernels(K):
        ref = decode_window(torch, asr, wav)[0]
    check_logits(tag, got, ref)
    del ref
    # a traced window of decode steps, outside the main path's run
    print(f"{tag} decode profile", json.dumps(
        profile_decode(torch, asr, got[0], state)), flush=True)
    del state, got
    free_card(torch)
    if tag == "full":
        print(f"{tag} traced encode", json.dumps(trace_encode(torch, asr, wav)),
              flush=True)
        free_card(torch)
    return ingest_run(torch, K, tag, rag, profile, wav, n_windows)


def trace_encode(torch, asr, wav) -> dict:
    """A traced encode of the first window batch (:func:`trace_steps`):
    device time, launches and the kernels that take the most of it."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import encode
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch

    dims = asr.dims
    B, n = asr.config.window_batch_size, 2 * dims.n_audio_ctx * HOP_LENGTH
    win = torch.from_numpy(np.ascontiguousarray(
        wav[: B * n].reshape(B, n))).to(asr.device)
    with torch.inference_mode():
        mel = log_mel_batch(win, n_mels=dims.n_mels)
    traced = trace_steps(torch, lambda: encode(asr._params, dims, mel,
                                               dtype=asr.dtype), 2, top=8)
    return {"window_batch": B,
            "host_ms_per_batch": traced["decode_ms_per_step"],
            **{key.replace("_step", "_batch"): traced[key] for key in (
                "device_busy_ms_per_step", "kernel_launches_per_step",
                "top_kernels_ms_per_step")}}


def ingest_run(torch, K, tag: str, rag, profile: str, wav,
               n_windows: int) -> dict:
    """The main path's run: ingest ``wav`` and query it through ``rag``
    with the launch counters reset just before and read just after;
    prints RTF, encode and decode times, loop iterations, peak memory and
    launches, and fails unless every kernel of the profile launched.
    Returns the launches."""
    from audio_rag_tpu_torch.audio.charvoice import SR

    seconds = len(wav) / SR
    asr = rag.asr
    rag.diarizer  # load the speaker encoder outside the timed ingest
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    with run_with_reorder(profile):
        res = rag.ingest(wav, sample_rate=SR, collection="full")
    hits = rag.query("gradient descent", top_k=3, collection="full").results
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(K)
    tm = asr.timings
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {
        "profile": profile, "window_batch": asr.config.window_batch_size,
        "windows": tm["windows"], "batches": tm["batches"],
        "encode_ms_per_batch": tm["encode_s"] / tm["batches"] * 1e3,
        # cross K/V precompute, 4 prompt steps and the decode loop
        "decode_ms": tm["decode_s"] * 1e3,
        "decode_loop_steps": tm["decode_steps"],
        "mel_ms": tm["mel_s"] * 1e3,
        # the teacher-forced alignment pass and the host DTW
        "align_pass_s": tm["align_s"], "dtw_s": tm["dtw_s"],
        "transcribe_s": res.stage_timings["transcribe"],
        "diarize_s": res.stage_timings["diarize"],
        "align_stage_s": res.stage_timings["align"],
        "diarize_timings": dict(rag.diarizer.timings),
        "speakers": res.num_speakers,
        "rtf": res.stage_timings["transcribe"] / seconds,
        "ingest_rtf": sum(res.stage_timings.values()) / seconds,
        "ingest_query_s": wall, "chunks": res.num_chunks,
        "segments": res.num_segments, "hits": len(hits),
        "peak_mem_gb": peak_gb, "launches": launches,
    }
    print(tag, json.dumps(out), flush=True)
    if tm["windows"] != n_windows or not hits:
        fail(f"{tag}: expected {n_windows} windows and search hits, "
             f"got {out}")
    check_launches(tag, launches, PROFILES[profile][1],
                   asr.dims.n_audio_layer * tm["batches"])
    if not all(math.isfinite(h.score) for h in hits):
        fail(f"{tag}: non-finite scores")
    return launches


def phase_capacity(torch, K) -> dict:
    """Large-v3 shapes in the capacity profile at window batch 16: the
    logits after the prompt and after 8 greedy steps on the int8 self
    cache, kernels against plain versions on the same tokens, then a
    traced window of decode steps. Returns the kernel run's launches."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR

    profile, tag = "kv4+dec4+skv8", "capacity"
    asr = WhisperASR(large_v3_config("cuda", profile, 16).asr, "cuda")
    t0 = time.perf_counter()
    asr.load()
    torch.cuda.synchronize()
    print(f"{tag} load_s {time.perf_counter() - t0:.2f} (seeded large-v3 "
          f"weights + {profile} decode tree)", flush=True)
    wav = long_speech(16 * 30.0, seed=6)
    # a cache of Whisper's full decode budget: 4 + 224 positions → Cp 256
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    got, fed, state = decode_window(torch, asr, wav, steps=8,
                                    cache_len=228)
    torch.cuda.synchronize()
    launches = launch_counts(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with plain_kernels(K):
        ref = decode_window(torch, asr, wav, steps=8, tokens=fed,
                            cache_len=228)[0]
    check_logits(tag, got, ref)
    print(f"{tag} launches", json.dumps(launches), "peak_mem_gb", peak_gb,
          flush=True)
    check_launches(tag, launches, PROFILES[profile][1],
                   asr.dims.n_audio_layer)
    del ref
    print(f"{tag} decode profile", json.dumps(
        profile_decode(torch, asr, got[-1], state)), flush=True)
    return launches


def prime_window(torch, asr, wav, cache_len: int):
    """Encode the first window batch and prime its B rows with the prompt
    as the ASR's decode profile does (``prime_decode``). Returns (cross
    K/V, primed (sk, sv), log-probabilities after the prompt, prompt)."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import encode, prime_decode
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch

    dims, st = asr.dims, asr.tokens
    n = 2 * dims.n_audio_ctx * HOP_LENGTH
    B = asr.config.window_batch_size
    win = torch.from_numpy(np.ascontiguousarray(
        wav[: B * n].reshape(B, n))).to(asr.device)
    prompt = torch.tensor([[st.sot, st.lang_base, st.transcribe,
                            st.no_timestamps]] * B, device=asr.device)
    with torch.inference_mode():
        enc = encode(asr._params, dims,
                     log_mel_batch(win, n_mels=dims.n_mels), dtype=asr.dtype)
        ckv, cache, logp0 = prime_decode(
            asr._params, dims, enc, prompt, cache_len, asr.dtype,
            asr._params_q8, True, asr.cross_kv_bits)
    return ckv, cache, logp0, prompt


def check_beam_modes(torch, K, asr, primed, total: int,
                     steps: int = 8) -> None:
    """From one primed state, ``steps`` beam steps in each reorder mode:
    "kernel"'s tokens, scores and self caches must equal "onehot"'s bit for
    bit after every step; "kernel"'s logits must stay within 5 % of the
    plain-kernel path's on the same cache and tokens; lazy's token
    agreement and logit difference are printed."""
    from audio_rag_tpu_torch.models.whisper import (
        beam_start, beam_step, decoder_step)

    ckv, cache, logp0, prompt = primed
    tag, eot = "beam[C=228]", asr.tokens.eot
    states = {m: beam_start(cache, logp0, prompt, total, BEAM, eot, m)
              for m in ("kernel", "onehot", "lazy")}
    got, ref, rows = [], [], []
    with torch.inference_mode():
        for i in range(steps):
            st = states["kernel"]
            tok = st.tokens.reshape(-1, total)[:, st.pos:st.pos + 1].clone()
            pos, before = st.pos, tuple(c.clone() for c in st.cache)
            logits = {m: beam_step(asr._params, asr.dims, ckv, s, asr.dtype,
                                   asr._params_q8)
                      for m, s in states.items()}
            with plain_kernels(K):
                plain = decoder_step(asr._params, asr.dims, tok, ckv, pos,
                                     before, dtype=asr.dtype,
                                     q8=asr._params_q8, beams=BEAM)[0]
            del before
            got.append(logits["kernel"].float())
            ref.append(plain.float())
            kern, one, lazy = (states[m] for m in ("kernel", "onehot",
                                                   "lazy"))
            same = (torch.equal(kern.tokens, one.tokens)
                    and _same_bits(torch, kern.sum_lp, one.sum_lp)
                    and torch.equal(kern.finished, one.finished)
                    and all(_same_bits(torch, a, b)
                            for a, b in zip(kern.cache, one.cache)))
            rows.append({
                "step": i, "kernel_equals_onehot_bits": same,
                "lazy_token_agreement": (kern.tokens == lazy.tokens)
                .float().mean().item(),
                "lazy_max_abs_logit_diff": (logits["lazy"] - logits["kernel"])
                .abs().max().item()})
            print(tag, json.dumps(rows[-1]), flush=True)
            if not same:
                fail(f"{tag}: the kernel reorder differs from the one-hot "
                     f"reorder at step {i}")
    check_logits(tag, got, ref)


def profile_beam(torch, asr, primed, total: int, mode: str,
                 steps: int = 8) -> dict:
    """A traced window of beam steps in one reorder mode at C = 228, with
    the peak device memory of the mode's run."""
    from audio_rag_tpu_torch.models.whisper import beam_start, beam_step

    ckv, cache, logp0, prompt = primed
    free_card(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = beam_start(cache, logp0, prompt, total, BEAM, asr.tokens.eot,
                       mode)
    out = trace_steps(torch, lambda: beam_step(
        asr._params, asr.dims, ckv, state, asr.dtype, asr._params_q8),
        steps, top=8)
    out["reorder"] = mode
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_above_primed_gb"] = (torch.cuda.max_memory_allocated()
                                   - base) / 1e9
    return out


def phase_beam(torch, K) -> dict:
    """Large-v3 shapes, beam 5 in the benchmark profile at window batch 16:
    a window at the full decode budget (C = 228) checked in the three
    reorder modes and traced in each, then the main path through
    ``AudioRAG.ingest``/``query`` with ``BEAM_REORDER=kernel``. Returns the
    ingest's launches."""
    from audio_rag_tpu_torch.pipeline import AudioRAG

    profile, tag = "beam5+kv4+int8+lm4", "beam"
    wav = long_speech(BEAM_WB * 30.0, seed=7)
    rag = AudioRAG(large_v3_config("cuda", profile, BEAM_WB))
    t0 = time.perf_counter()
    asr = rag.asr
    rag.embedder
    torch.cuda.synchronize()
    print(f"{tag} load_s {time.perf_counter() - t0:.2f} (seeded large-v3 "
          f"weights + {profile} decode tree)", flush=True)
    total = 4 + 224  # the prompt and Whisper's full decode budget
    primed = prime_window(torch, asr, wav, total)
    check_beam_modes(torch, K, asr, primed, total)
    free_card(torch)
    for mode in ("kernel", "onehot", "lazy"):
        print(f"{tag} decode profile", json.dumps(
            profile_beam(torch, asr, primed, total, mode)), flush=True)
    del primed
    free_card(torch)
    return ingest_run(torch, K, tag, rag, profile, wav, BEAM_WB)


# -- phase 17: train -----------------------------------------------------------

TRAIN_N, TRAIN_STEPS = 512, 300  # (b): utterances, steps on the card
#: (a): the shapes the training path gives the flash kernel: tiny-synth's
#: encoder (B 64), large-v3's at B 4, and bf16 on the encoder's
#: head-strided view
TRAIN_FLASH = [((64, 4, 300, 32), "float32", "bthd"),
               ((4, 20, 1500, 64), "float32", "bthd"),
               ((4, 20, 1500, 64), "bfloat16", "bthd")]


def train_script():
    """``scripts/train_asr_torch.py`` as a module (its ``main`` does not
    run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_asr_torch", ROOT / "scripts" / "train_asr_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flash_grad_case(torch, K, shape, dtype_name: str, layout: str,
                    device: str = "cuda", timed: bool = True) -> dict:
    """The flash call with a gradient (``FlashAttentionFn``: the kernel
    forward, the torch-op backward) against autograd of the plain version
    on the same device in full f32; the same bits from a second call;
    times of the backward alone, of forward + backward, of the plain
    version's forward + backward and of SDPA's (the library column)."""
    from audio_rag_tpu_torch.device import full_f32

    dtype = getattr(torch, dtype_name)
    B, H, T, D = shape
    g = torch.Generator(device=device).manual_seed(3)

    def base():
        dims = (B, T, H, D) if layout == "bthd" else shape
        return torch.randn(dims, generator=g, device=device).to(dtype) \
            .requires_grad_(True)

    def view(x):
        return x.transpose(1, 2) if layout == "bthd" else x

    bases = [base() for _ in range(3)]
    q, k, v = (view(x) for x in bases)
    do = torch.randn((B, H, T, D), generator=g, device=device).to(dtype)
    with full_f32(device):
        n0 = K.LAUNCHES[FLASH]
        out = K.flash_attention(q, k, v)
        launched = K.LAUNCHES[FLASH] - n0
        got = torch.autograd.grad(out, bases, do)
        again = torch.autograd.grad(K.flash_attention(q, k, v), bases, do)
        ref = torch.autograd.grad(K.flash_attention_plain(q, k, v), bases,
                                  do)
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    top = max(r.float().abs().max().item() for r in ref)
    # f32: the same math as autograd's but for rowsum(dO∘O), which reads
    # the kernel's output (sums in another order); bf16: that output and
    # each gradient are rounded to bf16 (2^-8 relative) and the kernel
    # rounds P to bf16 before P·V: allow two bf16 ulps at the largest
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * max(1.0, top)
    row = {"shape": list(shape), "dtype": dtype_name, "layout": layout,
           "forward_launches": launched,
           "max_abs_err": {n: e for n, e in zip("qkv", errs)}, "tol": tol,
           "same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip(got, again))}
    ok = (max(errs) <= tol and row["same_bits_twice"] and launched
          == (1 if device == "cuda" else 0))
    if timed:
        qd, kd, vd = (x.detach() for x in (q, k, v))
        od = out.detach()

        def fwd_bwd(fn):
            def run():
                with full_f32(device):
                    torch.autograd.grad(fn(q, k, v), bases, do)
            return run

        def sdpa(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v)

        iters = 5
        with full_f32(device):
            row["backward_ms"] = time_ms(torch, lambda: (
                K.flash_attention_backward(qd, kd, vd, od, do)), iters)
        row["fwd_bwd_ms"] = time_ms(torch, fwd_bwd(K.flash_attention),
                                    iters)
        row["plain_fwd_bwd_ms"] = time_ms(
            torch, fwd_bwd(K.flash_attention_plain), iters)
        row["library_fwd_bwd_ms"] = time_ms(torch, fwd_bwd(sdpa), iters)
        esize = torch.empty((), dtype=dtype).element_size()
        # q, k, v, o, dO read once, dq, dk, dv written once; five f32
        # products of B·H·T·T·D (S again, dV, dP, dQ, dK)
        row["backward_bound_ms"], row["backward_bound_by"] = bound_ms(
            8 * B * H * T * D * esize, 10 * B * H * T * T * D, "f32")
    return row, ok


def encode_grads(torch, params: dict, dims, mel, w, device: str) -> dict:
    """Gradients of Σ(encode(mel)·w) for every encoder leaf, on
    ``device``, forward and backward in full f32."""
    from audio_rag_tpu_torch.device import full_f32
    from audio_rag_tpu_torch.models.whisper import encode

    leaves = {}

    def place(tree, prefix=""):
        out = {}
        for key, val in tree.items():
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                out[key] = place(val, name)
            else:
                out[key] = leaves[name] = val.to(device).clone() \
                    .requires_grad_(True)
        return out

    p = place(params)
    with full_f32(device):
        loss = (encode(p, dims, mel.to(device), dtype=torch.float32)
                * w.to(device)).sum()
        loss.backward()
    return {name: t.grad.cpu() for name, t in leaves.items()
            if name.startswith("encoder/")}


def check_encode_grads(torch, K, dims, params, mel) -> dict:
    """Fault 14 on the card: every encoder leaf's gradient (the attention's
    q, k and v through the flash kernel among them) against the CPU's."""
    g = torch.Generator().manual_seed(4)
    w = torch.randn((mel.shape[0], dims.n_audio_ctx, dims.n_audio_state),
                    generator=g)
    n0 = K.LAUNCHES[FLASH]
    card = encode_grads(torch, params, dims, mel, w, "cuda")
    launched = K.LAUNCHES[FLASH] - n0
    cpu = encode_grads(torch, params, dims, mel, w, "cpu")
    rel = {n: ((card[n] - cpu[n]).abs().max()
               / cpu[n].abs().max().clamp(min=1e-30)).item() for n in cpu}
    # f32 on both sides: the card sums in other orders (conv, matmuls, the
    # flash kernel), a few ulps of f32 on each leaf's largest gradient
    tol = 1e-4
    worst = max(rel, key=rel.get)
    out = {"leaves": len(rel), "worst_leaf": worst, "worst_rel_err": rel[worst],
           "attn_rel_err": {n.split("/")[-2]: rel[n] for n in rel
                            if "/attn/" in n and n.endswith("/w")},
           "conv_rel_err": {n.split("/")[-2]: rel[n] for n in rel
                            if "/conv" in n and n.endswith("/w")},
           "tol": tol, "flash_launches": launched}
    print("train encode grads card vs cpu", json.dumps(out), flush=True)
    if rel[worst] > tol or launched != dims.n_audio_layer:
        fail(f"train: encode's gradients on the card differ from the CPU's "
             f"(fault 14): {out}")
    return out


def train_tiny(torch, K, device: str = "cuda", n: int = TRAIN_N,
               steps: int = TRAIN_STEPS) -> dict:
    """(b) tiny-synth from ``init_whisper``: ``n`` utterances of the
    trainer's dataset (TTS rows included), three steps on the card
    against the port's CPU, then ``steps`` steps on the card."""
    import numpy as np

    from audio_rag_tpu_torch.config import TTSConfig
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS, SpecialTokens, init_whisper)
    from audio_rag_tpu_torch.tts.neural import NeuralTTS

    tat = train_script()
    dims = WHISPER_PRESETS["tiny-synth"]
    st = SpecialTokens.for_dims(dims)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    texts = tat.make_utterance_texts(rng, n, tat.corpus_lexicon(),
                                     double_p=0.10)
    tts = NeuralTTS(TTSConfig(backend="jax"), device=device)
    n_tts = int(n * tat.TTS_FRACTION)
    audio, tokens, targets, mask = tat.build_dataset(
        rng, texts, st, 2 * dims.n_audio_ctx, tts=tts, n_tts=n_tts)
    perm = np.random.default_rng(7).permutation(n)
    arrays = [a[perm] for a in (audio, tokens, targets, mask)]
    data = tat.device_batches(torch, *arrays, dims.n_mels, device)
    data_s = time.perf_counter() - t0
    init = init_whisper(dims, seed=0, device="cpu")
    out: dict = {"utterances": n, "tts_rows": n_tts, "dataset_s": data_s}

    if device == "cuda":
        check_encode_grads(torch, K, dims, init,
                           data["mel"][0, :4].cpu())
        # the port's CPU run of the first three steps on the same audio
        t0 = time.perf_counter()
        cpu_data = tat.device_batches(
            torch, *[a[:3 * tat.BATCH] for a in arrays], dims.n_mels, "cpu")
        snap: dict = {}
        cpu_params, cpu_losses, _ = tat.train(
            torch, cpu_data, 3, "cpu", params=init, schedule_steps=steps)
        out["cpu_3_steps_s"] = time.perf_counter() - t0

        def keep(i, params):
            if i == 2:
                snap.update({n_: t.detach().cpu().clone() for n_, t in
                             _flat(params).items()})
    else:
        keep = None
    K.reset_launches()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with plain_calls(K, K.KERNELS) as plain:
        params, losses, seconds = tat.train(
            torch, data, steps, device, params=init, chunk=100,
            schedule_steps=steps, after_step=keep)
    counts = launch_counts(K)
    out.update({"steps": steps, "seconds": seconds,
                "step_ms": seconds / steps * 1e3, "steps_per_s": steps / seconds,
                "losses_first_3": losses[:3],
                "loss_last_10_mean": float(np.mean(losses[-10:])),
                "flash_launches_per_step": counts[FLASH] / steps,
                "plain_calls": sum(plain.values())})
    if device == "cuda":
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        cpu_flat = _flat(cpu_params)
        # step 1's update is zero (lr 0); steps 2 and 3 move each weight by
        # at most ~lr (Adam), lr_3 = 2e-5: the sides may part where f32
        # gradients of other summation orders differ, a small share of it
        p_err = max((snap[n_] - cpu_flat[n_].detach()).abs().max().item()
                    for n_ in cpu_flat)
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses[:3],
                                                         cpu_losses))
        out.update({"cpu_losses_first_3": cpu_losses,
                    "loss_rel_err": l_err, "loss_tol": 1e-5,
                    "param_max_abs_err_after_3": p_err, "param_tol": 2e-6})
    print("train tiny-synth", json.dumps(out), flush=True)
    if device == "cuda" and (out["loss_rel_err"] > out["loss_tol"]
                             or out["param_max_abs_err_after_3"]
                             > out["param_tol"]):
        fail(f"train tiny-synth: the card's first three steps differ from "
             f"the CPU's: {out}")
    if not out["loss_last_10_mean"] < 0.75 * losses[0]:
        fail(f"train tiny-synth: the loss did not fall below 0.75x its "
             f"first value in {steps} steps: {out}")
    expect = dims.n_audio_layer * steps if device == "cuda" else 0
    if counts[FLASH] != expect:
        fail(f"train tiny-synth: expected {expect} flash launches in "
             f"{steps} steps, got {counts[FLASH]}")
    other = {k: c for k, c in counts.items() if k not in (FLASH, WGMMA) and c}
    if other or (device == "cuda" and out["plain_calls"]):
        fail(f"train tiny-synth: other kernels launched ({other}) or plain "
             f"versions called ({plain})")
    return counts


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        out.update(_flat(val, name) if isinstance(val, dict)
                   else {name: val})
    return out


def train_large(torch, K, device: str = "cuda", preset: str = "large-v3",
                B: int = 4, S: int = 128, steps: int = 4) -> dict:
    """(c) ``preset`` at full width from seeded f32 weights:
    ``TrainConfig(warmup_steps=2)``, ``steps`` steps on one batch of B
    30 s windows of speech and S random tokens; every loss and gradient
    finite, every leaf's gradient norm nonzero, the last loss below the
    first."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS, init_whisper)
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch
    from audio_rag_tpu_torch.training import (
        TrainConfig, init_train_state, make_train_step)

    dims = WHISPER_PRESETS[preset]
    n_samp = 2 * dims.n_audio_ctx * HOP_LENGTH
    wav = long_speech(B * n_samp / 16000, seed=9).reshape(B, n_samp)
    rng = np.random.default_rng(9)
    seq = rng.integers(0, min(dims.n_vocab, 50257), (B, S + 1))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        mel = log_mel_batch(torch.from_numpy(wav).to(device),
                            n_mels=dims.n_mels)
    batch = {"mel": mel, "tokens": torch.from_numpy(seq[:, :-1]),
             "targets": torch.from_numpy(seq[:, 1:]),
             "mask": torch.ones((B, S))}
    cfg = TrainConfig(warmup_steps=2)
    params, opt, state = init_train_state(
        init_whisper(dims, seed=0, device=device), cfg, dims, device)
    gc.collect()
    step = make_train_step(dims, cfg, opt)
    leaves = list(_flat(params).items())
    K.reset_launches()
    losses, secs, zero, bad = [], [], set(), set()
    with plain_calls(K, K.KERNELS) as plain:
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch)
            norms = torch.stack([t.grad.norm() for _, t in leaves]).tolist()
            secs.append(time.perf_counter() - t0)
            losses.append(loss.item())
            zero |= {n for (n, _), v in zip(leaves, norms) if v == 0.0}
            bad |= {n for (n, _), v in zip(leaves, norms)
                    if not math.isfinite(v)}
    counts = launch_counts(K)
    out = {"preset": preset, "B": B, "mel_frames": 2 * dims.n_audio_ctx,
           "S": S, "steps": steps, "losses": losses, "step_s": secs,
           "leaves": len(leaves), "params": sum(t.numel() for _, t in leaves),
           "flash_launches": counts[FLASH],
           "plain_calls": sum(plain.values())}
    if device == "cuda":
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"train {preset}", json.dumps(out), flush=True)
    if zero or bad or not all(math.isfinite(x) for x in losses):
        fail(f"train {preset}: gradients zero {sorted(zero)[:8]} or not "
             f"finite {sorted(bad)[:8]}, losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train {preset}: the loss at step {steps} is not below step "
             f"1's: {losses}")
    expect = dims.n_audio_layer * steps if device == "cuda" else 0
    if counts[FLASH] != expect or any(
            c for k, c in counts.items() if k not in (FLASH, WGMMA)) or (
            device == "cuda" and out["plain_calls"]):
        fail(f"train {preset}: expected {expect} flash launches, no other "
             f"kernel and no plain version, got {counts}, plain {plain}")
    del params, state, opt, step, leaves
    return counts


def phase_train(torch, K) -> dict:
    """(a) the flash gradient at the training path's shapes, (b)
    tiny-synth from ``init_whisper`` (the encoder's gradients and three
    steps against the CPU, then 300 steps), (c) large-v3 at full width;
    returns launches by path and the flash rows' gradient columns."""
    t_phase = time.perf_counter()
    rows = []
    for shape, dtype, layout in TRAIN_FLASH:
        row, ok = flash_grad_case(torch, K, shape, dtype, layout)
        print("train flash grad", json.dumps(row), flush=True)
        if not ok:
            fail(f"train: the flash gradient at {shape} {dtype} differs from "
                 f"the plain version's autograd: {row}")
        rows.append(row)
    free_card(torch)
    by_path = {"train_tiny": train_tiny(torch, K)}
    free_card(torch)
    by_path["train_large_v3"] = train_large(torch, K)
    free_card(torch)
    print(f"train phase_s {time.perf_counter() - t_phase:.1f} "
          f"({card_line()})", flush=True)
    return {"launches": by_path, "flash_grad": rows}


# -- phase 18: converted checkpoints ------------------------------------------

CONVERT_WINDOWS = 16  # large-v3 windows transcribed from the converted file
ECAPA_RELEASE = {"n_mels": 80, "channels": 1024, "mfa": 3072, "attn": 128,
                 "se": 128, "emb": 192, "scale": 8}  # spkrec-ecapa-voxceleb
ECAPA_TOL = 1e-4  # an f32 speaker embedding, card against CPU
STEP_TOKENS = [5, 9, 13, 17]  # the converted Llama's decode step's inputs


def hf_layout():
    """The HF-layout directory writers the tests use
    (``tests/torch_hf_layout.py``) and ``scripts/load_real_torch.py``."""
    for sub in ("tests", "scripts"):
        if str(ROOT / sub) not in sys.path:
            sys.path.insert(0, str(ROOT / sub))
    import load_real_torch
    import torch_hf_layout

    return torch_hf_layout, load_real_torch


def host_peak_gb() -> float:
    """This process's peak resident host memory."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def f16_tree(torch, tree: dict) -> dict:
    """The same tree with every leaf rounded to f16, on the host."""
    return {k: f16_tree(torch, v) if isinstance(v, dict)
            else v.to(torch.float16).cpu() for k, v in tree.items()}


def f16_mismatches(tree: dict, ref: dict) -> list[str]:
    """Keys of the converted (numpy) tree whose leaf is not the f16
    tensor of ``ref`` bit for bit, or is missing."""
    import numpy as np

    bad = []
    for k, v in ref.items():
        if isinstance(v, dict):
            bad += [f"{k}/{b}" for b in f16_mismatches(tree.get(k, {}), v)]
            continue
        got, want = tree.get(k), v.numpy()
        if (got is None or got.dtype != np.float16 or got.shape != want.shape
                or not np.array_equal(got.view(np.uint16),
                                      want.view(np.uint16))):
            bad.append(k)
    return bad


def convert_large_v3(torch, K, workdir: Path, device: str = "cuda",
                     preset: str = "large-v3") -> dict:
    """(a) the seeded large-v3 (the ``full`` phase's seed) written as one
    F16 ``model.safetensors`` in HF layout, classified, converted, held
    to the F16-rounded source bit for bit, then loaded through
    ``checkpoint_path`` in the production decode profile: 16 windows of
    the ``full`` phase's speech, tokens equal to ``WhisperASR(weights=)``
    on the same F16 tree; returns the main run's launches. ``device`` and
    ``preset`` rehearse it on the CPU."""
    import dataclasses

    import numpy as np

    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.checkpoint import save_params
    from audio_rag_tpu_torch.convert import convert_whisper, tree_bytes
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS, init_whisper)
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, SAMPLE_RATE

    layout, load_real = hf_layout()
    dims = WHISPER_PRESETS[preset]
    tag = f"convert[{preset}]"
    cuda = device == "cuda"
    src = init_whisper(dims, seed=0, device=device, dtype=torch.bfloat16)
    hf_dir, ckpt = workdir / f"whisper-{preset}", workdir / "whisper_ck"
    sync(torch, device)
    t0 = time.perf_counter()
    layout.write_whisper(src, hf_dir, dims, np.float16)
    write_s = time.perf_counter() - t0
    nbytes = (hf_dir / "model.safetensors").stat().st_size
    if load_real.classify(hf_dir) != "whisper":
        fail(f"{tag}: the directory does not classify as whisper")
    t0 = time.perf_counter()
    tree = convert_whisper(hf_dir)
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_params(ckpt, "whisper", tree)
    save_s = time.perf_counter() - t0
    src = f16_tree(torch, src)  # the F16-rounded source, on the host
    if cuda:
        free_card(torch)
    bad = f16_mismatches(tree, src)
    if bad:
        fail(f"{tag}: converted leaves differ from the F16-rounded source: "
             f"{bad[:8]}")
    tree_gb = tree_bytes(tree) / 1e9
    del tree
    window = 2 * dims.n_audio_ctx * HOP_LENGTH
    wav = long_speech(CONVERT_WINDOWS * window / SAMPLE_RATE)
    cfg = large_v3_config(device, "int8", 16, model_size=preset)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    asr = WhisperASR(dataclasses.replace(cfg.asr, checkpoint_path=str(ckpt)),
                     device=device)
    t0 = time.perf_counter()
    asr.load()
    sync(torch, device)
    load_s = time.perf_counter() - t0
    asr.transcribe(wav[:window], SAMPLE_RATE)  # first calls, not counted
    sync(torch, device)
    K.reset_launches()
    t0 = time.perf_counter()
    with plain_calls(K, K.KERNELS) as plain:
        got = [x.text for x in asr.transcribe(wav, SAMPLE_RATE)]
        sync(torch, device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(K)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    asr.unload()
    del asr
    ref = WhisperASR(cfg.asr, device=device, weights=src)
    want = [x.text for x in ref.transcribe(wav, SAMPLE_RATE)]
    ref.unload()
    del ref, src
    if cuda:
        free_card(torch)
    out = {"file_gb": nbytes / 1e9, "tree_gb": tree_gb,
           "write_s": write_s, "write_gb_per_s": nbytes / 1e9 / write_s,
           "convert_s": convert_s,
           "convert_gb_per_s": nbytes / 1e9 / convert_s,
           "save_s": save_s, "save_gb_per_s": nbytes / 1e9 / save_s,
           "load_s": load_s, "load_gb_per_s": nbytes / 1e9 / load_s,
           "transcribe_ms": ms, "windows": CONVERT_WINDOWS,
           "segments": len(got), "peak_mem_gb": peak,
           "host_peak_gb": host_peak_gb(), "plain_calls": dict(plain),
           "launches": launches}
    print(tag, json.dumps(out), f"({card_line()})", flush=True)
    if got != want or not got:
        fail(f"{tag}: the converted checkpoint's transcripts differ from "
             f"WhisperASR(weights=) on the same F16 tree ({len(got)} and "
             f"{len(want)} segments)")
    if cuda:
        if any(plain.values()):
            fail(f"{tag}: plain versions ran on the card: {dict(plain)}")
        check_launches(tag, launches, PROFILES["int8"][1],
                       encoder_calls=32 * -(-CONVERT_WINDOWS // 16))
    return launches


def convert_ecapa(torch, workdir: Path, widths: dict = ECAPA_RELEASE,
                  devices: tuple[str, str] = ("cuda", "cpu")) -> dict:
    """(b) a seeded ECAPA-TDNN at the voxceleb release's widths as a
    speechbrain ``embedding_model.ckpt`` (BatchNorm running statistics
    included), converted, then the ``diarize`` phase's 3-voice
    conversation through ``ClusteringDiarizer(checkpoint_path=...)`` on
    the card and on the CPU: the same windows, embeddings within 1e-4,
    the same segments. ``widths`` and ``devices`` rehearse it on the
    CPU."""
    import numpy as np

    from audio_rag_tpu_torch.audio.synth import conversation, sample_voice
    from audio_rag_tpu_torch.config import DiarizationConfig
    from audio_rag_tpu_torch.convert import convert_dir
    from audio_rag_tpu_torch.diarization.clustering import ClusteringDiarizer

    layout, load_real = hf_layout()
    tag = "convert[ecapa]"
    src = workdir / "spkrec-ecapa-voxceleb"
    state = layout.speechbrain_ecapa_state(torch.Generator().manual_seed(0),
                                           **widths)
    layout.write_ecapa(state, src)
    if load_real.classify(src) != "speaker":
        fail(f"{tag}: the directory does not classify as speaker")
    t0 = time.perf_counter()
    convert_dir("speaker", src, workdir / "speaker_ck")
    convert_s = time.perf_counter() - t0
    rng = np.random.default_rng(2024)
    voices = [sample_voice(rng) for _ in range(3)]
    audio, _ = conversation(rng, voices, duration_s=50.0)
    runs = []
    for device in devices:
        d = ClusteringDiarizer(DiarizationConfig(
            checkpoint_path=str(workdir / "speaker_ck"),
            vad_backend="energy"), device=device)
        d.load()
        if d.source != "checkpoint" or d.dims.channels != widths["channels"]:
            fail(f"{tag}: the diarizer did not load the converted ECAPA "
                 f"({d.source}, {d.dims})")
        d._spans_and_embeddings(audio, 16_000)  # first calls, not timed
        _, starts, emb = d._spans_and_embeddings(audio, 16_000)
        timings = dict(d.timings)
        segs = d.diarize(audio, 16_000, num_speakers=3)
        runs.append({"starts": starts, "emb": emb, "timings": timings,
                     "segments": [(x.start, x.end, x.speaker)
                                  for x in segs]})
        d.unload()
    card, cpu = runs
    err = float(np.abs(card["emb"] - cpu["emb"]).max())
    batches = -(-len(card["starts"]) // 512)
    out = {"params_m": sum(v.numel() for v in state.values()) / 1e6,
           "convert_s": convert_s, "windows": len(card["starts"]),
           "embed_ms": card["timings"]["embed_s"] * 1e3,
           "embed_ms_per_window_batch": card["timings"]["embed_s"] * 1e3
           / batches, "cpu_embed_ms": cpu["timings"]["embed_s"] * 1e3,
           "max_abs_err": err, "tol": ECAPA_TOL,
           "segments": len(card["segments"]),
           "speakers": len({x[2] for x in card["segments"]})}
    print(tag, json.dumps(out), f"({card_line()})", flush=True)
    if card["starts"] != cpu["starts"] or not err <= ECAPA_TOL:
        fail(f"{tag}: card embeddings differ from the CPU's ({err})")
    if card["segments"] != cpu["segments"] or not card["segments"]:
        fail(f"{tag}: card segments differ from the CPU's")
    return out


def convert_rehearsal(torch, K, workdir: Path, device: str = "cuda") -> dict:
    """(c) ``scripts/load_real_torch.py`` on the card over
    ``test_load_real.py``'s tiny directories (with the evaluation
    sweep), then the converted tied and untied Llama's first decode
    step through ``matmul_q8w`` in the answer phase's profile
    (decoder_int8, bf16), card against CPU; returns launches by path.
    ``device`` "cpu" rehearses it."""
    import io

    from audio_rag_tpu_torch.config import GenerationConfig
    from audio_rag_tpu_torch.convert import convert_dir
    from audio_rag_tpu_torch.generation.llm import LLMGenerator
    from audio_rag_tpu_torch.models.llm import LLM_PRESETS, init_llm

    layout, load_real = hf_layout()
    tag = "convert[rehearsal]"
    models = layout.write_test_models(workdir / "tiny")
    K.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with plain_calls(K, K.KERNELS) as plain, contextlib.redirect_stdout(buf):
        rc = load_real.main([str(models), "--out", str(workdir / "conv"),
                             "--collection", "rehearsal",
                             *(["--cpu"] if device == "cpu" else [])])
    sync(torch, device)
    wall = time.perf_counter() - t0
    launches = {"convert_rehearsal": launch_counts(K)}
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    kinds = {x["kind"] for x in lines if "converted" in x}
    ingest = [x for x in lines if "ingested" in x]
    query = [x for x in lines if "query_results" in x]
    ev = [x["evaluation"] for x in lines if "evaluation" in x]
    print(tag, json.dumps({"rc": rc, "s": wall, "kinds": sorted(kinds),
                           "ingest": ingest, "query": query,
                           "evaluation": ev, "plain_calls": dict(plain),
                           "launches": launches["convert_rehearsal"]}),
          flush=True)
    if (rc != 0 or kinds != {"whisper", "llama", "bgem3", "reranker",
                             "speaker"}
            or not ingest or ingest[0]["chunks"] <= 0
            or not query or query[0]["query_results"] <= 0
            or not ev or set(ev[0]) != {"dense", "hybrid"}):
        fail(f"{tag}: the rehearsal did not convert, ingest, query and "
             f"evaluate every kind: {lines}")
    if device == "cuda":
        if any(plain.values()):
            fail(f"{tag}: plain versions ran on the card: {dict(plain)}")
        check_launches(tag, launches["convert_rehearsal"], {FLASH})
        free_card(torch, "convert rehearsal")

    dims = LLM_PRESETS["test"]
    for tied in (False, True):
        name = "llama-" + ("tied" if tied else "untied")
        tree = init_llm(dims, torch.Generator().manual_seed(5),
                        torch.float32)
        if tied:
            tree["lm_head"]["w"] = tree["tok_emb"]["table"].T.contiguous()
        layout.write_llama(tree, workdir / name, dims, tied=tied)
        convert_dir("llama", workdir / name, workdir / f"{name}_ck")
        cfg = GenerationConfig(model="test", decoder_int8=True,
                               checkpoint_path=str(workdir / f"{name}_ck"))
        gens = {dev: LLMGenerator(cfg, device=dev) for dev in (device, "cpu")}
        for g in gens.values():
            g.load()
        prompts = ANSWER_QUESTIONS[:4]  # within the test preset's window
        K.reset_launches()
        with plain_calls(K, K.KERNELS) as plain:
            got = first_step_logits(torch, gens[device], prompts, device,
                                    token=STEP_TOKENS)
            sync(torch, device)
        launches[f"convert_{name}"] = launch_counts(K)
        ref = first_step_logits(torch, gens["cpu"], prompts, device="cpu",
                                token=STEP_TOKENS)
        check_logits(f"convert[{name}]", [got.float().cpu()], [ref.float()])
        if device == "cuda":
            if any(plain.values()):
                fail(f"convert[{name}]: plain versions ran on the card: "
                     f"{dict(plain)}")
            check_launches(f"convert[{name}]", launches[f"convert_{name}"],
                           {Q8W})
        for g in gens.values():
            g.unload()
    return launches


def phase_convert(torch, K) -> dict:
    """(a) large-v3 from a converted F16 checkpoint, (b) ECAPA at the
    release widths, (c) the rehearsal and the converted Llama; returns
    launches by path."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        by_path = {"convert": convert_large_v3(torch, K, Path(tmp) / "a")}
        free_card(torch)
        convert_ecapa(torch, Path(tmp) / "b")
        free_card(torch)
        by_path.update(convert_rehearsal(torch, K, Path(tmp) / "c"))
    print(f"convert phase_s {time.perf_counter() - t_phase:.1f} "
          f"({card_line()})", flush=True)
    return by_path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,spine,diarize,fallback,query,"
                            "answer,stream,profiles,queue,api,eval,train,"
                            "convert,full,full_kv4,capacity,beam",
                    help="comma-separated subset of build,kernels,spine,"
                         "diarize,fallback,query,answer,stream,profiles,"
                         "queue,api,eval,train,convert,full,full_kv4,"
                         "capacity,beam (queue and api need profiles)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / "audio_rag_tpu_torch" / "ops" / "kernels.py").is_file():
        fail("audio_rag_tpu_torch is not beside this script")
    sys.path.insert(0, str(ROOT))
    from audio_rag_tpu_torch.ops import kernels as K

    print("tf32 switches, PyTorch's defaults, left as they are: "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    print(card_line())  # nvidia-smi's name and power limit, as it gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    report = K.build(verbose="build" in phases)
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)
    from audio_rag_tpu_torch import native

    t0 = time.perf_counter()
    if not native.native_available():  # word-time DTW, WAV decode, resample
        fail("the native audio runtime did not build or load")
    print(f"native library {native.lib_path()} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, rep in report.items():
        if rep["log"]:
            print(f"--- nvcc {name} ({rep['seconds']:.1f} s)\n{rep['log']}")
    if "build" in phases:
        for name in (FLASH, CROSS8, CROSS4, SELF8):
            print(f"{name} sass", json.dumps(sass_census(K, name)),
                  flush=True)

    measured: dict = {}
    by_path: dict[str, dict] = {}
    if "kernels" in phases:
        measured = phase_kernels(torch, K)
    with tempfile.TemporaryDirectory() as tmp:
        if "spine" in phases:
            by_path.update(phase_spine(torch, K, Path(tmp)))
            free_card(torch, "spine")
        if "diarize" in phases:
            by_path.update(phase_diarize(torch, K, Path(tmp)))
            free_card(torch, "diarize")
    if "fallback" in phases:
        by_path.update(phase_fallback(torch, K))
        free_card(torch, "fallback")
    if "query" in phases:
        by_path.update(phase_query(torch, K))
        free_card(torch, "query")
    if "answer" in phases:
        by_path.update(phase_answer(torch, K))
        free_card(torch, "answer")
    if "stream" in phases:
        by_path.update(phase_stream(torch, K))
        free_card(torch, "stream")
    for phase in ("queue", "api"):
        if phase in phases and "profiles" not in phases:
            fail(f"the {phase} phase serves profiles' files through "
                 "profiles' pipeline: run it with profiles")
    if "profiles" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            prof = phase_profiles(torch, K, Path(tmp))
            by_path.update(prof["launches"])
            if "queue" in phases:
                by_path.update(phase_queue(torch, K, prof, Path(tmp)))
            if "api" in phases:
                by_path.update(phase_api(torch, K, prof, Path(tmp)))
            prof["rag"].unload_all()
            del prof
        free_card(torch, "+".join(p for p in ("profiles", "queue", "api")
                                  if p in phases))
    if "eval" in phases:
        by_path.update(phase_eval(torch, K))
        free_card(torch, "eval")
    flash_grad: list = []
    if "train" in phases:
        trained = phase_train(torch, K)
        by_path.update(trained["launches"])
        flash_grad = trained["flash_grad"]
    if "convert" in phases:
        by_path.update(phase_convert(torch, K))
        free_card(torch, "convert")
    if "full" in phases:
        by_path["full"] = phase_full(torch, K, "full", "int8", 16, 16)
        free_card(torch, "full")  # two large-v3 copies need not coexist
    if "full_kv4" in phases:
        by_path["full_kv4"] = phase_full(torch, K, "full_kv4",
                                         "kv4+int8+lm4", 32, 32)
        free_card(torch, "full_kv4")
    if "capacity" in phases:
        by_path["capacity"] = phase_capacity(torch, K)
        free_card(torch, "capacity")
    if "beam" in phases:
        by_path["beam"] = phase_beam(torch, K)
        free_card(torch, "beam")
    print(f"total_s {time.perf_counter() - t_all:.1f}")

    rows = []
    for name, kern in K.KERNELS.items():
        m = measured.get(name, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": f"audio_rag_tpu_torch/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": sum(n.get(name, 0) for n in by_path.values()),
            **({"wgmma_launches": sum(n.get(WGMMA, 0)
                                      for n in by_path.values())}
               if name == FLASH else {}),
            "launches_by_path": {path: n[name] for path, n in by_path.items()
                                 if n.get(name)},
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms"),
            **({"contiguous": m.get("contiguous")} if name == FLASH else {}),
            **({"train": flash_grad} if name == FLASH and flash_grad
               else {}),
            **({"llm": m["llm"]} if "llm" in m else {}),
            "per": m.get("per"),
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
