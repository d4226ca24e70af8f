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
              card at small ragged shapes and at the Whisper large-v3
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

The native audio runtime (``audio_rag_tpu_torch/csrc/audio_native.cpp``,
g++ into ``build/native/``) is built or loaded right after the kernels;
the script fails without it, so the word-time DTW of every ingest runs in
C. ``diarize`` runs right after ``spine``, ``fallback`` after ``diarize``,
``query`` after ``fallback``.
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
    print(f"FAIL: {msg}", flush=True)
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
                     "32×1280→5120, 32×5120→1280, 1×1280→51968)"},
        CROSS8: {**agg(large[CROSS8], [1]),
                 "per": "call at (16, 20, 1, 64), Ta=1500 "
                        "(one layer, one step)"},
        CROSS4: {**agg(large[CROSS4], [1]),
                 "per": "call at (32, 20, 1, 64), Ta=1500 "
                        "(one layer, one step, window batch 32)"},
        Q4W: {**agg(large[Q4W], [1]),
              "per": "call at B=32, 1280→51968, group 80 (the benchmark "
                     "profile's logits head, once per step)"},
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


def spine_corpus():
    """The spine's three turns and 21 distractor chunks (seed 11), with a
    "kind" to filter on."""
    import numpy as np

    from audio_rag_tpu_torch.core.types import AudioChunk

    rng = np.random.default_rng(11)
    words = ("model data signal window audio chunk query vector fusion "
             "rank weight step update noise speech meeting lecture "
             "gradient spectrogram attention").split()
    texts = list(SPINE_TURNS) + [" ".join(rng.choice(words, 8).tolist())
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


def large_v3_config(device: str, profile: str, window_batch: int,
                    **asr_fields):
    """The large-v3 paths' config: greedy at temperature 0 in English, as
    ``bench.py`` measures it, unless ``asr_fields`` say otherwise."""
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, EmbeddingConfig,
        RerankingConfig)

    fields = {"language": "en", "temperature_fallback": False, **asr_fields}
    return AudioRAGConfig(
        asr=ASRConfig(model_size="large-v3", compute_type="bfloat16",
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


def free_card(torch) -> None:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,spine,diarize,fallback,query,"
                            "full,full_kv4,capacity,beam",
                    help="comma-separated subset of build,kernels,spine,"
                         "diarize,fallback,query,full,full_kv4,capacity,"
                         "beam")
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
        if "diarize" in phases:
            by_path.update(phase_diarize(torch, K, Path(tmp)))
            free_card(torch)
    if "fallback" in phases:
        by_path.update(phase_fallback(torch, K))
        free_card(torch)
    if "query" in phases:
        by_path.update(phase_query(torch, K))
        free_card(torch)
    if "full" in phases:
        by_path["full"] = phase_full(torch, K, "full", "int8", 16, 16)
        free_card(torch)  # two large-v3 copies need not coexist
    if "full_kv4" in phases:
        by_path["full_kv4"] = phase_full(torch, K, "full_kv4",
                                         "kv4+int8+lm4", 32, 32)
        free_card(torch)
    if "capacity" in phases:
        by_path["capacity"] = phase_capacity(torch, K)
        free_card(torch)
    if "beam" in phases:
        by_path["beam"] = phase_beam(torch, K)
        free_card(torch)
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
            "per": m.get("per"),
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
