#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``audio_rag_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and imports nothing of JAX or of
the JAX package. Phases (any failure exits non-zero):

1. build   — nvcc-builds the port's three kernels (one process per source,
             all started together) and prints the seconds it took;
2. kernels — holds each kernel against its plain PyTorch version on the card
             at a small shape and at the Whisper large-v3 shapes, printing
             the error, tolerance, kernel / plain / library ms and bound;
3. spine   — ingests three spoken turns (tiny-synth ASR + eval-small
             embedder, committed trained weights, int8 decode profile)
             through ``AudioRAG`` and checks that hybrid queries retrieve
             the chunk with the spoken words, and that every kernel ran;
4. full    — the same ingest → query path with Whisper large-v3 shapes
             (seeded weights) in the production decode profile on 16 windows
             (8 min) of speech: first-step logits against the plain path on
             the card, a traced window of decode steps (host ms and device
             busy ms per step, top kernels), encode ms per window batch,
             decode ms, RTF, peak memory, kernel launches.

TF32 is switched off for matmuls and cuDNN so f32 references are f32. The
second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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

# the logits head pads the vocab to a multiple of 128 (51866 → 51968)
LARGE_V3_Q8W = [  # (din, dout, calls per decode step)
    (1280, 1280, 6 * 32),  # attention q/k/v/o + cross q/o, 32 layers
    (1280, 5120, 32),      # MLP up
    (5120, 1280, 32),      # MLP down
    (1280, 51968, 1),      # logits head
]


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

def _flash_case(torch, K, shape, dtype, flush, timed, kv_len=None):
    B, H, T, D = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    got = K.flash_attention(q, k, v, kv_len)
    ref = K.flash_attention_plain(q, k, v, kv_len)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        # f32 sums over up to Tk keys in another order, expf vs torch.exp
        tol = 1e-4
    else:
        # bf16 output (ulp 2^-8 relative); the tensor-core path also rounds
        # the probabilities to bf16 before P·V, as a default-precision dot
        # on the TPU does: allow two output ulps at the largest value
        tol = 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
    row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "kv_len": kv_len, "max_abs_err": err, "tol": tol}
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
    return row, err <= tol


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
    ok = bool((err_el <= tol_el).all())
    row = {"shape": [B, din, dout], "dtype": str(xdtype).split(".")[-1],
           "max_abs_err": err_el.max().item(),
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
    row = {"shape": [B, H, M, hd, Ta], "dtype": str(qdtype).split(".")[-1],
           "max_abs_err": err, "tol": tol}
    if timed:
        row["ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q8(q, k8, v8, ks, vs),
            flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: K.decode_cross_attention_q8_plain(q, k8, v8, ks, vs),
            flush=flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound_ms(
            B * H * M * hd * q.element_size() + 2 * B * H * hd * Ta
            + 8 * B * H + 4 * B * H * M * hd, 4 * B * H * M * hd * Ta,
            "bf16")
    return row, err <= tol


def phase_kernels(torch, K) -> dict:
    """Every kernel against its plain version; returns the JSON rows'
    measured fields at the large-v3 main-path shapes."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    bad = []
    cases = [
        ("flash_attention", lambda t: _flash_case(
            torch, K, (3, 4, 300, 32), torch.float32, flush, t), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (2, 3, 77, 80), torch.bfloat16, flush, t), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (1, 2, 333, 128), torch.bfloat16, flush, t, 300),
            False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (2, 3, 100, 40), torch.bfloat16, flush, t), False),
        ("flash_attention", lambda t: _flash_case(
            torch, K, (16, 20, 1500, 64), torch.bfloat16, flush, t), True),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 3, 128, 512, torch.float32, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(
            torch, K, 5, 200, 72, torch.bfloat16, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(   # two 16-row chunks of x
            torch, K, 37, 300, 260, torch.float32, flush, t), False),
        ("matmul_q8w", lambda t: _q8w_case(   # byte loads, din split
            torch, K, 20, 1300, 77, torch.bfloat16, flush, t), False),
        *[("matmul_q8w", (lambda din, dout: lambda t: _q8w_case(
            torch, K, 16, din, dout, torch.bfloat16, flush, t))(din, dout),
            True) for din, dout, _ in LARGE_V3_Q8W],
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 3, 4, 1, 32, 300, torch.float32, flush, t), False),
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 2, 3, 5, 64, 301, torch.bfloat16, flush, t), False),
        ("decode_cross_attention_q8", lambda t: _cross_case(
            torch, K, 16, 20, 1, 64, 1500, torch.bfloat16, flush, t), True),
    ]
    large: dict[str, list[dict]] = {name: [] for name in K.KERNELS}
    for name, case, timed in cases:
        row, ok = case(timed)
        torch.cuda.synchronize()
        print(f"kernel {name} {json.dumps(row)} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            bad.append(f"{name} {row['shape']}")
        if timed:
            large[name].append(row)
    if bad:
        fail("kernel disagrees with its plain version: " + ", ".join(bad))

    # one JSON row per kernel at the full-width main path's shapes: flash
    # and cross per layer call; matmul_q8w summed over one decode step
    def agg(name, rows, weights):
        out = {"max_abs_err": max(r["max_abs_err"] for r in rows)}
        for key in ("ms", "plain_ms", "bound_ms"):
            out[key] = sum(w * r[key] for w, r in zip(weights, rows))
        libs = [r["library_ms"] for r in rows]
        out["library_ms"] = (None if any(x is None for x in libs)
                             else sum(w * x for w, x in zip(weights, libs)))
        by = {r["bound_by"] for r in rows}
        out["bound_by"] = by.pop() if len(by) == 1 else "bytes"
        return out

    return {
        "flash_attention": {**agg("flash_attention", large["flash_attention"],
                                  [1]),
                            "per": "call at (16, 20, 1500, 64) bf16 "
                                   "(one encoder layer, 16 windows)"},
        "matmul_q8w": {**agg("matmul_q8w", large["matmul_q8w"],
                             [c for _, _, c in LARGE_V3_Q8W]),
                       "per": "decode step: 257 calls at B=16 "
                              "(192×1280², 32×1280→5120, 32×5120→1280, "
                              "1×1280→51968)"},
        "decode_cross_attention_q8": {
            **agg("decode_cross_attention_q8",
                  large["decode_cross_attention_q8"], [1]),
            "per": "call at (16, 20, 1, 64), Ta=1500 (one layer, one step)"},
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


def spine_config(device: str, int8: bool):
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, EmbeddingConfig,
        RetrievalConfig)

    return AudioRAGConfig(
        asr=ASRConfig(model_size="tiny-synth", compute_type="float32",
                      cross_kv_int8=int8, decoder_int8=int8),
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        # small max_tokens: each 6 s window's segment becomes its own chunk
        chunking=ChunkingConfig(max_tokens=8, min_chunk_tokens=1,
                                overlap_tokens=0),
        device=device)


def run_spine(device: str, int8: bool, workdir: Path) -> dict:
    """Ingest the three turns and run both queries; returns what it saw."""
    import numpy as np

    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.audio.io import write_wav
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(spine_config(device, int8))
    wav_path = workdir / "lecture.wav"
    audio = speak(SPINE_TURNS, np.random.default_rng(7),
                  rag.asr.window_seconds)
    write_wav(wav_path, audio, SR)
    rag.asr  # load the models outside the timed ingest
    rag.embedder
    t0 = time.perf_counter()
    res = rag.ingest(str(wav_path), collection="spine")
    ingest_s = time.perf_counter() - t0
    out = {"chunks": res.num_chunks, "ingest_ms": ingest_s * 1e3,
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


def phase_spine(torch, K, workdir: Path) -> dict:
    K.reset_launches()
    out = run_spine("cuda", int8=True, workdir=workdir)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print("spine transcripts (chunk texts):", json.dumps(out["transcripts"]))
    print(f"spine chunks {out['chunks']} ingest_ms {out['ingest_ms']:.1f}")
    for q in out["queries"]:
        print(f"spine query {q['query']!r} ms {q['ms']:.1f} "
              f"top {json.dumps(q['top'])} {'ok' if q['ok'] else 'MISS'}")
    print("spine launches", json.dumps(launches), flush=True)
    if out["chunks"] < 2:
        fail(f"spine produced {out['chunks']} chunk(s); expected several")
    if not all(q["ok"] for q in out["queries"]):
        fail("spine: a query's top hit lacks its spoken words")
    if not all(n > 0 for n in launches.values()):
        fail(f"spine: a kernel never launched: {launches}")
    return launches


def full_config(device: str):
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ChunkingConfig, EmbeddingConfig)

    # configs/production.yaml's decode profile at large-v3 shapes
    return AudioRAGConfig(
        asr=ASRConfig(model_size="large-v3", compute_type="bfloat16",
                      cross_kv_int8=True, decoder_int8=True,
                      window_batch_size=16, max_decode_tokens=32,
                      language="en", seed=0),
        embedding=EmbeddingConfig(model="eval-small"),
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
    path of the logits check only)."""
    saved = {name: getattr(K, name) for name in K.KERNELS}
    for name in K.KERNELS:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def prime_decoder(torch, asr, wav):
    """Encode the first window batch and prime the decoder with the prompt
    (int8 cross K/V and weights, as the production profile runs it).
    Returns the first decode step's logits and the decoder state."""
    import numpy as np

    from audio_rag_tpu_torch.models.whisper import (
        decoder_step, encode, precompute_cross_kv)
    from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, log_mel_batch

    dims, st = asr.dims, asr.tokens
    n = 2 * dims.n_audio_ctx * HOP_LENGTH
    B = asr.config.window_batch_size
    win = torch.from_numpy(np.ascontiguousarray(
        wav[: B * n].reshape(B, n))).cuda()
    with torch.inference_mode():
        mel = log_mel_batch(win, n_mels=dims.n_mels)
        enc = encode(asr._params, dims, mel, dtype=asr.dtype)
        ckv = precompute_cross_kv(asr._params, dims, enc, asr.dtype,
                                  quantize=True)
        hd = dims.n_text_state // dims.n_text_head
        sk = torch.zeros((dims.n_text_layer, B, dims.n_text_head, 36, hd),
                         dtype=asr.dtype, device="cuda")
        sv = torch.zeros_like(sk)
        prompt = torch.tensor([[st.sot, st.lang_base, st.transcribe,
                                st.no_timestamps]] * B, device="cuda")
        for t in range(prompt.shape[1]):
            logits, (sk, sv) = decoder_step(
                asr._params, dims, prompt[:, t:t + 1], ckv, t, (sk, sv),
                dtype=asr.dtype, q8=asr._params_q8)
    return logits.float(), {"ckv": ckv, "cache": (sk, sv),
                            "pos": prompt.shape[1]}


def profile_decode(torch, asr, logits, state, steps: int = 8) -> dict:
    """``steps`` greedy decode steps timed on the host clock, then ``steps``
    more under torch.profiler: device kernel time per step, the device's
    busy share of the traced window, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_rag_tpu_torch.models.whisper import decoder_step

    tok = logits.argmax(-1, keepdim=True)
    pos, cache = state["pos"], state["cache"]

    def run() -> float:
        nonlocal tok, pos, cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            out, cache = decoder_step(
                asr._params, asr.dims, tok, state["ckv"], pos, cache,
                dtype=asr.dtype, q8=asr._params_q8)
            tok = out.argmax(-1, keepdim=True)
            pos += 1
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "decode_ms_per_step": host_ms / steps,
            "traced_host_ms_per_step": traced_ms / steps,
            "device_busy_ms_per_step": (busy_ms / steps if kernels
                                        else "not measured"),
            "device_busy_share_traced": (busy_ms / traced_ms if kernels
                                         else None),
            "kernel_launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": {name[:60]: ms / steps
                                        for name, ms in top}}


def phase_full(torch, K) -> dict:
    from audio_rag_tpu_torch.audio.charvoice import SR
    from audio_rag_tpu_torch.pipeline import AudioRAG

    seconds = 16 * 30.0
    wav = long_speech(seconds)
    rag = AudioRAG(full_config("cuda"))
    t0 = time.perf_counter()
    asr = rag.asr
    rag.embedder
    torch.cuda.synchronize()
    print(f"full load_s {time.perf_counter() - t0:.2f} (seeded large-v3 "
          "weights + int8 decode tree)", flush=True)

    # first-step logits: kernels against plain versions, same inputs
    got, state = prime_decoder(torch, asr, wav)
    with plain_kernels(K):
        ref = prime_decoder(torch, asr, wav)[0]
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # bf16 activations through 32+32 layers: a one-ulp flip early on grows;
    # hold the kernels' logits within 5% of the logits' range
    tol = 0.05 * scale
    print(f"full first-step logits max_abs_err {err:.5f} tol {tol:.5f} "
          f"(max|logit| {scale:.4f}) argmax agreement {agree:.3f}",
          flush=True)
    if not math.isfinite(err) or err > tol:
        fail("full: first-step logits disagree with the plain path")
    # a traced window of decode steps, outside the main path's run
    print("full decode profile", json.dumps(
        profile_decode(torch, asr, got, state)), flush=True)
    del state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res = rag.ingest(wav, sample_rate=SR, collection="full")
    hits = rag.query("gradient descent", top_k=3, collection="full").results
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    tm = asr.timings
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {
        "windows": tm["windows"], "batches": tm["batches"],
        "encode_ms_per_batch": tm["encode_s"] / tm["batches"] * 1e3,
        # cross K/V precompute, 4 prompt steps and the greedy loop's steps
        "decode_ms": tm["decode_s"] * 1e3,
        "decode_loop_steps": tm["decode_steps"],
        "mel_ms": tm["mel_s"] * 1e3,
        "transcribe_s": res.stage_timings["transcribe"],
        "rtf": res.stage_timings["transcribe"] / seconds,
        "ingest_query_s": wall, "chunks": res.num_chunks,
        "segments": res.num_segments, "hits": len(hits),
        "peak_mem_gb": peak_gb, "launches": launches,
    }
    print("full", json.dumps(out), flush=True)
    if tm["windows"] != 16 or not hits:
        fail(f"full: expected 16 windows and search hits, got {out}")
    if not all(n > 0 for n in launches.values()):
        fail(f"full: a kernel never launched: {launches}")
    if not all(math.isfinite(h.score) for h in hits):
        fail("full: non-finite scores")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,spine,full",
                    help="comma-separated subset of build,kernels,spine,full")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / "audio_rag_tpu_torch" / "ops" / "kernels.py").is_file():
        fail("audio_rag_tpu_torch is not beside this script")
    sys.path.insert(0, str(ROOT))
    from audio_rag_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")
    print(card_line())  # nvidia-smi's name and power limit, as it gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    report = K.build(verbose="build" in phases)
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)
    for name, rep in report.items():
        if rep["log"]:
            print(f"--- nvcc {name} ({rep['seconds']:.1f} s)\n{rep['log']}")

    measured: dict = {}
    launches: dict = {}
    if "kernels" in phases:
        measured = phase_kernels(torch, K)
    with tempfile.TemporaryDirectory() as tmp:
        if "spine" in phases:
            launches = phase_spine(torch, K, Path(tmp))
    if "full" in phases:
        launches = phase_full(torch, K)
    print(f"total_s {time.perf_counter() - t_all:.1f}")

    sources = {"flash_attention": "flash_attention.cu",
               "matmul_q8w": "matmul_q8w.cu",
               "decode_cross_attention_q8": "decode_cross_q8.cu"}
    replaces = {
        "flash_attention": "audio_rag_tpu/ops/pallas_kernels.py:688",
        "matmul_q8w": "audio_rag_tpu/ops/pallas_kernels.py:368",
        "decode_cross_attention_q8": "audio_rag_tpu/ops/pallas_kernels.py:92",
    }
    rows = []
    for name in K.KERNELS:
        m = measured.get(name, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": f"audio_rag_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches.get(name, 0),
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"), "library_ms": m.get("library_ms"),
            "per": m.get("per"),
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
