#!/usr/bin/env python3
"""Where a decode cross-attention block spends its time, on the card.

    python3 scripts/probe_cross_phases.py

Builds ``csrc/decode_cross_q8.cu`` and ``decode_cross_q4.cu`` with
``-DXQ_PROFILE=1`` (thread 0 of each block records clock64 at every phase
boundary, its SM and its start and end on the global timer), runs each
main-path call, and prints per call: the kernel's time (``chip_smoke.time_ms``),
the occupancy the runtime reports, the mean cycles of each phase over the
blocks, within the ring loop the cycles thread 0 spent issuing copies,
waiting for a stage and computing, a block's mean lifetime, and how many
blocks an SM held at once.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PHASES = ["q pieces", "pass 1: K stages, scores", "the max, p pieces",
          "pass 2: V stages, P.V", "the warps' sums, output"]
CALLS = [(8, 16, 20, 1, "full"), (8, 16, 20, 5, "beam"),
         (4, 32, 20, 1, "full_kv4"), (4, 16, 20, 5, "beam"),
         (4, 16, 20, 1, "capacity")]
TA, HD = 1500, 64


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", flush=True)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from audio_rag_tpu_torch.ops import kernels as K

    print(cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for variant in (("XQ_PROFILE=1",),):
        for bits, B, H, M, path in CALLS:
            name = f"decode_cross_attention_q{bits}"
            K.load(name, variant)
            lib = K._libs[name]
            g = torch.Generator(device="cuda").manual_seed(3)
            q = torch.randn((B, H, M, HD), generator=g, device="cuda") \
                .bfloat16()
            rows = HD if bits == 8 else HD // 2
            k, v = (torch.randint(-127, 128, (B, H, rows, TA), generator=g,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2))
            sc = (B, H, 1, 1) if bits == 8 else (B, H, 1, HD)
            ks, vs = (torch.rand(sc, generator=g, device="cuda") * 0.01
                      for _ in range(2))
            fn = getattr(K, name)
            ms = cs.time_ms(torch, lambda: fn(q, k, v, ks, vs), flush=flush)
            plan = K.cross_plan(bits, HD, TA, M)
            flush.zero_()
            fn(q, k, v, ks, vs)
            torch.cuda.synchronize()
            blocks = B * H
            n = min(blocks, 4096)
            buf = (ctypes.c_longlong * (16 * n))()
            assert lib.decode_cross_profile(buf, n) == 0
            per_sm = ctypes.c_int()
            assert lib.decode_cross_occupancy(
                bits, plan.smem, ctypes.byref(per_sm)) == 0
            rows_ = [buf[16 * b:16 * b + 16] for b in range(n)]
            phases = {PHASES[i]: sum(r[i + 1] - r[i] for r in rows_) / n
                      for i in range(len(PHASES))}
            life = sum(r[len(PHASES)] - r[0] for r in rows_) / n
            starts = [(r[13], r[14], r[15]) for r in rows_]
            t0 = min(s for _, s, _ in starts)
            span_us = (max(e for _, _, e in starts) - t0) / 1e3
            most = 0
            by_sm: dict[int, list] = {}
            for sm, s, e in starts:
                by_sm.setdefault(sm, []).append((s, e))
            for iv in by_sm.values():
                for s, _ in iv:
                    most = max(most, sum(1 for s2, e2 in iv if s2 <= s < e2))
            loop = {name: sum(r[8 + i] for r in rows_) / n for i, name in
                    enumerate(("issue", "wait for the stage",
                               "compute a stage"))}
            print(json.dumps({
                "variant": list(variant), "kernel": name,
                "shape": [B, H, M, HD, TA], "path": path, "ms": ms,
                "blocks": blocks, "smem": plan.smem,
                "occupancy_blocks_per_sm": per_sm.value,
                "most_blocks_on_an_sm_at_once": most,
                "sms_used": len(by_sm), "profiled_span_us": span_us,
                "block_lifetime_cycles": life,
                "phase_cycles": phases,
                "ring_loop_cycles_thread_0": loop}), flush=True)
    for name in ("decode_cross_attention_q8", "decode_cross_attention_q4"):
        K.load(name)


if __name__ == "__main__":
    main()
