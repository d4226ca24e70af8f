#!/usr/bin/env python3
"""Where a decode self-attention block spends its time, on the card.

    python3 scripts/probe_self_phases.py

Builds ``csrc/decode_self_q8.cu`` with ``-DSELF_PROFILE=1`` (thread 0 of
each block records clock64 at every phase boundary, its SM and its start
and end on the global timer), runs the main-path calls, and prints per
call: the kernel's time (``chip_smoke.time_ms``), the occupancy the runtime
reports, the mean cycles of each phase over the blocks, a block's mean
lifetime, the span of the launch on the global timer and how many
blocks an SM held at once; and the call's time with the L2 left dirty by
the flush (``chip_smoke.time_ms``, as the kernels phase times), with the
L2 full of clean lines (the flush buffer read instead of written) and warm
(no flush). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PHASES = ["prologue: q's pieces, copies issued",
          "scores, K slices as they land", "softmax, the pieces of p * vs",
          "P.V, once its V slice landed"]
#: (B, H, M, hd, Cp, n_valid, the path that makes the call), q bf16
CALLS = [(16, 20, 1, 64, 256, 40, "capacity"),
         (16, 20, 1, 64, 512, 300, "capacity at Whisper's longest cache"),
         (1, 4, 1, 32, 128, 9, "spine int8+dec4+skv8")]


class ReadFlush:
    """Stands in for ``chip_smoke.time_ms``'s flush buffer: reading it
    instead of writing it leaves the L2 full of clean lines."""

    def __init__(self, torch, buf):
        self.torch, self.buf = torch, buf
        self.out = buf.new_empty(())

    def zero_(self):
        self.torch.sum(self.buf, dim=0, out=self.out)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", flush=True)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from audio_rag_tpu_torch.ops import kernels as K
    from scripts.bench_cross import self_inputs

    name = "decode_self_attention_q8"
    print(cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    K.load(name, ("SELF_PROFILE=1",))
    lib = K._libs[name]
    for B, H, M, hd, Cp, n_valid, path in CALLS:
        q, k8, v8, sc = self_inputs(torch, B, H, M, hd, Cp, n_valid,
                                    "bfloat16")

        def call():
            return K.decode_self_attention_q8(q, k8, v8, sc)

        err = (call() - K.decode_self_attention_q8_plain(q, k8, v8, sc)) \
            .abs().max().item()
        ms = cs.time_ms(torch, call, flush=flush)
        ms_clean = cs.time_ms(torch, call, flush=ReadFlush(torch, flush))
        ms_warm = cs.time_ms(torch, call)
        plan = K.self_plan(hd, Cp, M)
        flush.zero_()
        K.decode_self_attention_q8(q, k8, v8, sc)
        torch.cuda.synchronize()
        n = min(B * H, 4096)
        buf = (ctypes.c_longlong * (16 * n))()
        assert lib.decode_self_profile(buf, n) == 0
        per_sm = ctypes.c_int()
        assert lib.decode_self_occupancy(plan.smem, ctypes.byref(per_sm)) == 0
        rows = [buf[16 * b:16 * b + 16] for b in range(n)]
        phases = {PHASES[i]: sum(r[i + 1] - r[i] for r in rows) / n
                  for i in range(len(PHASES))}
        life = sum(r[len(PHASES)] - r[0] for r in rows) / n
        starts = [(r[13], r[14], r[15]) for r in rows]
        t0 = min(s for _, s, _ in starts)
        by_sm: dict[int, list] = {}
        for sm, s, e in starts:
            by_sm.setdefault(sm, []).append((s, e))
        most = max(sum(1 for s2, e2 in iv if s2 <= s < e2)
                   for iv in by_sm.values() for s, _ in iv)
        print(json.dumps({
            "kernel": name, "shape": [B, H, M, hd, Cp], "path": path,
            "max_abs_err": err, "ms": ms, "ms_clean_l2": ms_clean,
            "ms_warm_l2": ms_warm, "plan": list(plan), "blocks": B * H,
            "occupancy_blocks_per_sm": per_sm.value,
            "most_blocks_on_an_sm_at_once": most, "sms_used": len(by_sm),
            "profiled_span_us": (max(e for _, _, e in starts) - t0) / 1e3,
            "last_block_start_us": (max(s for _, s, _ in starts) - t0) / 1e3,
            "first_block_end_us": (min(e for _, _, e in starts) - t0) / 1e3,
            "block_lifetime_cycles": life, "phase_cycles": phases}),
            flush=True)
    K.load(name)


if __name__ == "__main__":
    main()
