#!/usr/bin/env python3
"""Time ``matmul_q8w`` / ``matmul_q4w`` launch plans on the card.

For each weight matmul of a Whisper large-v3 decode step (and its logits
head) at 16, 32 and 80 x rows (``--model llama-3.2-3b``: of a llama-3.2-3b
decode step under ``decoder_int8``, and its int4 head, at 1 and 16 rows),
runs the plan ``wq_plan`` picks and a set of
other plans (warp grids, din splits, ring depths) through
``kernels.wq_launch``, checks each result against the plain version, and
prints one JSON line per plan with its device ms (cold L2, as in
``chip_smoke.time_ms``), then the best plan per shape beside the chosen one.
Run from the repository root on a machine with one CUDA card:

    python3 scripts/sweep_wq_plan.py [--model large-v3|llama-3.2-3b]
        [--iters 20] [--out FILE]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [  # (bits, B, din, dout, group)
    *[(8, B, din, dout, None) for B in (16, 32, 80)
      for din, dout in ((1280, 1280), (1280, 5120), (5120, 1280),
                        (1280, 51968))],
    *[(4, B, din, dout, 128 if din == 5120 else 80) for B in (16, 32, 80)
      for din, dout in ((1280, 1280), (1280, 5120), (5120, 1280),
                        (1280, 51968))],
]

LLM_SHAPES = [
    *[(8, B, din, dout, None) for B in (1, 16)
      for din, dout in ((3072, 5120), (3072, 3072), (3072, 16384),
                        (8192, 3072), (3072, 128256))],
    *[(4, B, 3072, 128256, 128) for B in (1, 16)],
]


def candidates(K, bits, B, din, dout, group):
    """The chosen plan first, then its neighbours that the kernel takes."""
    base = K.wq_plan(B, din, dout, bits=bits, group=group)
    yield base
    n_stages = -(-din // K.WQ_STAGE_K)
    for wn, splits, stages in itertools.product(
            (2, 4, 8), range(1, 9), (2, 3, 4, 6)):
        if splits > n_stages:
            continue
        k_stages = -(-n_stages // splits)
        splits = -(-n_stages // k_stages)
        wk = K.WQ_WARPS // wn
        bn = K.WQ_WARP_COLS * wn
        slot = K.wq_slot_bytes(bits, wn, base.nt)
        smem = max(stages * slot, K.wq_reduce_bytes(wn, wk, base.nt),
                   K.wq_part_bytes(wn, base.nt) if splits > 1 else 0)
        if smem > K.WQ_SMEM_MAX or stages > k_stages + 1:
            continue
        plan = base._replace(wn=wn, wk=wk, splits=splits,
                             k_per_split=k_stages * K.WQ_STAGE_K,
                             stages=stages, smem=smem,
                             col_tiles=-(-dout // bn))
        if plan != base:
            yield plan


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="large-v3",
                    choices=("large-v3", "llama-3.2-3b"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line, time_ms
    from audio_rag_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    print(card_line(), flush=True)
    K.build(["matmul_q8w", "matmul_q4w"])
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    lines, best = [], {}
    shapes = SHAPES if args.model == "large-v3" else LLM_SHAPES
    for bits, B, din, dout, group in shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((B, din), generator=g, device="cuda").bfloat16()
        if bits == 8:
            name = "matmul_q8w"
            w = torch.randint(-127, 128, (din, dout), generator=g,
                              device="cuda", dtype=torch.int8)
            s = torch.rand((dout,), generator=g, device="cuda") * 0.01
            ref = K.matmul_q8w_plain(x, w, s)
        else:
            name = "matmul_q4w"
            w = torch.randint(-128, 128, (din // 2, dout), generator=g,
                              device="cuda", dtype=torch.int8)
            s = torch.rand((din // group, dout), generator=g,
                           device="cuda") * 0.01
            ref = K.matmul_q4w_plain(x, w, s)
        tol = 1e-3 * ref.abs().max().item()
        key = f"{name} B={B} {din}->{dout}"
        for i, plan in enumerate(candidates(K, bits, B, din, dout, group)):
            err = (K.wq_launch(name, x, w, s, plan) - ref).abs().max().item()
            ms = time_ms(torch, lambda: K.wq_launch(name, x, w, s, plan),
                         iters=args.iters, flush=flush)
            row = {"shape": key, "chosen": i == 0,
                   "plan": dict(zip(("nt", "wn", "wk", "splits",
                                     "k_per_split", "stages"), plan[:6])),
                   "blocks": plan.blocks, "ms": ms, "max_abs_err": err,
                   "ok": err <= tol}
            lines.append(row)
            print(json.dumps(row), flush=True)
            if row["ok"] and (key not in best or ms < best[key]["ms"]):
                best[key] = row
        del x, w, s, ref
    chosen = {r["shape"]: r for r in lines if r["chosen"]}
    for key, row in best.items():
        print(json.dumps({"shape": key, "chosen_ms": chosen[key]["ms"],
                          "best_ms": row["ms"], "best_plan": row["plan"]}))
    if args.out is not None:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    if not all(r["ok"] for r in lines):
        sys.exit("a plan disagrees with the plain version")


if __name__ == "__main__":
    main()
