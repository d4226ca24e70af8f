#!/usr/bin/env python3
"""Time the port's decode cross- and self-attention kernels at the main
path's calls, this tree's kernels against another tree's, in turns on one
card.

    python3 scripts/bench_cross.py [--parent DIR] [--rounds 2]

``--parent`` names another checkout of the repository (for example a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its ``audio_rag_tpu_torch/ops/kernels.py`` is loaded
as a module of its own and builds its sources into its own ``build/``. Each
round times the parent, then this tree, then this tree, then the parent
(``chip_smoke.time_ms``: mean of 20 calls, cold L2), on the same inputs.
Prints one JSON line per call and tree and a summary line; needs a CUDA
card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (kernel bits, B, H, M, hd, the path that makes the call), Ta = 1500
CALLS = [
    (8, 16, 20, 1, 64, "full"),
    (8, 16, 20, 5, 64, "beam (spine beam5+int8)"),
    (8, 16, 20, 8, 64, "a speculative verify block"),
    (4, 32, 20, 1, 64, "full_kv4"),
    (4, 16, 20, 5, 64, "beam"),
    (4, 16, 20, 1, 64, "capacity"),
    (4, 16, 20, 8, 64, "a speculative verify block"),
]
TA = 1500
#: (B, H, M, hd, Cp, n_valid, q dtype, the path that makes the call)
SELF_CALLS = [
    (16, 20, 1, 64, 256, 40, "bfloat16", "capacity"),
    (16, 20, 1, 64, 512, 300, "bfloat16", "capacity at Whisper's longest "
     "cache"),
    (1, 4, 1, 32, 128, 9, "float32", "spine int8+dec4+skv8"),
]


def load_kernels(root: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"cross_bench_{tag}", root / "audio_rag_tpu_torch" / "ops" /
        "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(torch, bits, B, H, M, hd):
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, H, M, hd), generator=g, device="cuda").bfloat16()
    rows = hd if bits == 8 else hd // 2
    k, v = (torch.randint(-127, 128, (B, H, rows, TA), generator=g,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    sc = (B, H, 1, 1) if bits == 8 else (B, H, 1, hd)
    ks, vs = (torch.rand(sc, generator=g, device="cuda") * 0.015 + 0.005
              for _ in range(2))
    return q, k, v, ks, vs


def self_inputs(torch, B, H, M, hd, Cp, n_valid, dtype):
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((B, H, M, hd), generator=g, device="cuda").to(
        getattr(torch, dtype))
    k8, v8 = (torch.randint(-127, 128, (B, H, hd, Cp), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    sc = torch.zeros((B, Cp, 128), device="cuda")
    sc[:, :, :2 * H] = torch.rand((B, Cp, 2 * H), generator=g,
                                  device="cuda") * 0.02 + 0.001
    sc[:, :, 2 * H] = torch.where(torch.arange(Cp, device="cuda") < n_valid,
                                  0.0, -1e30)
    return q, k8, v8, sc


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", flush=True)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    trees = {"change": load_kernels(ROOT, "change")}
    if args.parent is not None:
        trees["parent"] = load_kernels(args.parent.resolve(), "parent")
    names = ["decode_cross_attention_q8", "decode_cross_attention_q4"]
    self_name = "decode_self_attention_q8"
    for mod in trees.values():
        mod.build([*names, self_name])
    order = (["parent", "change", "change", "parent"] if "parent" in trees
             else ["change", "change"])
    print(cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    calls = []  # (kernel, inputs, shape, path, bytes, flops)
    for bits, B, H, M, hd, path in CALLS:
        rows = hd if bits == 8 else hd // 2
        calls.append((
            names[0] if bits == 8 else names[1],
            lambda bits=bits, B=B, H=H, M=M, hd=hd: inputs(
                torch, bits, B, H, M, hd),
            [B, H, M, hd, TA], path,
            B * H * M * hd * 2 + 2 * B * H * rows * TA
            + (8 * B * H if bits == 8 else 8 * B * H * hd)
            + 4 * B * H * M * hd, 4 * B * H * M * hd * TA))
    for B, H, M, hd, Cp, n_valid, dtype, path in SELF_CALLS:
        qbytes = 2 if dtype == "bfloat16" else 4
        calls.append((
            self_name,
            lambda c=(B, H, M, hd, Cp, n_valid, dtype): self_inputs(
                torch, *c),
            [B, H, M, hd, Cp], path,
            # the packed operand's lanes the function reads: [0, 2H]
            B * H * M * hd * qbytes + 2 * B * H * hd * Cp
            + 4 * B * Cp * (2 * H + 1) + 4 * B * H * M * hd,
            4 * B * H * M * hd * Cp))
    summary = []
    for name, make, shape, path, nbytes, flops in calls:
        args_ = make()
        ref = getattr(trees["change"], name + "_plain")(*args_)
        row = {"kernel": name, "shape": shape, "path": path}
        for tree in trees:
            fn = getattr(trees[tree], name)
            err = (fn(*args_) - ref).abs().max().item()
            row[f"{tree}_max_abs_err"] = err
        for _ in range(args.rounds):
            for tree in order:
                fn = getattr(trees[tree], name)
                row.setdefault(f"{tree}_ms", []).append(cs.time_ms(
                    torch, lambda: fn(*args_), flush=flush))
        row["bound_ms"], row["bound_by"] = cs.bound_ms(nbytes, flops, "bf16")
        print(json.dumps(row), flush=True)
        summary.append(row)
    print("summary", json.dumps([
        {"kernel": r["kernel"], "shape": r["shape"],
         **{k: min(v) for k, v in r.items() if k.endswith("_ms")
            and isinstance(v, list)}, "bound_ms": r["bound_ms"]}
        for r in summary]), flush=True)


if __name__ == "__main__":
    main()
