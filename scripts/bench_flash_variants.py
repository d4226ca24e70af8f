#!/usr/bin/env python3
"""Time design alternatives of ``flash_attention``'s wgmma kernel on the card.

Builds ``audio_rag_tpu_torch/csrc/flash_attention.cu`` with its defaults
and with each of its compile-time switches changed (``FLASH_WG_CONSUMERS``
2: two consumer warpgroups of 64 query rows instead of three;
``FLASH_WG_STAGES`` 3 or 4: a K/V ring of 3 or 4 slots instead of 2;
``FLASH_WG_TURNS`` 0: the consumers' turn-taking barriers left out), each
into its own library under ``build/kernels/`` (``kernels.build(defines=...)``).
Every variant is checked against the plain version and timed at the Whisper
large-v3 encoder's call, (16, 20, 1500, 64) bf16 on the head-strided view
of (B, T, H, D) projections, in two rounds of alternating order, beside
``scaled_dot_product_attention`` on the same tensors (cold L2, as in
``chip_smoke.time_ms``). Then, for the defaults and SDPA, the time at 1500
queries against 128 … 6144 keys, whose slope and intercept split a work
item's cost per key tile from its fixed cost. Prints one JSON line per
measurement. Run from the repository root on a machine with one card:

    python3 scripts/bench_flash_variants.py [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLASH = "flash_attention"
VARIANTS = {
    "defaults (3 consumers, 2 slots, turns)": (),
    "2 consumers (128 query rows an item)": ("FLASH_WG_CONSUMERS=2",),
    "3 K/V slots": ("FLASH_WG_STAGES=3",),
    "4 K/V slots": ("FLASH_WG_STAGES=4",),
    "no turn-taking barriers": ("FLASH_WG_TURNS=0",),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from audio_rag_tpu_torch.ops import kernels as K
    from chip_smoke import card_line, time_ms

    print(card_line(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc a variant
        list(pool.map(lambda d: K.build([FLASH], defines=d),
                      VARIANTS.values()))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def encoder_view(B, T, H, D):
        return torch.randn((B, T, H, D), generator=g, device="cuda") \
            .bfloat16().transpose(1, 2)

    q, k, v = (encoder_view(16, 1500, 20, 64) for _ in range(3))
    ref = K.flash_attention_plain(q, k, v).float()
    tol = 2.0 ** -7 * max(1.0, ref.abs().max().item())
    sdpa = torch.nn.functional.scaled_dot_product_attention

    try:
        for rnd in range(2):
            names = list(VARIANTS)
            for name in (names if rnd == 0 else names[::-1]):
                K.load(FLASH, VARIANTS[name])
                K.reset_launches()
                err = (K.flash_attention(q, k, v).float() - ref).abs().max()
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name, "round": rnd,
                    "kernel": [n for n, c in K.FLASH_VARIANTS.items() if c],
                    "max_abs_err": err.item(), "tol": tol,
                    "ms": time_ms(torch, lambda: K.flash_attention(q, k, v),
                                  args.iters, flush),
                    "sdpa_ms": time_ms(torch, lambda: sdpa(q, k, v),
                                       args.iters, flush)}), flush=True)
        K.load(FLASH)
        for tk in (128, 384, 768, 1536, 3072, 6144):
            kk, vv = (encoder_view(16, tk, 20, 64) for _ in range(2))
            print(json.dumps({
                "keys": tk, "queries": 1500,
                "ms": time_ms(torch, lambda: K.flash_attention(q, kk, vv),
                              args.iters, flush),
                "sdpa_ms": time_ms(torch, lambda: sdpa(q, kk, vv),
                                   args.iters, flush)}), flush=True)
    finally:
        K.load(FLASH)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)


if __name__ == "__main__":
    main()
