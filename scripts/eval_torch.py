#!/usr/bin/env python
"""Quality numbers of the PyTorch/CUDA port: the WER harness and the
retrieval-quality ladder (the port's counterpart of ``scripts/eval_wer.py``
and ``scripts/eval_quality.py``, with the same sets and the same JSON keys).

    python scripts/eval_torch.py wer [--profile f32|int8] [--n 64]
    python scripts/eval_torch.py quality [--audio]

``wer`` runs the committed trained tiny ASR (tiny-synth, VAD filter and
temperature ladder off) on the held-out charvoice set
(``default_rng(777)``), the 16 multi-window files and the set spoken by
the trained neural TTS; ``--profile f32`` is the record's (float32
weights), ``int8`` adds int8 cross K/V and decode weights. ``quality``
runs the ladder over the extended synthetic corpus with the trained
eval-small embedder and reranker; ``--audio`` first speaks every chunk
and transcribes it with the tiny ASR. The card runs it unless ``--cpu``.
Prints the JSON on the last line of stdout, or writes it to ``--out``
(never into ``docs/bench_runs/``, which holds the JAX package's records).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def run_wer(n: int, profile: str, device: str) -> dict:
    from audio_rag_tpu_torch.config import TTSConfig
    from audio_rag_tpu_torch.evaluation import wer_sets
    from audio_rag_tpu_torch.tts.neural import NeuralTTS

    asr = wer_sets.tiny_asr(profile, device)
    sets = wer_sets.make_sets(n)
    t0 = time.time()
    hyps = wer_sets.transcribe_all(asr, sets.wavs)
    stream_hyps = wer_sets.transcribe_all(asr, sets.stream_wavs)
    tts = NeuralTTS(TTSConfig(backend="jax"), device=device)
    tts.load()
    tts_hyps = wer_sets.transcribe_all(
        asr, [tts._synthesize_pcm(t) for t in wer_sets.tts_texts(sets)])
    print(f"transcribed the three sets in {time.time() - t0:.0f} s",
          file=sys.stderr)
    return wer_sets.wer_result(
        sets, hyps, stream_hyps, tts_hyps,
        note=f"committed trained tiny ASR (asr_tiny_synth.npz) on held-out "
             f"synthetic speech through the port's transcribe path, "
             f"profile {profile}, device {device}; baseline is the "
             f"reference's cited (never measured) large-v3 figure")


def run_quality(audio: bool, device: str) -> dict:
    from audio_rag_tpu_torch.evaluation.quality import (
        build_eval_setup,
        build_eval_setup_audio,
        run_quality_sweep,
    )

    t0 = time.time()
    build = build_eval_setup_audio if audio else build_eval_setup
    engines, corpus = build(device=device)
    print(f"built the {len(corpus.chunks)}-chunk index in "
          f"{time.time() - t0:.0f} s", file=sys.stderr)
    sweep = run_quality_sweep(engines, corpus.eval_set)
    hdr = (f"{'config':>16} | {'P@5':>6} | {'MRR':>6} | {'NDCG':>6} | "
           f"{'hit':>5} | per-type P@5 (para / tag / pair / ctx / mism)")
    print(hdr)
    print("-" * len(hdr))
    for cfg, m in sweep.items():
        bt = m["by_type"]
        per = " / ".join(
            f"{bt.get(t, {}).get('p_at_5', 0.0):.3f}"
            for t in ("paraphrase", "tag", "pair", "context", "mismatch"))
        print(f"{cfg:>16} | {m['p_at_5']:6.3f} | {m['mrr']:6.3f} | "
              f"{m['ndcg']:6.3f} | {m['hit_rate']:5.3f} | {per}")
    print()
    return {"metric": "quality_ladder_audio_in" if audio
            else "quality_ladder", "sweep": sweep}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--out", default=None, help="write the JSON here")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_wer = sub.add_parser("wer", help="WER of the trained tiny ASR")
    p_wer.add_argument("--n", type=int, default=64)
    p_wer.add_argument("--profile", default="f32",
                       choices=("f32", "int8"))
    p_q = sub.add_parser("quality", help="the retrieval-quality ladder")
    p_q.add_argument("--audio", action="store_true",
                     help="speak and transcribe the corpus first")
    args = ap.parse_args()

    if args.out:
        out = Path(args.out).resolve()
        if (REPO / "docs" / "bench_runs") in out.parents:
            ap.error("--out may not point into docs/bench_runs/")
    device = "cpu" if args.cpu else "cuda"
    result = (run_wer(args.n, args.profile, device) if args.cmd == "wer"
              else run_quality(args.audio, device))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
