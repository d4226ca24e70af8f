#!/usr/bin/env python
"""audio-rag CLI on the PyTorch/CUDA port (``audio_rag_tpu_torch``).

The subcommands, flags and output of ``scripts/run.py`` over the port's
``AudioRAG``: ``ingest`` / ``query`` / ``status`` / ``clear`` /
``evaluate``, with ``--config``, ``--env`` and ``--configs-dir`` read by the
port's loader. The port runs on the CUDA card; ``--cpu`` runs it on the CPU
(``device="cpu"``). It imports nothing of JAX.

    python scripts/run_torch.py --cpu --config my.yaml query "gradient"
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(prog="audio-rag", description=__doc__)
    parser.add_argument("--config", default=None)
    parser.add_argument("--env", default=None)
    parser.add_argument("--configs-dir", default="configs")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_ingest = sub.add_parser("ingest", help="ingest audio file(s)")
    p_ingest.add_argument("paths", nargs="+")
    p_ingest.add_argument("--collection", default=None)
    p_ingest.add_argument("--no-diarize", action="store_true")
    p_ingest.add_argument("--metadata", default=None,
                          help="JSON metadata stamped on chunks")

    p_query = sub.add_parser("query", help="query the index")
    p_query.add_argument("text")
    p_query.add_argument("--collection", default=None)
    p_query.add_argument("--top-k", type=int, default=5)
    p_query.add_argument("--search-type", default=None,
                         choices=["dense", "sparse", "hybrid"])
    p_query.add_argument("--hyde", action="store_true")
    p_query.add_argument("--no-rerank", action="store_true")
    p_query.add_argument("--answer", action="store_true",
                         help="generate an LLM answer")
    p_query.add_argument("--json", action="store_true")

    sub.add_parser("status", help="engine/collection status")

    p_clear = sub.add_parser("clear", help="delete a collection")
    p_clear.add_argument("--collection", default=None)

    p_eval = sub.add_parser("evaluate", help="run the eval harness")
    p_eval.add_argument("--dataset", default=None,
                        help="dataset JSON (default: built-in 8-sample set)")
    p_eval.add_argument("--search-types", default="dense,hybrid")
    p_eval.add_argument("--answers", action="store_true")
    p_eval.add_argument("--ragas", action="store_true",
                        help="LLM-judged RAGAS quartet (implies --answers)")

    args = parser.parse_args()

    from audio_rag_tpu_torch.config import load_config
    from audio_rag_tpu_torch.pipeline import AudioRAG

    config = load_config(args.config, args.env, args.configs_dir)
    if args.cpu:
        config.device = "cpu"
    rag = AudioRAG(config)

    if args.cmd == "ingest":
        metadata = json.loads(args.metadata) if args.metadata else None
        results = rag.ingest_batch(
            list(args.paths), collection=args.collection,
            diarize=not args.no_diarize, metadata=metadata,
        )
        for res in results:
            print(json.dumps(res.to_dict(), indent=2))
        return 0

    if args.cmd == "query":
        out = rag.query(
            args.text,
            collection=args.collection,
            top_k=args.top_k,
            search_type=args.search_type,
            use_hyde=args.hyde,
            rerank=not args.no_rerank,
            generate_answer=args.answer,
        )
        if args.json:
            print(json.dumps(out.to_dict(), indent=2))
        else:
            print(out.response)
            if out.answer:
                print("\n=== Answer ===\n" + out.answer)
            print(f"\n({out.elapsed_s * 1000:.0f} ms, "
                  f"{len(out.results)} results)")
        return 0

    if args.cmd == "status":
        print(json.dumps(rag.status(), indent=2, default=str))
        return 0

    if args.cmd == "clear":
        ok = rag.clear_collection(args.collection)
        print("cleared" if ok else "collection not found")
        return 0 if ok else 1

    if args.cmd == "evaluate":
        from audio_rag_tpu_torch.evaluation import (
            CS229_EVAL_DATASET,
            EvalDataset,
            RAGEvaluator,
        )

        dataset = (EvalDataset.load(args.dataset) if args.dataset
                   else CS229_EVAL_DATASET)
        evaluator = RAGEvaluator(
            embedder=rag.embedder,
            generator=rag.generator if args.ragas else None,
            device=rag.device,
        )
        results = evaluator.evaluate_dataset(
            rag, dataset,
            search_types=args.search_types.split(","),
            generate_answers=args.answers or args.ragas,
            compute_ragas=args.ragas,
        )
        evaluator.print_summary(evaluator.summarize_results(results))
        return 0

    return 1


if __name__ == "__main__":
    raise SystemExit(main())
