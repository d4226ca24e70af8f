#!/usr/bin/env python
"""Real-weight dress rehearsal on the PyTorch/CUDA port: convert a
directory of HuggingFace checkpoints, load every engine through them,
ingest, query, and run the evaluation sweep.

The port's counterpart of ``scripts/load_real.py``, with the same
classification, preset detection, config and output lines:

    python scripts/load_real_torch.py /path/to/hf_models --out converted \\
        [--audio lecture1.wav lecture2.wav] [--no-eval] [--cpu]

``/path/to/hf_models`` holds one subdirectory per checkpoint::

    hf_models/whisper-large-v3/      (HF WhisperForConditionalGeneration)
    hf_models/bge-m3/                (XLM-RoBERTa + sparse_linear.pt)
    hf_models/bge-reranker-base/     (XLMRobertaForSequenceClassification)
    hf_models/llama-3.2-1b/          (LlamaForCausalLM)
    hf_models/spkrec-ecapa-voxceleb/ (speechbrain embedding_model.ckpt)

Each is classified by its ``config.json`` ``model_type`` (ECAPA by its
``.ckpt``), converted with :mod:`audio_rag_tpu_torch.convert` into
``out/<name>_ck/<name>.safetensors`` (tokenizer files carried along),
matched to a preset by the converted tree's shapes, and the whole stack
loads through ``checkpoint_path``: ingest of the given audio (a synthetic
two-voice conversation when none is given), a query and the CS229-analog
evaluation sweep. It runs on the CUDA card; ``--cpu`` runs it on the CPU.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def classify(src: Path) -> str | None:
    """HF-checkpoint kind from config.json / file layout."""
    cfgf = src / "config.json"
    if not cfgf.exists():
        if list(src.glob("*.ckpt")):
            return "speaker"
        return None
    try:
        cfg = json.loads(cfgf.read_text())
    except json.JSONDecodeError:
        return None
    mtype = cfg.get("model_type", "")
    archs = " ".join(cfg.get("architectures") or [])
    if mtype == "whisper":
        return "whisper"
    if mtype == "llama":
        return "llama"
    if mtype in ("xlm-roberta", "roberta", "bert"):
        return "reranker" if "SequenceClassification" in archs else "bgem3"
    return None


def _match_preset(presets: dict, probe) -> str | None:
    for name, dims in presets.items():
        if probe(dims):
            return name
    return None


def detect_model_names(converted: dict[str, dict]) -> dict[str, str]:
    """Preset / model names from the converted trees' shapes (the config
    must name the dims the models are built with)."""
    names: dict[str, str] = {}
    if "whisper" in converted:
        from audio_rag_tpu_torch.models.whisper import WHISPER_PRESETS

        p = converted["whisper"]
        vocab, d = p["decoder"]["tok_emb"]["table"].shape
        n_dec = p["decoder"]["blocks"]["ln1"]["g"].shape[0]
        n_mels = p["encoder"]["conv1"]["w"].shape[1]
        name = _match_preset(
            WHISPER_PRESETS,
            lambda dm: (dm.n_vocab, dm.n_text_state, dm.n_text_layer,
                        dm.n_mels) == (vocab, d, n_dec, n_mels))
        if name is None:
            raise SystemExit(
                f"whisper checkpoint dims (vocab={vocab}, d={d}, "
                f"layers={n_dec}, mels={n_mels}) match no preset")
        names["whisper"] = name
    if "llm" in converted:
        from audio_rag_tpu_torch.models.llm import LLM_PRESETS

        p = converted["llm"]
        vocab, d = p["tok_emb"]["table"].shape
        n_layers = p["blocks"]["ln_attn"]["g"].shape[0]
        name = _match_preset(
            LLM_PRESETS,
            lambda dm: (dm.vocab, dm.d_model, dm.n_layers)
            == (vocab, d, n_layers))
        if name is None:
            raise SystemExit(
                f"llama checkpoint dims (vocab={vocab}, d={d}, "
                f"layers={n_layers}) match no preset")
        names["llm"] = name
    for kind, default in (("bgem3", "BAAI/bge-m3"),
                          ("reranker", "BAAI/bge-reranker-base")):
        if kind in converted:
            from audio_rag_tpu_torch.models.bert import BERT_PRESETS

            p = converted[kind]["bert"]
            vocab, d = p["tok_emb"]["table"].shape
            n_layers = p["blocks"]["ln_attn"]["g"].shape[0]
            test = BERT_PRESETS["test"]
            if (test.vocab, test.d_model, test.n_layers) == (vocab, d,
                                                             n_layers):
                names[kind] = "test"
            else:
                names[kind] = default  # backends map non-test → xlmr dims
    return names


def convert_all(models_dir: Path, out: Path) -> dict[str, Path]:
    """Convert every recognized checkpoint under ``models_dir`` into its
    own ``out/<name>_ck`` directory (params + tokenizer files)."""
    from audio_rag_tpu_torch.convert import CONVERTERS, convert_dir

    paths: dict[str, Path] = {}
    trees: dict[str, dict] = {}
    for src in sorted(p for p in models_dir.iterdir() if p.is_dir()):
        kind = classify(src)
        if kind is None:
            print(f"skip {src.name}: unrecognized", file=sys.stderr)
            continue
        name = CONVERTERS[kind][1]
        dst = out / f"{name}_ck"
        dst.mkdir(parents=True, exist_ok=True)
        params = convert_dir(kind, src, dst)
        paths[name] = dst
        trees[name] = params
        print(json.dumps({"converted": src.name, "kind": kind,
                          "params": _size(params), "out": str(dst)}))
    paths["_names"] = detect_model_names(trees)  # type: ignore[assignment]
    return paths


def _size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_size(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_size(v) for v in tree)
    return int(getattr(tree, "size", 0))


def build_config(paths: dict, device: str = "cuda"):
    """The port's ``AudioRAGConfig`` that loads every converted engine."""
    from audio_rag_tpu_torch.config import (
        ASRConfig, AudioRAGConfig, ContextualConfig, DiarizationConfig,
        EmbeddingConfig, GenerationConfig, RerankingConfig, RetrievalConfig,
        TTSConfig)

    names = paths["_names"]
    asr = (ASRConfig(backend="whisper-jax", model_size=names["whisper"],
                     checkpoint_path=str(paths["whisper"]), vad_filter=False,
                     compute_type=("float32"
                                   if names["whisper"].startswith("test")
                                   else "bfloat16"))
           if "whisper" in paths else ASRConfig(backend="fake"))
    diarization = (DiarizationConfig(backend="clustering",
                                     checkpoint_path=str(paths["speaker"]),
                                     vad_backend="energy")
                   if "speaker" in paths
                   else DiarizationConfig(backend="clustering",
                                          vad_backend="energy"))
    embedding = (EmbeddingConfig(backend="bge-m3", model=names["bgem3"],
                                 checkpoint_path=str(paths["bgem3"]))
                 if "bgem3" in paths else EmbeddingConfig(backend="fake"))
    reranking = (RerankingConfig(backend="bge-reranker",
                                 model=names["reranker"],
                                 checkpoint_path=str(paths["reranker"]))
                 if "reranker" in paths else RerankingConfig(backend="none"))
    generation = (GenerationConfig(backend="llm-jax", model=names["llm"],
                                   checkpoint_path=str(paths["llm"]),
                                   max_tokens=64)
                  if "llm" in paths else GenerationConfig(backend="none"))
    return AudioRAGConfig(
        asr=asr, diarization=diarization, embedding=embedding,
        reranking=reranking, generation=generation,
        retrieval=RetrievalConfig(backend="tpu"),
        contextual=ContextualConfig(enabled=False),
        tts=TTSConfig(backend="null"), device=device)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("models_dir", help="directory of HF checkpoints")
    parser.add_argument("--out", default="converted")
    parser.add_argument("--audio", nargs="*", default=None,
                        help="audio files to ingest (default: synthetic)")
    parser.add_argument("--collection", default="real_weights")
    parser.add_argument("--no-eval", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    out = Path(args.out)
    paths = convert_all(Path(args.models_dir), out)
    if not paths.get("_names") and len(paths) <= 1:
        raise SystemExit("no convertible checkpoints found")

    from audio_rag_tpu_torch.pipeline import AudioRAG

    cfg = build_config(paths, device)
    rag = AudioRAG(cfg)

    audio_files = args.audio
    if not audio_files:
        import numpy as np

        from audio_rag_tpu_torch.audio.io import write_wav
        from audio_rag_tpu_torch.audio.synth import conversation, sample_voice

        rng = np.random.default_rng(7)
        voices = [sample_voice(rng) for _ in range(2)]
        wav, _ = conversation(rng, voices, duration_s=20.0)
        p = out / "rehearsal.wav"
        write_wav(str(p), wav, 16_000)
        audio_files = [str(p)]

    for f in audio_files:
        res = rag.ingest(f, collection=args.collection)
        print(json.dumps({"ingested": f, "chunks": res.num_chunks,
                          "speakers": res.num_speakers,
                          "duration_s": res.duration_s}))

    q = rag.query("What was discussed?", collection=args.collection,
                  top_k=3)
    print(json.dumps({"query_results": len(q.results),
                      "answer_len": len(q.answer or "")}))

    if not args.no_eval:
        from audio_rag_tpu_torch.evaluation import (
            CS229_EVAL_DATASET,
            RAGEvaluator,
        )

        class _Pipe:  # the evaluator drives pipeline.query(collection=...)
            def query(self, *a, **kw):
                kw.setdefault("collection", args.collection)
                return rag.query(*a, **kw)

        ev = RAGEvaluator(device=device)
        results = ev.evaluate_dataset(
            _Pipe(), CS229_EVAL_DATASET, search_types=["dense", "hybrid"],
            generate_answers=cfg.generation.backend != "none")
        summary = ev.summarize_results(results)
        print(json.dumps({"evaluation": summary}, default=float))
    rag.unload_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
