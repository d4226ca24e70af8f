"""Offline converters: HuggingFace-layout checkpoints → the port's
parameter trees.

Counterpart of ``audio_rag_tpu/convert.py``, with the same weight-name maps
and the same trees, leaf for leaf and bit for bit: every linear transposed
to the (d_in, d_out) layout, per-layer tensors stacked along a leading
layer axis, each leaf in the dtype it was stored in (an F16 release stays
F16; the backend casts each leaf once, to its compute dtype, when it
loads). A deployment converts once:

    python -m audio_rag_tpu_torch.convert whisper  /path/to/hf-whisper-large-v3 out/
    python -m audio_rag_tpu_torch.convert bgem3    /path/to/bge-m3             out/
    python -m audio_rag_tpu_torch.convert reranker /path/to/bge-reranker-base  out/
    python -m audio_rag_tpu_torch.convert llama    /path/to/llama-3.2-3b       out/
    python -m audio_rag_tpu_torch.convert speaker  /path/to/spkrec-ecapa       out/

then points ``*.checkpoint_path`` at ``out/``, which holds
``{name}.safetensors`` (:func:`audio_rag_tpu_torch.checkpoint.save_params`)
and the source's tokenizer files, copied beside it.

Checkpoint files are read by :func:`load_state_dict`: every
``*.safetensors`` shard through the port's own reader (BF16 widened to
f32, which the JAX converter's reader cannot read at all), else
``pytorch_model*.bin`` / ``*.pt`` / ``*.ckpt`` through ``torch.load``
with ``weights_only=True``, every tensor widened to f32 as the JAX
converter does. Like the JAX converter, ``convert_llama`` reads no
``config.json``: ``rope_theta`` comes from the model preset and a
``rope_scaling`` entry is not applied.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import load_safetensors, save_params

log = logging.getLogger(__name__)

__all__ = ["load_state_dict", "convert_whisper", "convert_xlmr_encoder",
           "convert_bgem3", "convert_reranker", "convert_llama",
           "convert_vad_torch", "convert_speaker", "CONVERTERS",
           "TOKENIZER_FILES", "convert_dir", "tree_bytes", "main"]

#: the files of a tokenizer that a conversion carries beside the params
TOKENIZER_FILES = ("tokenizer*.json", "*.model", "vocab*", "merges.txt",
                   "special_tokens_map.json", "tokenizer_config.json")


def load_state_dict(model_dir: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a checkpoint directory: all ``*.safetensors``
    shards, else the torch pickles (``pytorch_model*.bin``, ``*.pt``,
    ``*.ckpt``) widened to f32."""
    d = Path(model_dir)
    tensors: dict[str, np.ndarray] = {}
    st_files = sorted(d.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            tensors.update(load_safetensors(f))
        return tensors
    bin_files = (sorted(d.glob("pytorch_model*.bin"))
                 or sorted(d.glob("*.pt")) or sorted(d.glob("*.ckpt")))
    if not bin_files:
        raise FileNotFoundError(f"no checkpoint tensors found in {d}")
    for f in bin_files:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            tensors[k] = v.float().numpy()
    return tensors


def _lin(sd: dict, prefix: str, bias: bool = True) -> dict[str, np.ndarray]:
    out = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias and f"{prefix}.bias" in sd:
        out["b"] = sd[f"{prefix}.bias"]
    return out


def _ln(sd: dict, prefix: str) -> dict[str, np.ndarray]:
    return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


def _stack(layers: list[dict]) -> dict:
    """Per-layer trees of one layout → one tree of (L, ...) leaves."""
    return {k: (_stack([layer[k] for layer in layers])
                if isinstance(v, dict)
                else np.stack([layer[k] for layer in layers]))
            for k, v in layers[0].items()}


def _n_layers(sd: dict, prefix: str) -> int:
    """1 + the largest index ``i`` of a key ``{prefix}{i}.…``."""
    return 1 + max(int(k[len(prefix):].split(".")[0])
                   for k in sd if k.startswith(prefix))


# -- Whisper ---------------------------------------------------------------

def convert_whisper(model_dir: str | Path) -> dict[str, Any]:
    """HF WhisperForConditionalGeneration → ``init_whisper`` tree."""
    sd = load_state_dict(model_dir)
    pre = "model." if "model.encoder.conv1.weight" in sd else ""

    def base_block(p: str) -> dict:
        return {
            "ln1": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.q_proj"),
                "k": _lin(sd, f"{p}.self_attn.k_proj", bias=False),
                "v": _lin(sd, f"{p}.self_attn.v_proj"),
                "o": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp": {"up": _lin(sd, f"{p}.fc1"), "down": _lin(sd, f"{p}.fc2")},
            "ln_mlp": _ln(sd, f"{p}.final_layer_norm"),
        }

    def dec_block(i: int) -> dict:
        p = f"{pre}decoder.layers.{i}"
        return {
            **base_block(p),
            "cross": {
                "q": _lin(sd, f"{p}.encoder_attn.q_proj"),
                "k": _lin(sd, f"{p}.encoder_attn.k_proj", bias=False),
                "v": _lin(sd, f"{p}.encoder_attn.v_proj"),
                "o": _lin(sd, f"{p}.encoder_attn.out_proj"),
            },
            "ln_cross": _ln(sd, f"{p}.encoder_attn_layer_norm"),
        }

    def conv(name: str) -> dict[str, np.ndarray]:
        # HF conv1d weight (out, in, k) → (k, in, out)
        return {"w": np.ascontiguousarray(
                    sd[f"{pre}encoder.{name}.weight"].transpose(2, 1, 0)),
                "b": sd[f"{pre}encoder.{name}.bias"]}

    n_enc = _n_layers(sd, f"{pre}encoder.layers.")
    n_dec = _n_layers(sd, f"{pre}decoder.layers.")
    return {
        "encoder": {
            "conv1": conv("conv1"),
            "conv2": conv("conv2"),
            "pos": sd[f"{pre}encoder.embed_positions.weight"],
            "blocks": _stack([base_block(f"{pre}encoder.layers.{i}")
                              for i in range(n_enc)]),
            "ln_post": _ln(sd, f"{pre}encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": {"table": sd[f"{pre}decoder.embed_tokens.weight"]},
            "pos_emb": sd[f"{pre}decoder.embed_positions.weight"],
            "blocks": _stack([dec_block(i) for i in range(n_dec)]),
            "ln": _ln(sd, f"{pre}decoder.layer_norm"),
        },
    }


# -- XLM-R encoders --------------------------------------------------------

def convert_xlmr_encoder(sd: dict, pre: str = "") -> dict[str, Any]:
    """An XLM-R state dict (keys under ``pre``) → ``init_bert`` tree."""
    def block(i: int) -> dict:
        p = f"{pre}encoder.layer.{i}"
        return {
            "attn": {
                "q": _lin(sd, f"{p}.attention.self.query"),
                "k": _lin(sd, f"{p}.attention.self.key"),
                "v": _lin(sd, f"{p}.attention.self.value"),
                "o": _lin(sd, f"{p}.attention.output.dense"),
            },
            "ln_attn": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "mlp": {"up": _lin(sd, f"{p}.intermediate.dense"),
                    "down": _lin(sd, f"{p}.output.dense")},
            "ln_mlp": _ln(sd, f"{p}.output.LayerNorm"),
        }

    n = _n_layers(sd, f"{pre}encoder.layer.")
    pos = sd[f"{pre}embeddings.position_embeddings.weight"]
    # fold the constant token-type-0 embedding into the position table
    # (every token receives exactly one of each)
    tt_key = f"{pre}embeddings.token_type_embeddings.weight"
    if tt_key in sd:
        pos = pos + sd[tt_key][0][None, :]
    return {
        "tok_emb": {"table": sd[f"{pre}embeddings.word_embeddings.weight"]},
        "pos_emb": {"table": pos},
        "ln_emb": _ln(sd, f"{pre}embeddings.LayerNorm"),
        "blocks": _stack([block(i) for i in range(n)]),
    }


def _detect_prefix(sd: dict, *candidates: str) -> str:
    for c in candidates:
        if any(k.startswith(f"{c}embeddings.") for k in sd):
            return c
    raise KeyError(f"no XLM-R prefix found among {candidates}")


def convert_bgem3(model_dir: str | Path) -> dict[str, Any]:
    """BAAI/bge-m3 → ``init_bgem3`` tree (backbone + ``sparse_linear``
    head; a zero head when ``sparse_linear.pt`` is missing)."""
    d = Path(model_dir)
    sd = load_state_dict(d)
    pre = _detect_prefix(sd, "", "roberta.", "model.")
    params: dict[str, Any] = {"bert": convert_xlmr_encoder(sd, pre)}
    sparse_file = d / "sparse_linear.pt"
    if sparse_file.exists():
        sl = torch.load(sparse_file, map_location="cpu", weights_only=True)
        params["sparse"] = {
            "w": np.ascontiguousarray(sl["weight"].float().numpy().T),
            "b": sl["bias"].float().numpy(),
        }
    else:
        log.warning("sparse_linear.pt missing; the sparse head is zero")
        params["sparse"] = {
            "w": np.zeros((params["bert"]["tok_emb"]["table"].shape[1], 1),
                          np.float32),
            "b": np.zeros((1,), np.float32),
        }
    return params


def convert_reranker(model_dir: str | Path) -> dict[str, Any]:
    """XLMRobertaForSequenceClassification (bge-reranker-base; with 3
    labels, an NLI head) → ``init_cross_encoder`` tree."""
    sd = load_state_dict(model_dir)
    pre = _detect_prefix(sd, "roberta.", "", "model.")
    return {"bert": convert_xlmr_encoder(sd, pre),
            "dense": _lin(sd, "classifier.dense"),
            "out": _lin(sd, "classifier.out_proj")}


# -- LLaMA -----------------------------------------------------------------

def convert_llama(model_dir: str | Path) -> dict[str, Any]:
    """HF LlamaForCausalLM → ``init_llm`` tree (the half-split RoPE
    matches; the head is the embedding table when ``lm_head`` is absent)."""
    sd = load_state_dict(model_dir)
    pre = "model." if "model.embed_tokens.weight" in sd else ""

    def block(i: int) -> dict:
        p = f"{pre}layers.{i}"
        return {
            "ln_attn": {"g": sd[f"{p}.input_layernorm.weight"]},
            "attn": {name: _lin(sd, f"{p}.self_attn.{name}_proj", bias=False)
                     for name in ("q", "k", "v", "o")},
            "ln_mlp": {"g": sd[f"{p}.post_attention_layernorm.weight"]},
            "mlp": {name: _lin(sd, f"{p}.mlp.{name}_proj", bias=False)
                    for name in ("gate", "up", "down")},
        }

    n = _n_layers(sd, f"{pre}layers.")
    emb = sd[f"{pre}embed_tokens.weight"]
    head = sd.get("lm_head.weight", emb)  # tied when absent
    return {
        "tok_emb": {"table": emb},
        "blocks": _stack([block(i) for i in range(n)]),
        "ln_f": {"g": sd[f"{pre}norm.weight"]},
        "lm_head": {"w": np.ascontiguousarray(head.T)},
    }


# -- ECAPA speaker encoder -------------------------------------------------

def convert_speaker(model_dir: str | Path) -> dict[str, Any]:
    """speechbrain ``spkrec-ecapa-voxceleb``-layout ECAPA-TDNN checkpoint
    (``embedding_model.ckpt``; an ``embedding_model.`` prefix is stripped)
    → :func:`audio_rag_tpu_torch.models.ecapa.ecapa_embed` tree.

    ``blocks.0`` is the frontend TDNN, ``blocks.1..3`` the SE-Res2Net
    blocks (``tdnn1``, ``res2net_block.blocks.{j}``, ``tdnn2``,
    ``se_block.conv1|conv2``, an optional ``shortcut``), then ``mfa``,
    ``asp.tdnn``/``asp.conv``, ``asp_bn`` and ``fc``. Eval-mode BatchNorm
    folds to a per-channel affine (``s = γ/√(var+ε)``, ``o = β − mean·s``,
    ε = 1e-5; it sits after the ReLU, so it cannot fold into the conv);
    Conv1d weights (C_out, C_in, K) transpose to (K, C_in, C_out), and the
    1×1 convolutions used as channel mixes squeeze to (d_in, d_out)."""
    sd = load_state_dict(model_dir)
    pre = ("embedding_model."
           if any(k.startswith("embedding_model.") for k in sd) else "")

    def conv(p: str) -> dict[str, np.ndarray]:
        w = np.asarray(sd[f"{p}.conv.weight"])  # (C_out, C_in, K)
        return {"w": np.ascontiguousarray(w.transpose(2, 1, 0)),
                "b": (np.asarray(sd[f"{p}.conv.bias"])
                      if f"{p}.conv.bias" in sd
                      else np.zeros(w.shape[0], np.float32))}

    def bn(p: str) -> dict[str, np.ndarray]:
        g = np.asarray(sd[f"{p}.norm.weight"])
        b = np.asarray(sd[f"{p}.norm.bias"])
        mean = np.asarray(sd[f"{p}.norm.running_mean"])
        var = np.asarray(sd[f"{p}.norm.running_var"])
        s = g / np.sqrt(var + 1e-5)
        return {"s": s.astype(np.float32),
                "o": (b - mean * s).astype(np.float32)}

    def tdnn(p: str) -> dict:
        return {"conv": conv(f"{p}.conv"), "bn": bn(f"{p}.norm")}

    def lin1x1(p: str) -> dict[str, np.ndarray]:
        c = conv(p)
        return {"w": np.ascontiguousarray(c["w"][0]), "b": c["b"]}

    def layer(i: int) -> dict:
        p = f"{pre}blocks.{i}"
        n_res = _n_layers(sd, f"{p}.res2net_block.blocks.")
        out = {
            "tdnn1": tdnn(f"{p}.tdnn1"),
            "res2net": [tdnn(f"{p}.res2net_block.blocks.{j}")
                        for j in range(n_res)],
            "tdnn2": tdnn(f"{p}.tdnn2"),
            "se": {"c1": lin1x1(f"{p}.se_block.conv1"),
                   "c2": lin1x1(f"{p}.se_block.conv2")},
        }
        if f"{p}.shortcut.conv.weight" in sd:
            out["shortcut"] = conv(f"{p}.shortcut")
        return out

    n_layers = _n_layers(sd, f"{pre}blocks.")
    return {
        "frontend": tdnn(f"{pre}blocks.0"),
        "layers": [layer(i) for i in range(1, n_layers)],
        "mfa": tdnn(f"{pre}mfa"),
        "asp": {"tdnn": tdnn(f"{pre}asp.tdnn"),
                "conv": lin1x1(f"{pre}asp.conv")},
        "asp_bn": bn(f"{pre}asp_bn"),
        "fc": lin1x1(f"{pre}fc"),
    }


def convert_vad_torch(sd: dict) -> dict[str, Any]:
    """Torch conv-VAD state dict (``c1``/``c2`` Conv1d, ``ln1``/``ln2``
    LayerNorm, ``out`` Linear(channels, 1)) →
    :func:`audio_rag_tpu_torch.models.speaker.vad_scores` tree."""
    def conv(prefix: str) -> dict[str, np.ndarray]:
        w = np.asarray(sd[f"{prefix}.weight"])  # (C_out, C_in, K)
        return {"w": np.transpose(w, (2, 1, 0)).copy(),
                "b": np.asarray(sd[f"{prefix}.bias"])}

    return {"c1": conv("c1"), "ln1": _ln(sd, "ln1"), "c2": conv("c2"),
            "ln2": _ln(sd, "ln2"), "out": _lin(sd, "out")}


#: kind → (converter of a directory, name the backends restore it under)
CONVERTERS: dict[str, tuple[Callable, str]] = {
    "whisper": (convert_whisper, "whisper"),
    "bgem3": (convert_bgem3, "bgem3"),
    "reranker": (convert_reranker, "reranker"),
    "llama": (convert_llama, "llm"),
    "speaker": (convert_speaker, "speaker"),
}


def tree_bytes(tree: Any) -> int:
    """Bytes of every array leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))


def convert_dir(kind: str, src: str | Path, dst: str | Path) -> Any:
    """Convert ``src`` with the ``kind`` converter, write the tree under
    ``dst`` and copy the tokenizer files beside it; returns the tree."""
    fn, name = CONVERTERS[kind]
    params = fn(src)
    save_params(dst, name, params)
    for pat in TOKENIZER_FILES:
        for f in Path(src).glob(pat):
            shutil.copy2(f, Path(dst) / f.name)
    return params


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kind", choices=sorted(CONVERTERS))
    parser.add_argument("src", help="HF model directory")
    parser.add_argument("dst", help="output checkpoint directory")
    args = parser.parse_args(argv)
    params = convert_dir(args.kind, args.src, args.dst)
    print(json.dumps({"kind": args.kind, "out": args.dst,
                      "params_gb": round(tree_bytes(params) / 1e9, 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
