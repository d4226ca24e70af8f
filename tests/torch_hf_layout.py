"""HuggingFace-layout checkpoint directories written from the port's
parameter trees, with the port's own safetensors writer (or
``torch.save`` for ``.pt`` and ``.ckpt``): the inverse of
:mod:`audio_rag_tpu_torch.convert`'s name maps. ``chip_smoke.py``'s
``convert`` phase builds its directories with these (without
``transformers``); the CPU tests hold them against the directories
``transformers`` itself writes. This module imports nothing but numpy,
torch and the port."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import save_safetensors

__all__ = ["whisper_hf_tensors", "write_whisper", "write_llama",
           "write_xlmr", "speechbrain_ecapa_state", "write_ecapa",
           "write_test_models"]


def _np(x: Any, dtype) -> np.ndarray:
    """A leaf (tensor on any device, or array) as a host array of
    ``dtype``, rounded once."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        tdt = {np.float16: torch.float16, np.float32: torch.float32}[dtype]
        return t.to(tdt).cpu().numpy()
    return np.asarray(x).astype(dtype)


def _t(w: np.ndarray) -> np.ndarray:
    """(din, dout) → the HF (dout, din) layout."""
    return np.ascontiguousarray(w.T)


def whisper_hf_tensors(tree: dict, dtype=np.float32) -> dict[str, np.ndarray]:
    """An ``init_whisper`` tree → ``WhisperForConditionalGeneration``'s
    state dict (``model.`` prefix, no ``k_proj`` bias, convolutions
    (out, in, k)), every tensor of ``dtype``."""
    out: dict[str, np.ndarray] = {}
    enc, dec = tree["encoder"], tree["decoder"]
    for name in ("conv1", "conv2"):
        out[f"model.encoder.{name}.weight"] = np.ascontiguousarray(
            _np(enc[name]["w"], dtype).transpose(2, 1, 0))
        out[f"model.encoder.{name}.bias"] = _np(enc[name]["b"], dtype)
    out["model.encoder.embed_positions.weight"] = _np(enc["pos"], dtype)
    out["model.decoder.embed_tokens.weight"] = _np(dec["tok_emb"]["table"],
                                                   dtype)
    out["model.decoder.embed_positions.weight"] = _np(dec["pos_emb"], dtype)
    for side, lnf in (("encoder", "ln_post"), ("decoder", "ln")):
        src = tree[side]
        out[f"model.{side}.layer_norm.weight"] = _np(src[lnf]["g"], dtype)
        out[f"model.{side}.layer_norm.bias"] = _np(src[lnf]["b"], dtype)
        blocks = {k: v for k, v in src["blocks"].items()}
        attns = [("attn", "self_attn")]
        lns = [("ln1", "self_attn_layer_norm"),
               ("ln_mlp", "final_layer_norm")]
        if side == "decoder":
            attns.append(("cross", "encoder_attn"))
            lns.append(("ln_cross", "encoder_attn_layer_norm"))
        L = blocks["ln1"]["g"].shape[0]
        for i in range(L):
            p = f"model.{side}.layers.{i}"
            for ours, theirs in attns:
                for a, proj in (("q", "q_proj"), ("k", "k_proj"),
                                ("v", "v_proj"), ("o", "out_proj")):
                    lin = blocks[ours][a]
                    out[f"{p}.{theirs}.{proj}.weight"] = _t(
                        _np(lin["w"][i], dtype))
                    if "b" in lin:
                        out[f"{p}.{theirs}.{proj}.bias"] = _np(lin["b"][i],
                                                               dtype)
            for ours, theirs in lns:
                out[f"{p}.{theirs}.weight"] = _np(blocks[ours]["g"][i], dtype)
                out[f"{p}.{theirs}.bias"] = _np(blocks[ours]["b"][i], dtype)
            for ours, theirs in (("up", "fc1"), ("down", "fc2")):
                out[f"{p}.{theirs}.weight"] = _t(
                    _np(blocks["mlp"][ours]["w"][i], dtype))
                out[f"{p}.{theirs}.bias"] = _np(blocks["mlp"][ours]["b"][i],
                                                dtype)
    return out


def _write_config(d: Path, config: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(config, indent=1))


def write_whisper(tree: dict, d: Path, dims, dtype=np.float32) -> Path:
    """``d/model.safetensors`` + ``config.json`` (``model_type``
    whisper) from an ``init_whisper`` tree of ``dims``."""
    from audio_rag_tpu_torch.models.whisper import SpecialTokens

    st = SpecialTokens.for_dims(dims)
    _write_config(d, {
        "model_type": "whisper",
        "architectures": ["WhisperForConditionalGeneration"],
        "num_mel_bins": dims.n_mels, "d_model": dims.n_audio_state,
        "encoder_layers": dims.n_audio_layer,
        "decoder_layers": dims.n_text_layer,
        "encoder_attention_heads": dims.n_audio_head,
        "decoder_attention_heads": dims.n_text_head,
        "vocab_size": dims.n_vocab,
        "max_source_positions": dims.n_audio_ctx,
        "max_target_positions": dims.n_text_ctx,
        "encoder_ffn_dim": 4 * dims.n_audio_state,
        "decoder_ffn_dim": 4 * dims.n_text_state,
        "pad_token_id": st.eot, "bos_token_id": st.eot,
        "eos_token_id": st.eot, "decoder_start_token_id": st.sot,
        "suppress_tokens": None, "begin_suppress_tokens": None,
        "torch_dtype": "float16" if dtype == np.float16 else "float32"})
    save_safetensors(d / "model.safetensors", whisper_hf_tensors(tree, dtype),
                     metadata={"format": "pt"})
    return d


def write_llama(tree: dict, d: Path, dims, tied: bool) -> Path:
    """``d/model.safetensors`` + ``config.json`` (``model_type`` llama)
    from an ``init_llm`` tree; ``tied`` leaves ``lm_head`` out (the tree's
    head must then be the embedding table's transpose)."""
    f32 = np.float32
    out = {"model.embed_tokens.weight": _np(tree["tok_emb"]["table"], f32),
           "model.norm.weight": _np(tree["ln_f"]["g"], f32)}
    if not tied:
        out["lm_head.weight"] = _t(_np(tree["lm_head"]["w"], f32))
    b = tree["blocks"]
    for i in range(b["ln_attn"]["g"].shape[0]):
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = _np(b["ln_attn"]["g"][i], f32)
        out[f"{p}.post_attention_layernorm.weight"] = _np(
            b["ln_mlp"]["g"][i], f32)
        for a in ("q", "k", "v", "o"):
            out[f"{p}.self_attn.{a}_proj.weight"] = _t(
                _np(b["attn"][a]["w"][i], f32))
        for m in ("gate", "up", "down"):
            out[f"{p}.mlp.{m}_proj.weight"] = _t(_np(b["mlp"][m]["w"][i],
                                                     f32))
    _write_config(d, {
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "vocab_size": dims.vocab, "hidden_size": dims.d_model,
        "num_attention_heads": dims.n_heads,
        "num_key_value_heads": dims.n_kv_heads,
        "num_hidden_layers": dims.n_layers,
        "intermediate_size": dims.d_ff, "rope_theta": dims.rope_theta,
        "tie_word_embeddings": tied})
    save_safetensors(d / "model.safetensors", out, metadata={"format": "pt"})
    return d


def write_xlmr(tree: dict, d: Path, dims, classification: bool) -> Path:
    """An ``init_bgem3`` tree (``sparse`` head as ``sparse_linear.pt``)
    or an ``init_cross_encoder`` tree (``classification``: the
    ``roberta.`` prefix and the ``classifier`` head) → an XLM-R
    directory. The token-type table is zero, so the converter's fold
    gives the position table back unchanged."""
    f32 = np.float32
    pre = "roberta." if classification else ""
    bert = tree["bert"]
    d_model = bert["tok_emb"]["table"].shape[1]
    out = {
        f"{pre}embeddings.word_embeddings.weight":
            _np(bert["tok_emb"]["table"], f32),
        f"{pre}embeddings.position_embeddings.weight":
            _np(bert["pos_emb"]["table"], f32),
        f"{pre}embeddings.token_type_embeddings.weight":
            np.zeros((1, d_model), f32),
        f"{pre}embeddings.LayerNorm.weight": _np(bert["ln_emb"]["g"], f32),
        f"{pre}embeddings.LayerNorm.bias": _np(bert["ln_emb"]["b"], f32),
    }
    b = bert["blocks"]
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense"}
    for i in range(b["ln_attn"]["g"].shape[0]):
        p = f"{pre}encoder.layer.{i}"
        lins = [(b["attn"][a], n) for a, n in names.items()]
        lins += [(b["mlp"]["up"], "intermediate.dense"),
                 (b["mlp"]["down"], "output.dense")]
        for lin, n in lins:
            out[f"{p}.{n}.weight"] = _t(_np(lin["w"][i], f32))
            out[f"{p}.{n}.bias"] = _np(lin["b"][i], f32)
        for ln, n in ((b["ln_attn"], "attention.output.LayerNorm"),
                      (b["ln_mlp"], "output.LayerNorm")):
            out[f"{p}.{n}.weight"] = _np(ln["g"][i], f32)
            out[f"{p}.{n}.bias"] = _np(ln["b"][i], f32)
    if classification:
        for ours, theirs in (("dense", "dense"), ("out", "out_proj")):
            out[f"classifier.{theirs}.weight"] = _t(_np(tree[ours]["w"], f32))
            out[f"classifier.{theirs}.bias"] = _np(tree[ours]["b"], f32)
    n_labels = (int(np.shape(tree["out"]["w"])[1]) if classification else 1)
    _write_config(d, {
        "model_type": "xlm-roberta",
        "architectures": (["XLMRobertaForSequenceClassification"]
                          if classification else ["XLMRobertaModel"]),
        "vocab_size": dims.vocab, "hidden_size": dims.d_model,
        "num_attention_heads": dims.n_heads,
        "num_hidden_layers": dims.n_layers,
        "intermediate_size": dims.d_ff,
        "max_position_embeddings": dims.max_len + dims.pos_offset,
        "type_vocab_size": 1, "pad_token_id": dims.pad_id,
        "num_labels": n_labels})
    save_safetensors(d / "model.safetensors", out, metadata={"format": "pt"})
    if not classification:
        torch.save({"weight": torch.from_numpy(_t(_np(tree["sparse"]["w"],
                                                      f32))),
                    "bias": torch.from_numpy(_np(tree["sparse"]["b"], f32))},
                   d / "sparse_linear.pt")
    return d


def speechbrain_ecapa_state(gen: torch.Generator, n_mels: int = 80,
                            channels: int = 1024, mfa: int = 3072,
                            attn: int = 128, se: int = 128, emb: int = 192,
                            scale: int = 8, kernel: int = 3
                            ) -> dict[str, torch.Tensor]:
    """A seeded ECAPA-TDNN state dict in the speechbrain release's key
    layout (``embedding_model.ckpt``; the release widths by default), f32
    on the CPU, with eval-mode BatchNorm running statistics and their
    int64 ``num_batches_tracked`` counters."""
    sd: dict[str, torch.Tensor] = {}

    def normal(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    def conv(p, c_in, c_out, k):
        sd[f"{p}.conv.weight"] = normal(c_out, c_in, k, std=(k * c_in) ** -.5)
        sd[f"{p}.conv.bias"] = normal(c_out, std=0.05)

    def bn(p, c):
        sd[f"{p}.norm.weight"] = normal(c, std=0.2, mean=1.0)
        sd[f"{p}.norm.bias"] = normal(c, std=0.2)
        sd[f"{p}.norm.running_mean"] = normal(c, std=0.5)
        sd[f"{p}.norm.running_var"] = torch.rand(c, generator=gen) * 1.5 + 0.5
        sd[f"{p}.norm.num_batches_tracked"] = torch.tensor(1000)

    def tdnn(p, c_in, c_out, k):
        conv(f"{p}.conv", c_in, c_out, k)
        bn(f"{p}.norm", c_out)

    tdnn("blocks.0", n_mels, channels, 5)
    width = channels // scale
    for i in range(1, 4):
        p = f"blocks.{i}"
        tdnn(f"{p}.tdnn1", channels, channels, 1)
        for j in range(scale - 1):
            tdnn(f"{p}.res2net_block.blocks.{j}", width, width, kernel)
        tdnn(f"{p}.tdnn2", channels, channels, 1)
        conv(f"{p}.se_block.conv1", channels, se, 1)
        conv(f"{p}.se_block.conv2", se, channels, 1)
    tdnn("mfa", 3 * channels, mfa, 1)
    tdnn("asp.tdnn", 3 * mfa, attn, 1)
    conv("asp.conv", attn, mfa, 1)
    bn("asp_bn", 2 * mfa)
    conv("fc", 2 * mfa, emb, 1)
    return sd


def write_ecapa(state: dict[str, torch.Tensor], d: Path,
                prefix: str = "") -> Path:
    """``d/embedding_model.ckpt`` (``torch.save`` of ``state``, its keys
    under ``prefix``)."""
    d.mkdir(parents=True, exist_ok=True)
    torch.save({f"{prefix}{k}": v for k, v in state.items()},
               d / "embedding_model.ckpt")
    return d


def write_test_models(root: Path) -> Path:
    """``tests/integration/test_load_real.py``'s directories at its widths
    (the ``test`` presets: Whisper, an untied Llama, BGE-M3 with
    ``sparse_linear.pt``, the reranker, a speechbrain ECAPA) and a
    directory that is no model, from seeded trees, under
    ``root/hf_models``."""
    from audio_rag_tpu_torch.models.bert import BERT_PRESETS
    from audio_rag_tpu_torch.models.bgem3 import init_bgem3
    from audio_rag_tpu_torch.models.cross_encoder import init_cross_encoder
    from audio_rag_tpu_torch.models.llm import LLM_PRESETS, init_llm
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS,
        init_whisper,
    )

    models = root / "hf_models"
    bert = BERT_PRESETS["test"]
    write_whisper(init_whisper(WHISPER_PRESETS["test"], seed=0),
                  models / "whisper-test", WHISPER_PRESETS["test"])
    write_llama(init_llm(LLM_PRESETS["test"],
                         torch.Generator().manual_seed(1), torch.float32),
                models / "llama-test", LLM_PRESETS["test"], tied=False)
    write_xlmr(init_bgem3(bert, seed=2), models / "bge-m3-test", bert, False)
    write_xlmr(init_cross_encoder(bert, seed=2), models / "bge-reranker-test",
               bert, True)
    write_ecapa(speechbrain_ecapa_state(
        torch.Generator().manual_seed(3), n_mels=20, channels=32, mfa=48,
        attn=16, se=8, emb=12, scale=4), models / "spkrec-ecapa-test")
    (models / "not-a-model").mkdir()
    return models
