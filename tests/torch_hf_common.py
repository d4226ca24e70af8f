"""Tiny HuggingFace-layout checkpoint directories for the port's
converter and checkpoint tests, built by ``transformers`` (and torch, for
speechbrain's ECAPA and the conv VAD) with random weights and no download,
at ``tests/integration/test_load_real.py``'s widths (the ``test`` presets),
plus tree helpers. A test module builds each directory once
(``hf_dirs`` is module-scoped) and imports ``one_torch_thread``."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# transformers without its TensorFlow and Flax halves: the tests use its
# torch models only, and the other halves cost seconds to import
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")


def tiny_whisper_model(vocab: int = 1024, seed: int = 0):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    cfg = WhisperConfig(
        vocab_size=vocab, num_mel_bins=80,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        d_model=64, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=60, max_target_positions=32,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1, suppress_tokens=None,
        begin_suppress_tokens=None)
    torch.manual_seed(seed)
    return WhisperForConditionalGeneration(cfg).eval()


def tiny_llama_model(tied: bool = False, rope_scaling: dict | None = None,
                     seed: int = 1):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=512, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2,
        intermediate_size=128, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=tied,
        rope_scaling=rope_scaling)
    torch.manual_seed(seed)
    return LlamaForCausalLM(cfg).eval()


def tiny_xlmr_model(classification: bool, num_labels: int = 1, seed: int = 2,
                    **widths):
    from transformers import (
        XLMRobertaConfig,
        XLMRobertaForSequenceClassification,
        XLMRobertaModel,
    )

    cfg = XLMRobertaConfig(**{
        "vocab_size": 1024, "hidden_size": 64, "num_attention_heads": 2,
        "num_hidden_layers": 2, "intermediate_size": 128,
        "max_position_embeddings": 130, "pad_token_id": 1,
        "num_labels": num_labels, **widths})
    torch.manual_seed(seed)
    if classification:
        return XLMRobertaForSequenceClassification(cfg).eval()
    return XLMRobertaModel(cfg, add_pooling_layer=False).eval()


def ecapa_module():
    """``tests/unit/models/test_ecapa_parity.py``'s torch ECAPA (the
    speechbrain layout) with randomized eval-mode BatchNorm statistics."""
    sys.path.insert(0, str(ROOT / "tests" / "unit" / "models"))
    from test_ecapa_parity import ECAPA

    torch.manual_seed(3)
    model = ECAPA()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0.0, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.normal_(1.0, 0.2)
                mod.bias.normal_(0.0, 0.2)
    return model.eval()


class TorchVad(torch.nn.Module):
    """``test_hf_parity.py``'s conv VAD (the ``convert_vad_torch`` layout)."""

    def __init__(self, n_mels: int = 80, ch: int = 64):
        super().__init__()
        self.c1 = torch.nn.Conv1d(n_mels, ch, 5, padding=2)
        self.ln1 = torch.nn.LayerNorm(ch)
        self.c2 = torch.nn.Conv1d(ch, ch, 5, padding=4, dilation=2)
        self.ln2 = torch.nn.LayerNorm(ch)
        self.out = torch.nn.Linear(ch, 1)

    def forward(self, mel):  # (B, n_mels, T)
        x = torch.relu(self.ln1(self.c1(mel).transpose(1, 2)))
        x = torch.relu(self.ln2(self.c2(x.transpose(1, 2)).transpose(1, 2)))
        return torch.sigmoid(self.out(x)[..., 0])


def save(model, d: Path, **kw) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    model.save_pretrained(d, **{"safe_serialization": True, **kw})
    return d


def build_dirs(root: Path) -> dict[str, Path]:
    """The tiny directories of ``test_load_real.py`` (whisper, llama,
    bge-m3 with ``sparse_linear.pt``, reranker, ECAPA) under
    ``root/hf_models``, and more beside it: the tied Llama, a 3-label
    (NLI) head, bge-m3 without its sparse head, the ECAPA with the
    ``embedding_model.`` prefix, Llama in BF16, Whisper in F16, sharded
    and as ``.bin``."""
    models = root / "hf_models"
    dirs = {
        "whisper": save(tiny_whisper_model(), models / "whisper-test"),
        "llama": save(tiny_llama_model(), models / "llama-test"),
        "bgem3": save(tiny_xlmr_model(False), models / "bge-m3-test"),
        "reranker": save(tiny_xlmr_model(True), models / "bge-reranker-test"),
    }
    torch.save(torch.nn.Linear(64, 1).state_dict(),
               dirs["bgem3"] / "sparse_linear.pt")
    ecapa = ecapa_module()
    dirs["speaker"] = models / "spkrec-ecapa-test"
    dirs["speaker"].mkdir()
    torch.save(ecapa.state_dict(), dirs["speaker"] / "embedding_model.ckpt")
    extra = root / "extra"
    dirs["llama_tied"] = save(tiny_llama_model(tied=True), extra / "llama-t")
    dirs["nli"] = save(tiny_xlmr_model(True, num_labels=3), extra / "nli")
    dirs["bgem3_bare"] = save(tiny_xlmr_model(False), extra / "bge-bare")
    dirs["speaker_prefixed"] = extra / "ecapa-prefixed"
    dirs["speaker_prefixed"].mkdir(parents=True)
    torch.save({f"embedding_model.{k}": v
                for k, v in ecapa.state_dict().items()},
               dirs["speaker_prefixed"] / "model.ckpt")
    dirs["whisper_f16"] = save(tiny_whisper_model().half(), extra / "w-f16")
    dirs["whisper_sharded"] = save(tiny_whisper_model(), extra / "w-shards",
                                   max_shard_size="100KB")
    dirs["whisper_bin"] = save(tiny_whisper_model(), extra / "w-bin",
                               safe_serialization=False)
    dirs["llama_bf16"] = save(tiny_llama_model().to(torch.bfloat16),
                              extra / "llama-bf16")
    return dirs


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory) -> dict[str, Path]:
    return build_dirs(tmp_path_factory.mktemp("hf"))


def flat_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Slash-joined key → numpy leaf, lists keyed by index."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flat_tree(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().float().numpy() \
                if v.dtype == torch.bfloat16 else v.detach().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def assert_same_tree(got, ref) -> None:
    """The same keys, and every leaf the same dtype and the same bits."""
    g, r = flat_tree(got), flat_tree(ref)
    assert sorted(g) == sorted(r), sorted(set(g) ^ set(r))
    for k in r:
        assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, \
            (k, g[k].dtype, r[k].dtype, g[k].shape, r[k].shape)
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)
