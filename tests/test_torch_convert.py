"""The port's safetensors reader and writer and its converters
(``audio_rag_tpu_torch/convert.py``) against the JAX package's, and the
models of both packages on the converted trees against the HuggingFace
torch models they were converted from.

Tiny HF checkpoints come from ``transformers`` with random weights
(``tests/torch_hf_common.py``); the tolerances are
``tests/unit/models/test_hf_parity.py``'s (atol 6e-3, rtol 2e-2; the VAD
2e-5 / 1e-4) against HF, 1e-5 between the two packages in f32."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from audio_rag_tpu import convert as jconvert
from audio_rag_tpu.models import bert as jbert
from audio_rag_tpu.models import cross_encoder as jce
from audio_rag_tpu.models import llm as jllm
from audio_rag_tpu.models import speaker as jspeaker
from audio_rag_tpu.models import whisper as jwhisper
from audio_rag_tpu_torch import checkpoint as tcheckpoint
from audio_rag_tpu_torch import convert as tconvert
from audio_rag_tpu_torch.models import bert as tbert
from audio_rag_tpu_torch.models import cross_encoder as tce
from audio_rag_tpu_torch.models import llm as tllm
from audio_rag_tpu_torch.models import speaker as tspeaker
from audio_rag_tpu_torch.models import whisper as twhisper
from audio_rag_tpu_torch.weights import (
    convert_llm,
    cross_encoder_params,
    e5_params,
    vad_params,
    whisper_params,
)
from torch_hf_common import (  # noqa: F401
    ROOT,
    TorchVad,
    assert_same_tree,
    flat_tree,
    hf_dirs,
    one_torch_thread,
    tiny_llama_model,
)

HF_TOL = {"atol": 6e-3, "rtol": 2e-2}
WHISPER = twhisper.WHISPER_PRESETS["test"]
LLAMA = tllm.LLM_PRESETS["test"]
BERT = tbert.BERT_PRESETS["test"]


# -- the reader and the writer ------------------------------------------------

ST_ARRAYS = {
    "F32": np.linspace(-3, 3, 24, dtype=np.float32).reshape(2, 3, 4),
    "F16": np.linspace(-3, 3, 10, dtype=np.float16),
    "I64": np.arange(-5, 7, dtype=np.int64).reshape(3, 4),
    "I32": np.arange(6, dtype=np.int32),
    "I8": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
    "U8": np.arange(250, 256, dtype=np.uint8),
    "BOOL": np.array([[True, False], [False, True]]),
}


@pytest.mark.parametrize("name", list(ST_ARRAYS))
def test_reader_matches_safetensors_numpy(name, tmp_path):
    """Each dtype (a 0-d and an empty tensor beside it) reads back as
    ``safetensors.numpy`` reads it: the same dtype, shape and values."""
    tensors = {"x": ST_ARRAYS[name], "scalar": np.array(2.5, np.float32),
               "empty": np.zeros((0, 3), np.float32)}
    path = tmp_path / "t.safetensors"
    st_save_numpy(tensors, str(path))
    got, ref = tcheckpoint.load_safetensors(path), st_load_numpy(str(path))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])


def test_bf16_reads_widened_where_the_jax_converter_raises(tmp_path):
    """A BF16 checkpoint (the llama-3.2 releases ship BF16): the JAX
    converter's command raises ``TypeError`` (``safetensors.numpy`` knows
    no bfloat16 until ``ml_dtypes`` is loaded, as in a process that has
    imported JAX); the port's reader gives ``safetensors.torch``'s read
    widened to f32, bit for bit."""
    path = tmp_path / "src" / "model.safetensors"
    path.parent.mkdir()
    w = torch.randn(7, 5, generator=torch.Generator().manual_seed(0))
    st_save_torch({"model.embed_tokens.weight": w.bfloat16(),
                   "b": torch.ones(3)}, str(path))
    out = subprocess.run(
        [sys.executable, "-m", "audio_rag_tpu.convert", "llama",
         str(path.parent), str(tmp_path / "out")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "TypeError: data type 'bfloat16' not understood" in out.stderr
    got = tconvert.load_state_dict(path.parent)
    ref = st_load_torch(str(path))
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k].float().numpy())


def test_writer_round_trips_and_safetensors_reads_it(tmp_path):
    """``save_params`` → ``restore_params`` gives the tree back (lists
    included, each leaf's dtype kept, bf16 tensors widened), and
    ``safetensors.numpy`` reads the writer's file."""
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.standard_normal((2, 3)).astype(np.float16),
                        "res2net": [{"s": np.arange(3, dtype=np.float32)}]},
                       {"w": torch.arange(6.0).reshape(2, 3),
                        "res2net": [{"s": np.zeros(3, np.float32)}]}],
            "fc": {"w": torch.tensor([1.5, -2.0]).bfloat16(),
                   "i": np.arange(4, dtype=np.int64),
                   "t": np.arange(6, dtype=np.float32).reshape(2, 3).T}}
    path = tcheckpoint.save_params(tmp_path, "tree", tree)
    assert path == tmp_path / "tree.safetensors"
    back = tcheckpoint.restore_params(tmp_path, "tree")
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    assert isinstance(back["layers"][0]["res2net"], list)
    expect = {"layers": [{"w": tree["layers"][0]["w"],
                          "res2net": [{"s": np.arange(3, dtype=np.float32)}]},
                         {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
                          "res2net": [{"s": np.zeros(3, np.float32)}]}],
              "fc": {"w": np.array([1.5, -2.0], np.float32),
                     "i": tree["fc"]["i"], "t": np.ascontiguousarray(
                         tree["fc"]["t"])}}
    assert_same_tree(back, expect)
    raw = st_load_numpy(str(path))
    np.testing.assert_array_equal(raw["fc/t"], tree["fc"]["t"])
    assert tcheckpoint.restore_params(tmp_path, "missing") is None
    assert tcheckpoint.stored_elements(tmp_path, "tree") == 6 + 3 + 6 + 3 + 2 \
        + 4 + 6
    with pytest.raises(ValueError, match="complex"):
        tcheckpoint.save_params(tmp_path, "bad", {"x": np.zeros(2, complex)})


def test_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    st_save_numpy({"x": np.ones(64, np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="byte range"):
        tcheckpoint.load_safetensors(path)


# -- the converters against the JAX converters ----------------------------

def _vad_state_dict():
    torch.manual_seed(0)
    return {k: v.detach().numpy() for k, v in TorchVad().state_dict().items()}


CASES = {
    "whisper": lambda d: (tconvert.convert_whisper(d["whisper"]),
                          jconvert.convert_whisper(d["whisper"])),
    "whisper-f16": lambda d: (tconvert.convert_whisper(d["whisper_f16"]),
                              jconvert.convert_whisper(d["whisper_f16"])),
    "whisper-sharded": lambda d: (
        tconvert.convert_whisper(d["whisper_sharded"]),
        jconvert.convert_whisper(d["whisper_sharded"])),
    "whisper-bin": lambda d: (tconvert.convert_whisper(d["whisper_bin"]),
                              jconvert.convert_whisper(d["whisper_bin"])),
    "xlmr": lambda d: (
        tconvert.convert_xlmr_encoder(tconvert.load_state_dict(d["bgem3"])),
        jconvert.convert_xlmr_encoder(jconvert.load_state_dict(d["bgem3"]))),
    "bgem3": lambda d: (tconvert.convert_bgem3(d["bgem3"]),
                        jconvert.convert_bgem3(d["bgem3"])),
    "bgem3-no-sparse": lambda d: (tconvert.convert_bgem3(d["bgem3_bare"]),
                                  jconvert.convert_bgem3(d["bgem3_bare"])),
    "reranker": lambda d: (tconvert.convert_reranker(d["reranker"]),
                           jconvert.convert_reranker(d["reranker"])),
    "reranker-3-labels": lambda d: (tconvert.convert_reranker(d["nli"]),
                                    jconvert.convert_reranker(d["nli"])),
    "llama-untied": lambda d: (tconvert.convert_llama(d["llama"]),
                               jconvert.convert_llama(d["llama"])),
    "llama-tied": lambda d: (tconvert.convert_llama(d["llama_tied"]),
                             jconvert.convert_llama(d["llama_tied"])),
    "speaker": lambda d: (tconvert.convert_speaker(d["speaker"]),
                          jconvert.convert_speaker(d["speaker"])),
    "speaker-prefixed": lambda d: (
        tconvert.convert_speaker(d["speaker_prefixed"]),
        jconvert.convert_speaker(d["speaker_prefixed"])),
    "vad": lambda d: (tconvert.convert_vad_torch(_vad_state_dict()),
                      jconvert.convert_vad_torch(_vad_state_dict())),
}


@pytest.mark.parametrize("case", list(CASES))
def test_converter_matches_jax_bit_for_bit(hf_dirs, case):
    """The same keys, dtypes (F16 stays F16), shapes and bits as the
    JAX converter's tree on the same directory."""
    got, ref = CASES[case](hf_dirs)
    assert_same_tree(got, jax.tree.map(np.asarray, ref))
    if case == "whisper-f16":
        assert got["encoder"]["conv1"]["w"].dtype == np.float16


def test_f16_leaves_round_once_to_bf16(hf_dirs):
    """An F16 checkpoint's leaves stay F16 in the tree and reach a bf16
    backend in one rounding, as JAX's ``astype`` casts them."""
    tree = tconvert.convert_whisper(hf_dirs["whisper_f16"])
    got = flat_tree(whisper_params(tree, WHISPER, dtype=torch.bfloat16))
    for k, v in flat_tree(tree).items():
        assert v.dtype == np.float16
        ref = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
            jnp.float32))
        np.testing.assert_array_equal(got[k], ref, err_msg=k)


def test_bf16_llama_converts_to_the_widened_tree(hf_dirs):
    """A BF16 Llama: in a process with JAX loaded the JAX converter keeps
    bfloat16 leaves; the port's tree holds the same values in f32."""
    got = tconvert.convert_llama(hf_dirs["llama_bf16"])
    ref = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                       jconvert.convert_llama(hf_dirs["llama_bf16"]))
    assert_same_tree(got, ref)
    sd = st_load_torch(str(hf_dirs["llama_bf16"] / "model.safetensors"))
    np.testing.assert_array_equal(
        got["lm_head"]["w"], sd["lm_head.weight"].float().numpy().T)


def test_convert_cli_writes_params_and_tokenizer_files(hf_dirs, tmp_path):
    """``python -m audio_rag_tpu_torch.convert``: the tree under
    ``{dst}/{name}.safetensors``, the tokenizer files copied, the JSON
    line."""
    src = tmp_path / "src"
    src.mkdir()
    for f in hf_dirs["llama"].iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    (src / "tokenizer.json").write_text("{}")
    (src / "special_tokens_map.json").write_text("{}")
    dst = tmp_path / "dst"
    out = subprocess.run(
        [sys.executable, "-m", "audio_rag_tpu_torch.convert", "llama",
         str(src), str(dst)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["kind"] == "llama" and line["params_gb"] >= 0
    assert sorted(p.name for p in dst.iterdir()) == [
        "llm.safetensors", "special_tokens_map.json", "tokenizer.json"]
    assert_same_tree(tcheckpoint.restore_params(dst, "llm"),
                     jax.tree.map(np.asarray,
                                  jconvert.convert_llama(hf_dirs["llama"])))


# -- the models on the converted trees ------------------------------------

def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _whisper_logits(tree):
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, 80, 120)).astype(np.float32)
    ids = np.array([[1, 5, 9, 13]], np.int64)
    p = whisper_params(tree, WHISPER)
    enc = twhisper.encode(p, WHISPER, torch.from_numpy(mel), torch.float32)
    ckv = twhisper.precompute_cross_kv(p, WHISPER, enc, torch.float32)
    got = twhisper.decoder_forward(p, WHISPER, torch.from_numpy(ids), ckv,
                                   dtype=torch.float32)[0].numpy()
    jd = jwhisper.WHISPER_PRESETS["test"]
    jenc = jwhisper.encode(_jp(tree), jd, jnp.asarray(mel), dtype=jnp.float32)
    jckv = jwhisper.precompute_cross_kv(_jp(tree), jd, jenc,
                                        dtype=jnp.float32)
    jax_out = np.asarray(jwhisper.decoder_forward(
        _jp(tree), jd, jnp.asarray(ids.astype(np.int32)), jckv,
        dtype=jnp.float32)[0])
    return got, jax_out, {"input_features": torch.from_numpy(mel),
                          "decoder_input_ids": torch.from_numpy(ids)}


def _xlmr_states(tree):
    ids = np.array([[0, 17, 23, 42, 2, 1, 1]], np.int64)  # pad tail
    mask = (ids != 1).astype(np.int64)
    got = tbert.bert_encode(e5_params(tree, BERT), BERT,
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.float32).numpy()[:, :5]
    jax_out = np.asarray(jbert.bert_encode(
        _jp(tree), jbert.BERT_PRESETS["test"], jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32), dtype=jnp.float32))[:, :5]
    return got, jax_out, {"input_ids": torch.from_numpy(ids),
                          "attention_mask": torch.from_numpy(mask)}


def _cross_logits(tree):
    ids = np.array([[0, 17, 23, 2, 2, 42, 99, 2]], np.int64)
    mask = np.ones_like(ids)
    n_out = np.shape(tree["out"]["w"])[1]
    p = cross_encoder_params(tree, BERT)
    fwd_t = tce.nli_forward if n_out == 3 else tce.cross_encoder_forward
    fwd_j = jce.nli_forward if n_out == 3 else jce.cross_encoder_forward
    got = fwd_t(p, BERT, torch.from_numpy(ids), torch.from_numpy(mask),
                torch.float32).numpy().reshape(1, n_out)
    jax_out = np.asarray(fwd_j(_jp(tree), jbert.BERT_PRESETS["test"],
                               jnp.asarray(ids, jnp.int32),
                               jnp.asarray(mask, jnp.int32),
                               dtype=jnp.float32)).reshape(1, n_out)
    return got, jax_out, {"input_ids": torch.from_numpy(ids),
                          "attention_mask": torch.from_numpy(mask)}


def _llama_logits(tree):
    ids = np.array([[3, 17, 99, 254, 8]], np.int64)
    p = convert_llm(tree, LLAMA, dtype=torch.float32)
    got = tllm.llm_forward(p, LLAMA, torch.from_numpy(ids),
                           dtype=torch.float32)[0].numpy()
    jax_out = np.asarray(jllm.llm_forward(
        _jp(tree), jllm.LLM_PRESETS["test"], jnp.asarray(ids, jnp.int32),
        dtype=jnp.float32)[0])
    return got, jax_out, {"input_ids": torch.from_numpy(ids)}


MODELS = {
    "whisper": ("whisper", tconvert.convert_whisper, _whisper_logits,
                "logits"),
    "whisper-f16": ("whisper_f16", tconvert.convert_whisper,
                    _whisper_logits, "logits"),
    "xlmr": ("bgem3", lambda d: tconvert.convert_xlmr_encoder(
        tconvert.load_state_dict(d)), _xlmr_states, "last_hidden_state"),
    "reranker": ("reranker", tconvert.convert_reranker, _cross_logits,
                 "logits"),
    "nli": ("nli", tconvert.convert_reranker, _cross_logits, "logits"),
    "llama-untied": ("llama", tconvert.convert_llama, _llama_logits,
                     "logits"),
    "llama-tied": ("llama_tied", tconvert.convert_llama, _llama_logits,
                   "logits"),
}


def _hf_model(kind: str, d):
    from transformers import (
        LlamaForCausalLM,
        WhisperForConditionalGeneration,
        XLMRobertaForSequenceClassification,
        XLMRobertaModel,
    )

    cls = {"whisper": WhisperForConditionalGeneration,
           "whisper-f16": WhisperForConditionalGeneration,
           "xlmr": XLMRobertaModel,
           "reranker": XLMRobertaForSequenceClassification,
           "nli": XLMRobertaForSequenceClassification,
           "llama-untied": LlamaForCausalLM,
           "llama-tied": LlamaForCausalLM}[kind]
    kw = {"add_pooling_layer": False} if kind == "xlmr" else {}
    return cls.from_pretrained(d, torch_dtype=torch.float32, **kw).eval()


@pytest.mark.parametrize("kind", list(MODELS))
def test_model_on_converted_tree_matches_hf_and_jax(hf_dirs, kind):
    """The port's model on the converted tree against the HF model (at
    ``test_hf_parity.py``'s tolerance) and against the JAX model on the
    same tree (1e-5 of the largest output)."""
    key, conv, run, field = MODELS[kind]
    tree = conv(hf_dirs[key])
    got, jax_out, inputs = run(tree)
    with torch.no_grad():
        ref = getattr(_hf_model(kind, hf_dirs[key])(**inputs), field)
    ref = ref.float().numpy()[..., :got.shape[-2], :] if field == \
        "last_hidden_state" else ref.float().numpy().reshape(got.shape)
    np.testing.assert_allclose(got, ref, **HF_TOL)
    np.testing.assert_allclose(got, jax_out, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jax_out).max()))


def test_vad_on_converted_tree_matches_torch_and_jax():
    torch.manual_seed(0)
    model = TorchVad().eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = tconvert.convert_vad_torch(sd)
    mel = np.random.default_rng(0).standard_normal((2, 80, 50)).astype(
        np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(mel)).numpy()
    got = tspeaker.vad_scores(vad_params(tree), torch.from_numpy(mel),
                              dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    jax_out = np.asarray(jspeaker.vad_scores(_jp(tree), jnp.asarray(mel),
                                             dtype=jnp.float32))
    np.testing.assert_allclose(got, jax_out, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_profiles_keep_the_greedy_tokens(hf_dirs, bits):
    """The converted Whisper through the int8 (cross_kv_int8 +
    decoder_int8) and int4 (cross_kv_int4 + decoder_int4) decode
    profiles: the same greedy tokens as full precision, and the average
    log-probability within 0.1 (int8) / 0.3 (int4), as
    ``test_hf_parity.py`` holds the JAX model."""
    p = whisper_params(tconvert.convert_whisper(hf_dirs["whisper"]), WHISPER)
    mel = np.random.default_rng(1).standard_normal((2, 80, 120)).astype(
        np.float32)
    enc = twhisper.encode(p, WHISPER, torch.from_numpy(mel), torch.float32)
    prompt = torch.tensor([[1, 5], [1, 5]])
    ref = twhisper.greedy_decode(p, WHISPER, enc, prompt, 12, eot=2,
                                 dtype=torch.float32)
    q = twhisper.quantize_decoder_weights(p, WHISPER, bits)
    got = twhisper.greedy_decode(p, WHISPER, enc, prompt, 12, eot=2,
                                 dtype=torch.float32, cross_kv_quantize=True,
                                 decoder_q8=q, cross_kv_bits=bits)
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(),
                               atol=0.1 if bits == 8 else 0.3)


def test_rope_scaling_is_not_applied_as_in_jax(tmp_path):
    """A released llama-3.2 carries ``rope_scaling`` ("llama3"); neither
    converter reads ``config.json``, and neither model has the scaling:
    the port equals JAX, both compute HF's model without the scaling, and
    HF's model with it differs from them far beyond rounding."""
    scaled = tiny_llama_model(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16})
    scaled.save_pretrained(tmp_path, safe_serialization=True)
    tree = tconvert.convert_llama(tmp_path)
    ids = np.arange(3, 3 + 120, dtype=np.int64)[None] * 7 % 500
    got, jax_out, _ = _llama_logits_ids(tree, ids)
    np.testing.assert_allclose(got, jax_out, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jax_out).max()))
    with torch.no_grad():
        ref_scaled = scaled(torch.from_numpy(ids)).logits.numpy()
        ref_plain = tiny_llama_model()(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, ref_plain, **HF_TOL)
    assert np.abs(got - ref_scaled).max() > 10 * np.abs(got - ref_plain).max()


def _llama_logits_ids(tree, ids):
    p = convert_llm(tree, LLAMA, dtype=torch.float32)
    got = tllm.llm_forward(p, LLAMA, torch.from_numpy(ids),
                           dtype=torch.float32)[0].numpy()
    jax_out = np.asarray(jllm.llm_forward(
        _jp(tree), jllm.LLM_PRESETS["test"], jnp.asarray(ids, jnp.int32),
        dtype=jnp.float32)[0])
    return got, jax_out, None


# -- the HF-layout writers chip_smoke.py uses --------------------------------

@pytest.mark.parametrize("kind", ["whisper", "llama-untied", "llama-tied",
                                  "reranker", "bgem3"])
def test_layout_writers_give_the_transformers_state_dict(hf_dirs, kind,
                                                         tmp_path):
    """``tests/torch_hf_layout.py`` writes, from a converted tree, a
    directory that ``transformers`` loads into the same state dict as the
    directory it saved itself, and that converts back to the same
    tree."""
    import torch_hf_layout as layout

    key = {"llama-untied": "llama", "llama-tied": "llama_tied"}.get(kind,
                                                                     kind)
    conv = {"whisper": tconvert.convert_whisper,
            "bgem3": tconvert.convert_bgem3,
            "reranker": tconvert.convert_reranker}.get(
        kind, tconvert.convert_llama)
    tree = conv(hf_dirs[key])
    d = tmp_path / kind
    if kind == "whisper":
        layout.write_whisper(tree, d, WHISPER)
    elif kind.startswith("llama"):
        layout.write_llama(tree, d, LLAMA, tied=kind == "llama-tied")
    else:
        layout.write_xlmr(tree, d, BERT, classification=kind == "reranker")
    assert_same_tree(conv(d), tree)
    hf = {"llama-untied": "llama-untied", "llama-tied": "llama-tied",
          "bgem3": "xlmr"}.get(kind, kind)
    ours, theirs = (_hf_model(hf, d).state_dict(),
                    _hf_model(hf, hf_dirs[key]).state_dict())
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        if "token_type" in k or "position_embeddings" in k:
            continue  # the token-type row is folded into the positions
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
