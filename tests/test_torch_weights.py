"""Carry-over of the JAX package's parameter trees into the PyTorch port
(``audio_rag_tpu_torch.weights``): every leaf, its dtype, and the errors on
trees that do not fit the model."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import bert as jbert
from audio_rag_tpu.models import bgem3 as jbgem3
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import bert as tbert
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import (
    bgem3_params,
    whisper_params,
    whisper_q8_params,
)

DIMS = tw.WHISPER_PRESETS["test"]
BDIMS = tbert.BERT_PRESETS["test"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.fixture(scope="module")
def whisper_tree():
    return jax.tree.map(np.asarray, jw.init_whisper(jax.random.PRNGKey(0),
                                                    jw.WHISPER_PRESETS["test"]))


@pytest.fixture(scope="module")
def bgem3_tree():
    return jax.tree.map(np.asarray, jbgem3.init_bgem3(
        jax.random.PRNGKey(0), jbert.BERT_PRESETS["test"]))


def _assert_same_leaves(got, ref, dtype):
    flat_g, flat_r = _flat(got), _flat(ref)
    assert flat_g.keys() == flat_r.keys()
    for key, leaf in flat_r.items():
        t = flat_g[key]
        assert t.dtype == dtype, key
        expect = torch.from_numpy(np.array(leaf, np.float32)).to(dtype)
        assert torch.equal(t, expect), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_tree_round_trips(whisper_tree, dtype):
    got = whisper_params(whisper_tree, DIMS, "cpu", dtype=dtype)
    _assert_same_leaves(got, whisper_tree, dtype)


def test_bf16_jax_leaves_carry_over_bit_exactly(whisper_tree):
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        whisper_tree)
    assert _flat(bf16)["decoder/pos_emb"].dtype == ml_dtypes.bfloat16
    got = whisper_params(bf16, DIMS, "cpu", dtype=torch.bfloat16)
    for key, leaf in _flat(bf16).items():
        bits = torch.from_numpy(leaf.view(np.uint16).astype(np.int32))
        assert torch.equal(_flat(got)[key].view(torch.int16).int() & 0xFFFF,
                           bits), key


def test_int8_decoder_tree_round_trips(whisper_tree):
    jp = jax.tree.map(jnp.asarray, whisper_tree)
    tree = jax.tree.map(np.asarray, jw.quantize_decoder_weights(
        jp, jw.WHISPER_PRESETS["test"]))
    got = whisper_q8_params(tree, DIMS, "cpu")
    assert len(got["blocks"]) == DIMS.n_text_layer
    pairs = list(zip(got["blocks"], tree["blocks"])) + [
        ({"logits": got["logits"]}, {"logits": tree["logits"]})]
    for g, r in pairs:
        for key, leaf in _flat(r).items():
            t = _flat(g)[key]
            want = torch.int8 if key.endswith("w8") else torch.float32
            assert t.dtype == want, key
            assert torch.equal(t, torch.from_numpy(np.array(leaf))), key
    assert got["logits"]["w8"].shape == (DIMS.n_text_state, 1024)


def test_bgem3_tree_round_trips(bgem3_tree):
    got = bgem3_params(bgem3_tree, BDIMS, "cpu")
    _assert_same_leaves(got, bgem3_tree, torch.float32)


def _without(tree, path):
    import copy

    out = copy.deepcopy(tree)
    node = out
    for p in path[:-1]:
        node = node[p]
    del node[path[-1]]
    return out


def test_missing_unknown_and_misshaped_leaves_raise(whisper_tree, bgem3_tree):
    with pytest.raises(KeyError, match="missing"):
        whisper_params(_without(whisper_tree, ["encoder", "conv1", "b"]),
                       DIMS)
    extra = dict(whisper_tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unknown"):
        whisper_params(extra, DIMS)
    with pytest.raises(KeyError, match="missing"):
        bgem3_params(_without(bgem3_tree, ["sparse", "w"]), BDIMS)
    with pytest.raises(ValueError, match="shape"):
        whisper_params(whisper_tree, tw.WHISPER_PRESETS["tiny-synth"])
    ints = dict(bgem3_tree, sparse={"w": np.zeros((BDIMS.d_model, 1),
                                                  np.int32),
                                    "b": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="floating"):
        bgem3_params(ints, BDIMS)


def test_bad_int8_trees_raise(whisper_tree):
    jp = jax.tree.map(jnp.asarray, whisper_tree)
    tree = jax.tree.map(np.asarray, jw.quantize_decoder_weights(
        jp, jw.WHISPER_PRESETS["test"]))
    with pytest.raises(ValueError, match="layers"):
        whisper_q8_params({"blocks": tree["blocks"][:1],
                           "logits": tree["logits"]}, DIMS)
    with pytest.raises(KeyError):
        whisper_q8_params({"blocks": tree["blocks"]}, DIMS)
    bad = {"blocks": tree["blocks"], "logits": {
        "w8": tree["logits"]["w8"].astype(np.float32),
        "s": tree["logits"]["s"]}}
    with pytest.raises(ValueError, match="dtype"):
        whisper_q8_params(bad, DIMS)
    renamed = [dict(b) for b in tree["blocks"]]
    renamed[0]["attn_qq"] = renamed[0].pop("attn_q")
    with pytest.raises(KeyError):
        whisper_q8_params({"blocks": renamed, "logits": tree["logits"]},
                          DIMS)
