"""The LLM serving programs on a card with the weight-matmul kernels
against their plain versions: the verify pass at B·k rows, a continuous
segment's slots and the speculative single stream, on the committed
trained generator (``llm_small.npz``) with int8 decode weights. Every test
here is marked ``cuda`` and skips without one; run them on the card as
``tests/test_torch_kernels_cuda.py`` says (``--noconftest -m cuda``).

Tolerance: logits within 0.1 of the plain path's (the kernels sum each
product in another order, which moves this asset's logits, up to ~20 in
magnitude, by a few bf16 ulps through the rounded activations); tokens
equal."""

import contextlib

import pytest
import torch

from audio_rag_tpu_torch.models import llm as tl
from audio_rag_tpu_torch.ops import kernels as K
from audio_rag_tpu_torch.ops import random as trandom
from audio_rag_tpu_torch.weights import load_llm_small

pytestmark = pytest.mark.cuda

EOS = 2
ATOL = 0.1


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = load_llm_small("cuda")
    if params is None:
        pytest.skip("trained LLM asset not built")
    dims = tl.LLM_PRESETS["eval-small"]
    return dims, params, tl.quantize_llm_weights(params, dims, 8)


@contextlib.contextmanager
def _plain():
    saved = K.matmul_q8w
    K.matmul_q8w = K.matmul_q8w_plain
    try:
        yield
    finally:
        K.matmul_q8w = saved


def _cache(dims, B, C, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd = dims.d_model // dims.n_heads
    shape = (dims.n_layers, B, dims.n_kv_heads, C, hd)
    return [torch.randn(shape, generator=g, device="cuda").bfloat16()
            for _ in range(2)]


@pytest.mark.parametrize("B,k", [(1, 8), (8, 8), (4, 4)])
def test_verify_kernels_match_plain(model, B, k):
    """One verify block at per-row positions: 4 · L + 1 ``matmul_q8w``
    launches at B·k rows, logits within ``ATOL`` of the plain path's, the
    same argmax everywhere the plain one has a clear winner."""
    dims, params, q8 = model
    g = torch.Generator(device="cuda").manual_seed(B * 10 + k)
    block = torch.randint(4, dims.vocab, (B, k), generator=g, device="cuda")
    pos = torch.randint(0, 60, (B,), generator=g, device="cuda")
    outs = []
    for plain in (False, True):
        ck, cv = _cache(dims, B, 72, 1)
        K.reset_launches()
        with _plain() if plain else contextlib.nullcontext():
            lg, *_ = tl.llm_block_verify(params, dims, block, pos, ck, cv,
                                         q8=q8)
        torch.cuda.synchronize()
        if not plain:
            assert K.LAUNCHES["matmul_q8w"] == 4 * dims.n_layers + 1
        outs.append(lg)
    torch.testing.assert_close(outs[0], outs[1], atol=ATOL, rtol=0)


def test_slot_segment_and_spec_stream_match_plain(model):
    """A greedy 8-slot segment of 16 steps (one launch set a step) gives
    the plain path's tokens; the speculative single stream gives the wave's
    tokens with the kernels."""
    dims, params, q8 = model
    B, C = 8, 96
    g = torch.Generator(device="cuda").manual_seed(3)
    last = torch.randint(4, dims.vocab, (B,), generator=g, device="cuda")
    pos = torch.randint(8, 40, (B,), generator=g, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    toks = []
    for plain in (False, True):
        ck, cv = _cache(dims, B, C, 2)
        K.reset_launches()
        with _plain() if plain else contextlib.nullcontext():
            t, *_ = tl.llm_decode_slots(params, dims, last, ck, cv, pos,
                                        active, [0.0] * B,
                                        trandom.PRNGKey(1), 16, EOS, q8=q8)
        torch.cuda.synchronize()
        if not plain:
            assert K.LAUNCHES["matmul_q8w"] == 16 * (4 * dims.n_layers + 1)
        toks.append(t)
    assert torch.equal(toks[0], toks[1])
    prompt = torch.randint(4, dims.vocab, (1, 24), generator=g,
                           device="cuda")
    spec, _ = tl.llm_speculative_generate(params, dims, prompt, 24, EOS,
                                          spec_k=8, decoder_q8=q8)
    wave = tl.llm_generate(params, dims, prompt, 24, EOS, decoder_q8=q8)
    assert torch.equal(spec, wave)


def test_slots_stepping_past_the_cache_end(model):
    """A slot that reaches the cache's last frame inside a segment steps on
    without writing (no out-of-bounds index on the card): its cache row
    and tokens up to that frame are those of a segment that stopped there,
    and the kernels give the plain path's tokens."""
    dims, params, q8 = model
    B, C = 2, 40
    last = torch.tensor([11, 12], device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    runs = {}
    for n, plain in ((16, False), (10, False), (16, True)):
        ck, cv = _cache(dims, B, C, 4)
        pos = torch.tensor([30, 20], device="cuda")
        with _plain() if plain else contextlib.nullcontext():
            t, ck, cv, new_pos, _ = tl.llm_decode_slots(
                params, dims, last, ck, cv, pos, active, [0.0] * B,
                trandom.PRNGKey(5), n, -1, q8=q8)  # no EOS: every step runs
        torch.cuda.synchronize()
        runs[n, plain] = t, ck, cv, new_pos
    t16, ck16, cv16, pos16 = runs[16, False]
    t10, ck10, cv10, _ = runs[10, False]
    assert int(pos16[0]) > C
    assert torch.equal(ck16[:, 0], ck10[:, 0])
    assert torch.equal(cv16[:, 0], cv10[:, 0])
    assert torch.equal(t16[0, :10], t10[0])
    assert torch.equal(t16, runs[16, True][0])
