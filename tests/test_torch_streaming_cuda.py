"""The streaming mux's batched dispatch on a card: eight live chunks in one
window batch of 8 against each chunk transcribed alone, on the committed
trained tiny-synth model in the int8 decode profile (``flash_attention``,
``matmul_q8w``, ``decode_cross_attention_q8``). Every test here is marked
``cuda`` and skips without one; run them on the card as
``tests/test_torch_kernels_cuda.py`` says (``--noconftest -m cuda``).

Tolerance: texts equal; segment and word bounds within 0.02 s (one encoder
frame: a batch of 8 sums some products in another order than a batch of
1)."""

import numpy as np
import pytest
import torch

from audio_rag_tpu_torch.asr.mux import StreamingMux
from audio_rag_tpu_torch.asr.whisper import WhisperASR
from audio_rag_tpu_torch.audio.charvoice import SR, synth_text
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import ASRConfig
from audio_rag_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

TOL = 0.02
PHRASES = ["the model learns fast and stops",
           "gradient descent minimizes the loss",
           "the spectrogram shows harmonic structure",
           "attention layers mix token information"]


@pytest.fixture(scope="module")
def asr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if not (ASSETS_DIR / "asr_tiny_synth.npz").exists():
        pytest.skip("trained ASR asset not built")
    asr = WhisperASR(ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False, cross_kv_int8=True, decoder_int8=True,
        max_decode_tokens=112), "cuda")
    asr.load()
    return asr


def _segments(segs):
    return [(s.text, s.start, s.end, [(w.text, w.start, w.end)
                                      for w in s.words]) for s in segs]


def test_mux_batch_of_8_matches_per_chunk_calls(asr):
    rng = np.random.default_rng(21)
    chunks = [synth_text(PHRASES[i % 4], rng, noise_level=0.005)
              for i in range(8)]
    mux = StreamingMux(asr, max_batch=8, linger_ms=500.0)
    try:
        mux.ensure_ready(SR, 4.0)
        K.reset_launches()
        futs = [mux.submit(c, SR, word_timestamps=True) for c in chunks]
        got = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        mux.stop()
    assert mux.batches_run == 1 and mux.chunks_served == 8
    assert asr.timings["windows"] == 8 and asr.timings["batches"] == 1
    for name in ("flash_attention", "matmul_q8w",
                 "decode_cross_attention_q8"):
        assert launches[name] > 0, launches
    for chunk, g in zip(chunks, got):
        want = asr.transcribe(chunk, SR, word_timestamps=True)
        assert [s.text for s in g] == [s.text for s in want]
        for a, b in zip(_segments(g), _segments(want)):
            assert abs(a[1] - b[1]) <= TOL and abs(a[2] - b[2]) <= TOL
            assert [w[0] for w in a[3]] == [w[0] for w in b[3]]
            for wa, wb in zip(a[3], b[3]):
                assert abs(wa[1] - wb[1]) <= TOL
                assert abs(wa[2] - wb[2]) <= TOL
    assert any("model" in s.text for s in got[0])
