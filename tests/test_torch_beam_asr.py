"""Beam search of the PyTorch port against the JAX package on the CPU,
part 3 of 3 (see ``test_torch_beam.py``): the ASR backend's choice of
decode strategy and its iteration counts, and ``beam_decode``'s tokens on
the committed trained tiny model in the fp32 and int8-weight profiles, in
each reorder mode."""

import numpy as np
import pytest

from audio_rag_tpu_torch.models import whisper as tw
from torch_beam_common import (  # noqa: F401
    check_beam_decode_on_trained_model,
    synth,
)
from torch_llm_common import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", tw.BEAM_REORDERS)
@pytest.mark.parametrize("profile", ["fp32", "int8-weights"])
def test_beam_decode_matches_jax_on_trained_model(synth, profile, mode):
    """The port's beam-5 hypothesis equals the JAX package's in each decode
    profile and each reorder mode (the JAX package's "kernel" mode is its
    one-hot reorder off the TPU, and its lazy mode gives the one-hot
    tokens). The unquantized profiles hear the spoken words."""
    check_beam_decode_on_trained_model(synth, profile, mode)


@pytest.mark.parametrize("switches,decoder", [
    ({"decode": "beam", "beam_size": 3}, "beam_decode"),
    ({"speculative_k": 4}, "speculative_greedy_decode"),
    ({"speculative_k": 4, "decode": "beam"}, "beam_decode"),
])
def test_asr_picks_the_strategy_and_counts_its_iterations(monkeypatch,
                                                          switches, decoder):
    """Beam wins over speculative; ``decode_steps`` sums the iterations
    the decode loops report (for beam: until every hypothesis finished);
    beam's zero no-speech probability keeps every window."""
    from audio_rag_tpu_torch.asr import whisper as aw
    from audio_rag_tpu_torch.config import ASRConfig

    calls = []
    orig = getattr(aw, decoder)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(aw, decoder, spy)
    asr = aw.WhisperASR(ASRConfig(model_size="test", compute_type="float32",
                                  window_batch_size=2, vad_filter=False,
                                  **switches), "cpu")
    audio = 0.05 * np.random.default_rng(0).standard_normal(
        16000 * 4).astype(np.float32)
    segs = asr.transcribe(audio, 16000)
    assert calls and asr.timings["decode_steps"] == sum(calls)
    if decoder == "beam_decode":
        assert len(segs) == asr.timings["windows"]
