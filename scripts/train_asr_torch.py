"""Train the tiny Whisper ASR (``tiny-synth``) on the synthetic charvoice
with the PyTorch/CUDA port, on one card.

Counterpart of ``scripts/train_asr.py`` (which trains the committed
``audio_rag_tpu/assets/asr_tiny_synth.npz``): the same dataset (4,096
utterances from the same seeds and draws, a sixth rendered by the trained
TTS, 35 % of the charvoice rows random-offset multi-utterance stream
windows), the same permutation, mel on the device through the port's
``log_mel_batch``, the same optimizer (global-norm clip 1.0, AdamW with
weight decay 0.01, warmup over min(200, steps/10) to 3e-4, cosine to 5 % of
it at the last step), batch ``i % n_batches`` at step ``i``, and the same
gates through the port's ``WhisperASR.transcribe`` on the trained weights:

* held-out charvoice WER ≤ 0.12;
* multi-window stream WER ≤ 0.30;
* TTS-rendered WER ≤ 0.50.

It imports the port only. The weights are saved (f16, as the committed
asset) to ``--out``, by default ``build/asr_tiny_synth_torch.npz`` (a
directory git ignores); the script never writes the committed asset. A
failed gate removes the output and exits 1, as the JAX script does. The
committed asset is transcribed on the same held-out and stream sets beside
the gates, for comparison only.

Run on the card: ``python3 scripts/train_asr_torch.py`` (9,000 steps), or
on the CPU at a small size: ``python3 scripts/train_asr_torch.py --device
cpu --steps 2``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "build" / "asr_tiny_synth_torch.npz"

from audio_rag_tpu_torch.audio.charvoice import (  # noqa: E402
    HOP,
    SR,
    char_duration,
    corpus_lexicon,
    make_utterance_texts,
    synth_text,
)

N_DATA = 4096
BATCH = 64
STEPS = 9000
CHUNK = 250  # steps a logged chunk
S = 128  # token context (== tiny-synth n_text_ctx)
LR = 3e-4
#: fraction of training samples rendered by the trained TTS asset instead
#: of the charvoice teacher (the TTS's Griffin-Lim rendering smears the
#: per-char spectra; an ASR trained on teacher audio alone scores WER 1.0
#: on it)
TTS_FRACTION = 1 / 6


def log(msg: str) -> None:
    print(msg, flush=True)


def make_stream_window(rng, lexicon, n_samp):
    """(audio_window, label_text): a 6 s window cut at a random offset
    from a multi-utterance stream with silence gaps, the shape
    ``transcribe`` feeds the model on long files. Labels are the chars
    whose spans lie wholly inside the window; boundary fragments stay
    unlabeled."""
    texts = make_utterance_texts(
        rng, int(rng.integers(2, 4)), lexicon,
        max_frames=330, max_chars=55)
    pieces = []
    spans = []  # (start_sample, end_sample, char)
    t = int(rng.uniform(0.0, 0.5) * SR)
    pieces.append(np.zeros(t, np.float32))
    for text in texts:
        for ch in text.lower():
            n = char_duration(ch) * HOP
            spans.append((t, t + n, ch))
            t += n
        pieces.append(synth_text(
            text, rng,
            noise_level=float(rng.uniform(0.0, 0.02)),
            gain=float(rng.uniform(0.5, 1.2))))
        gap = int(rng.uniform(0.2, 0.9) * SR)
        pieces.append(np.zeros(gap, np.float32))
        t += gap
    stream = np.concatenate(pieces)
    off = int(rng.integers(0, max(len(stream) - n_samp, 1)))
    win = np.zeros(n_samp, np.float32)
    seg = stream[off: off + n_samp]
    win[: len(seg)] = seg
    label = "".join(
        ch for s, e, ch in spans if s >= off and e <= off + n_samp
    ).strip()
    return win, label


def build_dataset(rng, texts, st, n_frames, tts=None, n_tts=0,
                  stream_fraction=0.35):
    """(audio, tokens, targets, mask) numpy arrays for all texts. The last
    ``n_tts`` texts are spoken by ``tts`` (``_synthesize_pcm``);
    ``stream_fraction`` of the charvoice samples are stream windows
    (:func:`make_stream_window`)."""
    from audio_rag_tpu_torch.models.whisper import char_encode

    n_samp = n_frames * HOP
    prompt = [st.sot, st.lang_base, st.transcribe, st.no_timestamps]
    audio = np.zeros((len(texts), n_samp), np.float32)
    tokens = np.full((len(texts), S), st.eot, np.int32)
    targets = np.full((len(texts), S), st.eot, np.int32)
    mask = np.zeros((len(texts), S), np.float32)
    lexicon = corpus_lexicon()
    for i, text in enumerate(texts):
        if tts is not None and i >= len(texts) - n_tts:
            wav = np.asarray(tts._synthesize_pcm(text), np.float32)
            wav = wav * float(rng.uniform(0.6, 1.1))
            onset = int(rng.integers(0, int(0.2 * SR)))
            n = min(wav.size, n_samp - onset)
            audio[i, onset: onset + n] = wav[:n]
        elif rng.random() < stream_fraction:
            audio[i], text = make_stream_window(rng, lexicon, n_samp)
        else:
            wav = synth_text(
                text, rng,
                noise_level=float(rng.uniform(0.0, 0.02)),
                gain=float(rng.uniform(0.5, 1.2)),
            )
            onset = int(rng.integers(0, int(0.2 * SR)))
            n = min(wav.size, n_samp - onset)
            audio[i, onset: onset + n] = wav[:n]
        seq = prompt + char_encode(text) + [st.eot]
        seq = seq[:S + 1]
        inp, tgt = seq[:-1], seq[1:]
        tokens[i, : len(inp)] = inp
        targets[i, : len(tgt)] = tgt
        # loss on predictions of text chars + the closing EOT only
        mask[i, len(prompt) - 1: len(tgt)] = 1.0
    return audio, tokens, targets, mask


def device_batches(torch, audio, tokens, targets, mask, n_mels, device):
    """The dataset on the device as (n_batches, BATCH, ...) tensors, the
    mel computed there 256 windows at a time."""
    from audio_rag_tpu_torch.ops.mel import log_mel_batch

    n = len(audio)
    n_batches = n // BATCH
    with torch.no_grad():
        mel = torch.cat([
            log_mel_batch(torch.from_numpy(audio[i: i + 256]).to(device),
                          n_mels=n_mels)
            for i in range(0, n, 256)])
    shape = (n_batches, BATCH)
    return {"mel": mel[: n_batches * BATCH].reshape(*shape, *mel.shape[1:]),
            **{k: torch.from_numpy(a[: n_batches * BATCH]).to(device)
               .reshape(*shape, S)
               for k, a in (("tokens", tokens), ("targets", targets),
                            ("mask", mask))}}


def train(torch, data: dict, steps: int, device, params: dict | None = None,
          chunk: int = CHUNK, schedule_steps: int | None = None,
          after_step=None):
    """Train ``tiny-synth`` for ``steps`` steps on ``data``
    (:func:`device_batches`) from ``params`` (default ``init_whisper`` of
    seed 0, drawn on the CPU so that every device starts from the same
    numbers), with the schedule of a ``schedule_steps`` run (default
    ``steps``); ``after_step(i, params)`` runs after step ``i``. Returns
    (params, losses per step as a list of floats, seconds of the step
    loop)."""
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS,
        init_whisper,
    )
    from audio_rag_tpu_torch.training import (
        Optimizer,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    dims = WHISPER_PRESETS["tiny-synth"]
    schedule_steps = schedule_steps or steps
    warmup = min(200, max(schedule_steps // 10, 1))
    cfg = TrainConfig(learning_rate=LR, weight_decay=0.01,
                      warmup_steps=warmup, grad_clip=1.0)
    opt = Optimizer(LR, 0.01, warmup, decay_steps=schedule_steps,
                    end_value=LR * 0.05, grad_clip=1.0)
    if params is None:
        params = init_whisper(dims, seed=0, device="cpu")
    params, opt, opt_state = init_train_state(params, cfg, dims, device,
                                              opt=opt)
    step = make_train_step(dims, cfg, opt)
    n_batches = data["mel"].shape[0]
    losses: list[float] = []
    t0 = time.perf_counter()
    for start in range(0, steps, chunk):
        got = []
        for i in range(start, min(start + chunk, steps)):
            b = i % n_batches
            params, opt_state, loss = step(
                params, opt_state, {k: v[b] for k, v in data.items()})
            got.append(loss)
            if after_step is not None:
                after_step(i, params)
        ls = torch.stack(got).tolist()  # one wait a chunk
        losses.extend(ls)
        log(f"steps {start}-{start + len(ls)}: loss {ls[0]:.4f} -> "
            f"{ls[-1]:.4f} ({time.perf_counter() - t0:.0f}s)")
    return params, losses, time.perf_counter() - t0


def held_out_audio(lexicon):
    """The gates' audio, drawn in the JAX script's order: 48 held-out
    utterances, then 8 three-utterance stream files (all from
    ``default_rng(12345)``)."""
    held_rng = np.random.default_rng(12345)
    held_texts = make_utterance_texts(held_rng, 48, lexicon)
    held = [(text, synth_text(text, held_rng,
                              noise_level=float(held_rng.uniform(0, 0.02)),
                              gain=float(held_rng.uniform(0.5, 1.2))))
            for text in held_texts]
    streams = []
    for _ in range(8):
        texts2 = make_utterance_texts(held_rng, 3, lexicon,
                                      max_frames=330, max_chars=55)
        pieces = [np.zeros(int(held_rng.uniform(0.1, 0.4) * SR),
                           np.float32)]
        for tx in texts2:
            pieces.append(synth_text(tx, held_rng, noise_level=0.005))
            pieces.append(np.zeros(
                int(held_rng.uniform(0.3, 0.8) * SR), np.float32))
        streams.append((" ".join(texts2), np.concatenate(pieces)))
    return held, streams


def transcribe_all(asr, pairs):
    return [(ref, " ".join(s.text for s in asr.transcribe(wav, SR)))
            for ref, wav in pairs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", type=Path, default=OUT,
                    help="where the trained weights go (never the "
                         "committed asset)")
    args = ap.parse_args()

    import torch

    from audio_rag_tpu_torch.checkpoint import (
        ASSETS_DIR,
        host_tree,
        save_npz_asset,
    )
    from audio_rag_tpu_torch.config import ASRConfig, TTSConfig
    from audio_rag_tpu_torch.device import resolve_device
    from audio_rag_tpu_torch.evaluation.wer import aggregate_wer, cer
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS,
        SpecialTokens,
    )
    from audio_rag_tpu_torch.tts.neural import NeuralTTS

    out = args.out.resolve()
    if out.parent == ASSETS_DIR.resolve():
        raise SystemExit(f"--out {out}: the committed assets are not "
                         "written by this script")
    device = resolve_device(args.device)
    dims = WHISPER_PRESETS["tiny-synth"]
    st = SpecialTokens.for_dims(dims)
    n_frames = 2 * dims.n_audio_ctx  # 600 mel frames = 6 s
    rng = np.random.default_rng(0)

    lexicon = corpus_lexicon()
    log(f"lexicon: {len(lexicon)} corpus words")
    texts = make_utterance_texts(rng, N_DATA, lexicon, double_p=0.10)
    tts = NeuralTTS(TTSConfig(backend="jax"), device=device)
    tts.load()
    n_tts = int(N_DATA * TTS_FRACTION)
    t0 = time.time()
    audio, tokens, targets, mask = build_dataset(
        rng, texts, st, n_frames, tts=tts, n_tts=n_tts)
    log(f"dataset: {len(texts)} utterances ({n_tts} TTS-rendered) in "
        f"{time.time() - t0:.1f}s "
        f"(mean len {np.mean([len(t) for t in texts]):.0f} chars)")

    # interleave the TTS-rendered tail through the batches
    perm = np.random.default_rng(7).permutation(N_DATA)
    audio, tokens, targets, mask = (
        audio[perm], tokens[perm], targets[perm], mask[perm])
    data = device_batches(torch, audio, tokens, targets, mask, dims.n_mels,
                          device)
    log(f"mel on {device}: {tuple(data['mel'].shape)}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, losses, seconds = train(torch, data, args.steps, device)
    peak = (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if device.type == "cuda" else "")
    log(f"trained {args.steps} steps in {seconds:.1f}s "
        f"({args.steps / seconds:.2f} steps/s{peak}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    del data

    out.parent.mkdir(parents=True, exist_ok=True)
    save_npz_asset(out, _f16(host_tree(params)))
    log(f"saved -> {out} ({out.stat().st_size / 1e6:.1f} MB); gating...")

    # -- gates: WER through the port's transcribe path -----------------------
    from audio_rag_tpu_torch.asr.whisper import WhisperASR

    def asr_for(weights):
        asr = WhisperASR(ASRConfig(
            model_size="tiny-synth", compute_type="float32",
            vad_filter=False, temperature_fallback=False),
            device=device, weights=weights)
        asr.load()
        return asr

    held, streams = held_out_audio(lexicon)
    asr = asr_for(out)
    pairs = transcribe_all(asr, held)
    held_w = aggregate_wer(pairs)
    held_cer = float(np.mean([cer(r, h) for r, h in pairs]))
    log(f"held-out charvoice WER: {held_w.wer:.4f} CER: {held_cer:.4f} "
        f"(S={held_w.substitutions} D={held_w.deletions} "
        f"I={held_w.insertions} / {held_w.n_ref} words)")
    for ref, hyp in pairs[:3]:
        log(f"  ref: {ref}\n  hyp: {hyp}")

    sw = aggregate_wer(transcribe_all(asr, streams))
    log(f"multi-window stream WER: {sw.wer:.4f} ({sw.n_ref} words)")

    # cross-model: the trained TTS speaks held-out text, the new ASR
    # transcribes it
    tts_pairs = transcribe_all(asr, [
        (text, np.asarray(tts._synthesize_pcm(text), np.float32))
        for text, _ in held[:16]])
    tw = aggregate_wer(tts_pairs)
    tts_cer = float(np.mean([cer(r, h) for r, h in tts_pairs]))
    log(f"TTS-rendered WER: {tw.wer:.4f} CER: {tts_cer:.4f} "
        f"({tw.n_ref} words)")
    for ref, hyp in tts_pairs[:2]:
        log(f"  ref: {ref}\n  hyp: {hyp}")

    asr.unload()
    committed = asr_for(ASSETS_DIR / "asr_tiny_synth.npz")
    cw = aggregate_wer(transcribe_all(committed, held))
    csw = aggregate_wer(transcribe_all(committed, streams))
    committed.unload()
    log(f"committed asset, same sets: held-out WER {cw.wer:.4f}, "
        f"multi-window stream WER {csw.wer:.4f} (for comparison; no gate)")

    # word-WER gate at 12 %: about half the held-out texts are random
    # letter strings, where one confused char fails the whole word; TTS
    # gate at 50 %: the Griffin-Lim rendering must carry signal
    if held_w.wer > 0.12 or sw.wer > 0.30 or tw.wer > 0.50:
        out.unlink(missing_ok=True)
        log("GATE FAILED; output removed")
        return 1
    log(f"gates passed; weights at {out}")
    return 0


def _f16(tree: dict) -> dict:
    return {k: _f16(v) if isinstance(v, dict) else v.astype(np.float16)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
