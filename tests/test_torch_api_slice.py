"""The API as a whole on the trained spine (tiny-synth ASR, the trained
speaker model, the eval-small embedder; the committed assets), as
``tests/integration/test_trained_e2e.py`` drives the JAX package: the
port's server on the CPU with its inline worker takes a charvoice WAV by
multipart upload and drains it into the pipeline; an HTTP query for the
spoken words then ranks the chunks as the JAX pipeline ranks its own
ingest of the same WAV (the same chunks, texts and times, the same top
hits, scores within 1e-5); and a WebSocket session streaming the WAV as
int16 frames gives the transcripts of the port's in-process
``StreamingASR`` over a mux built the same way (text, start, end)."""

import asyncio
import dataclasses
import time

import pytest

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import wav_bytes as jax_wav_bytes
from audio_rag_tpu_torch.api import create_app
from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.asr.mux import StreamingMux
from audio_rag_tpu_torch.asr.streaming import StreamingASR
from audio_rag_tpu_torch.asr.whisper import WhisperASR
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from torch_api_client import (
    Served,
    WSClient,
    multipart,
    pcm_frames,
    request_json,
)
from torch_ledger_common import reset_ledgers
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import QUERIES, _jax_rag, _port_rag, _turn_audio

KEY = {"x-api-key": "dev-key-basic"}


@pytest.fixture(scope="module")
def spine(tmp_path_factory):
    if not (ASSETS_DIR / "asr_tiny_synth.npz").exists():
        pytest.skip("trained ASR asset not built")
    tmp = tmp_path_factory.mktemp("api_slice")
    reset_ledgers()  # whatever an earlier module left in either package
    rag = _port_rag({})
    app = create_app(APIConfig(upload_dir=str(tmp / "uploads"),
                               queue_db_path=str(tmp / "api.db"),
                               inline_worker=True), rag=rag)
    audio = _turn_audio()
    served = Served(app)
    yield {"rag": rag, "app": app, "port": served.port, "audio": audio,
           "wav": jax_wav_bytes(audio, SR), "tmp": tmp}
    served.stop()


def _rows(payloads):
    return [(p["text"], p["speaker"], round(float(p["start"]), 3),
             round(float(p["end"]), 3)) for p in payloads]


def test_uploaded_speech_is_found_as_the_jax_pipeline_finds_it(spine):
    body, ctype = multipart({"collection": "api", "priority": "high"},
                            [("file", "turns.wav", spine["wav"],
                              "audio/wav")])
    status, _, out = request_json(spine["port"], "POST", "/api/v1/ingest",
                                  headers={**KEY, "content-type": ctype},
                                  raw=body)
    assert status == 202 and out["queue"] == "high"
    job = out["job_id"]
    deadline = time.monotonic() + 120
    while True:
        status, _, st = request_json(spine["port"], "GET",
                                     f"/api/v1/jobs/{job}", headers=KEY)
        assert status == 200
        if st["status"] in ("completed", "failed"):
            break
        assert time.monotonic() < deadline, st
        time.sleep(0.1)
    assert st["status"] == "completed", st
    rows = _rows(spine["rag"].store._coll("api").payloads)
    assert st["result"]["num_chunks"] == len(rows) > 0

    jax_rag = _jax_rag({})
    try:
        path = spine["tmp"] / "turns.wav"
        path.write_bytes(spine["wav"])
        jax_rag.ingest(str(path), collection="api")
        assert rows == _rows(jax_rag._retriever._coll("api").payloads)
        tops = []
        for q in QUERIES:
            status, _, got = request_json(
                spine["port"], "POST", "/api/v1/query",
                {"query": q, "collection": "api", "top_k": 2,
                 "search_type": "hybrid"}, KEY)
            assert status == 200
            want = jax_rag.query(q, collection="api", top_k=2,
                                 search_type="hybrid").results
            assert [r["text"] for r in got["results"]] == [
                r.text for r in want]
            for g, w in zip(got["results"], want):
                assert abs(g["score"] - w.score) <= 1e-5
            # the ids are the port store's own chunks
            ids = {p["id"]: p["text"]
                   for p in spine["rag"].store._coll("api").payloads}
            assert all(ids[r["chunk_id"]] == r["text"]
                       for r in got["results"])
            tops.append(got["results"][0]["text"])
    finally:
        jax_rag.unload_all()
    # the spoken content is what the queries find
    assert "gradient" in tops[0] and "spectrogram" in tops[1], tops


def _in_process(rag, frames):
    """The session the route builds, driven in process: a mux over a
    Whisper backend from the pipeline's config with the streaming decode
    budget."""
    cfg = rag.config
    asr_cfg = cfg.asr
    if asr_cfg.max_decode_tokens is None:
        asr_cfg = dataclasses.replace(
            asr_cfg, max_decode_tokens=cfg.streaming.max_decode_tokens)
    mux = StreamingMux(WhisperASR(asr_cfg, device="cpu"))
    session = StreamingASR(cfg.asr, cfg.streaming.to_runtime(), mux=mux)

    async def run():
        out = []
        await session.start()
        for f in frames:
            r = await session.add_audio(f)
            if r is not None:
                out.append(r.to_dict())
        r = await session.stop()
        if r is not None:
            out.append(r.to_dict())
        return out

    try:
        session.load()
        return asyncio.new_event_loop().run_until_complete(run())
    finally:
        mux.stop()


def test_websocket_session_matches_the_in_process_stream(spine):
    frames = pcm_frames(spine["audio"][:12 * SR], SR)
    with WSClient(spine["port"], "/api/v1/ws/transcribe",
                  headers=KEY) as ws:
        msgs = [ws.recv_json()]
        for f in frames:
            ws.send_bytes(f)
        ws.send_json({"command": "stop"})
        while msgs[-1].get("status") != "stopped":
            msgs.append(ws.recv_json())
    assert msgs[0] == {"type": "status", "status": "listening"}
    got = [(m["text"], m["start"], m["end"]) for m in msgs
           if m["type"] == "transcript"]
    want = [(r["text"], r["start"], r["end"])
            for r in _in_process(spine["rag"], frames)]
    assert got == want and len(got) >= 2
    assert any("gradient" in t for t, _, _ in got), got
    status, _, st = request_json(spine["port"], "GET",
                                 "/api/v1/streaming/status", headers=KEY)
    assert status == 200 and st["chunks_served"] >= len(got)
    assert st["sessions"] == 0
