"""External TTS engines (counterpart of ``audio_rag_tpu/tts/external.py``;
host code only): ``PiperTTS`` runs the ``piper`` CLI on ``PATH`` (or the
``piper`` Python module), ``EdgeTTS`` the ``edge_tts`` package. Each fails
at ``load()`` with ``TTSError`` when its engine is absent, which is where the
query pipeline falls back to ``tts.fallback_backend``.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

from audio_rag_tpu_torch.config import TTSConfig
from audio_rag_tpu_torch.core.exceptions import TTSError
from audio_rag_tpu_torch.tts.base import BaseTTS, register_tts

__all__ = ["PiperTTS", "EdgeTTS", "EDGE_VOICES"]

EDGE_VOICES = {
    "en": "en-US-AriaNeural",
    "es": "es-ES-ElviraNeural",
    "fr": "fr-FR-DeniseNeural",
    "de": "de-DE-KatjaNeural",
    "hi": "hi-IN-SwaraNeural",
}


@register_tts("piper")
class PiperTTS(BaseTTS):
    def _load(self) -> None:
        if shutil.which("piper") is None:
            try:
                import piper  # noqa: F401
            except ImportError:
                raise TTSError(
                    "piper is not installed (neither CLI nor python module)",
                    context={"backend": "piper"},
                ) from None

    def synthesize(self, text: str, output_path: str | None = None) -> bytes:
        self.require_loaded()
        out = Path(output_path) if output_path else Path(
            tempfile.mkstemp(suffix=".wav")[1]
        )
        cli = shutil.which("piper")
        if cli:
            proc = subprocess.run(
                [cli, "--model", self.config.model, "--output_file", str(out)],
                input=text.encode(), capture_output=True, timeout=120,
            )
            if proc.returncode != 0:
                raise TTSError(
                    f"piper failed: {proc.stderr.decode()[:300]}",
                    context={"backend": "piper"},
                )
        else:
            import piper

            voice = piper.PiperVoice.load(self.config.model)
            with open(out, "wb") as f:
                voice.synthesize(text, f)
        data = out.read_bytes()
        if not output_path:
            out.unlink(missing_ok=True)
        return data


@register_tts("edge-tts")
class EdgeTTS(BaseTTS):
    def __init__(self, config: TTSConfig | None = None, language: str = "en"):
        super().__init__(config)
        self.language = language

    def _load(self) -> None:
        try:
            import edge_tts  # noqa: F401
        except ImportError:
            raise TTSError(
                "edge-tts is not installed",
                context={"backend": "edge-tts"},
            ) from None

    def synthesize(self, text: str, output_path: str | None = None) -> bytes:
        self.require_loaded()
        import asyncio

        import edge_tts

        voice = EDGE_VOICES.get(self.language, EDGE_VOICES["en"])

        async def run() -> bytes:
            com = edge_tts.Communicate(text, voice)
            chunks = []
            async for piece in com.stream():
                if piece["type"] == "audio":
                    chunks.append(piece["data"])
            return b"".join(chunks)

        data = asyncio.run(run())
        if output_path:
            with open(output_path, "wb") as f:
                f.write(data)
        return data
