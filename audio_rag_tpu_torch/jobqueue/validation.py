"""Pre-queue validation of audio files and tenant ids (counterpart of
``audio_rag_tpu/jobqueue/validation.py``):

* ``AudioValidator``: extension, size, emptiness, duration probe (warn-only
  when the probe fails, so streams without headers still queue);
* ``TenantValidator``: the strict ``audio_rag_{uni}_{dept}_{course}_{sem}``
  grammar and a permissive simple mode, with parse/build helpers;
* ``JobValidator``: both.

The duration probe is the port's :func:`audio_rag_tpu_torch.audio.io.
get_duration` (the WAV header, else a decode).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path

from audio_rag_tpu_torch.jobqueue.exceptions import (
    InvalidAudioError,
    InvalidTenantError,
)

log = logging.getLogger(__name__)

__all__ = ["AudioValidator", "TenantValidator", "JobValidator",
           "TenantInfo"]

ALLOWED_EXTENSIONS = {
    ".wav", ".mp3", ".m4a", ".flac", ".ogg", ".opus", ".webm", ".mp4",
}
MAX_FILE_BYTES = 500 * 1024 * 1024  # the API's upload limit
MAX_DURATION_S = 480 * 60  # hour-scale first-class (ref capped at 180 min)

STRICT_TENANT_RE = re.compile(
    r"^audio_rag_(?P<university>[a-z0-9]+)_(?P<department>[a-z0-9]+)"
    r"_(?P<course>[a-z0-9]+)_(?P<semester>[a-z0-9]+)$"
)
SIMPLE_TENANT_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{1,62}[a-z0-9]$")


@dataclass
class TenantInfo:
    university: str
    department: str
    course: str
    semester: str

    @property
    def tenant_id(self) -> str:
        return (
            f"audio_rag_{self.university}_{self.department}"
            f"_{self.course}_{self.semester}"
        )


class AudioValidator:
    def __init__(
        self,
        max_bytes: int = MAX_FILE_BYTES,
        max_duration_s: float = MAX_DURATION_S,
        allowed_extensions: set[str] | None = None,
    ):
        self.max_bytes = max_bytes
        self.max_duration_s = max_duration_s
        self.allowed_extensions = allowed_extensions or ALLOWED_EXTENSIONS

    def validate(self, path: str | Path) -> None:
        p = Path(path)
        if not p.is_file():
            raise InvalidAudioError("file not found", str(p))
        ext = p.suffix.lower()
        if ext not in self.allowed_extensions:
            raise InvalidAudioError(
                f"unsupported extension {ext!r} "
                f"(allowed: {sorted(self.allowed_extensions)})", str(p)
            )
        size = p.stat().st_size
        if size == 0:
            raise InvalidAudioError("file is empty", str(p))
        if size > self.max_bytes:
            raise InvalidAudioError(
                f"file too large ({size} > {self.max_bytes} bytes)", str(p)
            )
        # the duration probe is warn-only
        try:
            from audio_rag_tpu_torch.audio.io import get_duration

            duration = get_duration(p)
            if duration > self.max_duration_s:
                raise InvalidAudioError(
                    f"audio too long ({duration:.0f}s > "
                    f"{self.max_duration_s:.0f}s)", str(p)
                )
        except InvalidAudioError:
            raise
        except Exception as exc:
            log.warning("duration probe failed for %s: %s (continuing)",
                        p, exc)


class TenantValidator:
    def __init__(self, strict: bool = False):
        self.strict = strict

    def validate(self, tenant_id: str) -> None:
        if not tenant_id:
            raise InvalidTenantError(tenant_id, "empty")
        if self.strict:
            if not STRICT_TENANT_RE.match(tenant_id):
                raise InvalidTenantError(
                    tenant_id,
                    "expected audio_rag_{university}_{department}"
                    "_{course}_{semester}",
                )
        elif not SIMPLE_TENANT_RE.match(tenant_id):
            raise InvalidTenantError(
                tenant_id,
                "3-64 chars of [a-z0-9_-], alnum at both ends",
            )

    @staticmethod
    def parse(tenant_id: str) -> TenantInfo:
        m = STRICT_TENANT_RE.match(tenant_id)
        if not m:
            raise InvalidTenantError(tenant_id, "not in strict format")
        return TenantInfo(**m.groupdict())

    @staticmethod
    def build(university: str, department: str, course: str,
              semester: str) -> str:
        return TenantInfo(university, department, course, semester).tenant_id


class JobValidator:
    def __init__(self, strict_tenants: bool = False,
                 audio: AudioValidator | None = None):
        self.audio = audio or AudioValidator()
        self.tenant = TenantValidator(strict=strict_tenants)

    def validate(self, job) -> None:
        self.tenant.validate(job.tenant_id)
        self.audio.validate(job.audio_path)
