"""Request and response schemas (counterpart of
``audio_rag_tpu/api/schemas.py``; its nine pydantic models become
dataclasses with the same fields, defaults and ``to_dict()`` keys, in
``model_dump()``'s order with ``None`` fields kept).

:class:`QueryRequest` validates its keyword arguments as pydantic's
default (lax) mode does for its fields: ``query`` 1 to 4096 characters,
``1 ≤ top_k ≤ 100``, ``search_type`` one of "dense", "sparse", "hybrid",
and coercion (``"5"`` or ``5.0`` → 5, ``"true"``/``"yes"``/``1`` →
True); undeclared keys are dropped. A body that does not fit raises
:class:`ValidationError`, whose ``errors()`` carry pydantic's ``loc``
lists (the middleware answers 422); the ``msg`` texts are the port's own.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

from audio_rag_tpu_torch.config.loader import _Bad, _to_bool, _to_int, _to_str

__all__ = [
    "ValidationError",
    "ErrorResponse",
    "QueryRequest",
    "QueryResponse",
    "RetrievalResultModel",
    "IngestResponse",
    "JobStatusResponse",
    "JobCancelResponse",
    "CollectionInfo",
    "QueueStatsResponse",
]


class ValidationError(ValueError):
    """A request that does not fit its schema; ``errors()`` lists
    ``{"loc": (field,), "msg": ...}`` a field, in field order."""

    def __init__(self, errors: list[dict[str, Any]]):
        self._errors = errors
        super().__init__("; ".join(f"{'.'.join(map(str, e['loc']))}: "
                                   f"{e['msg']}" for e in errors))

    def errors(self) -> list[dict[str, Any]]:
        return list(self._errors)


class _Model:
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ErrorResponse(_Model):
    error: str
    detail: str | None = None
    request_id: str | None = None
    recoverable: bool | None = None


# -- QueryRequest's field checks ----------------------------------------------------

_REQUIRED = object()


def _text(min_length: int, max_length: int) -> Callable[[Any], str]:
    def check(v: Any) -> str:
        v = _to_str(v)
        if len(v) < min_length:
            raise _Bad(f"at least {min_length} character long")
        if len(v) > max_length:
            raise _Bad(f"at most {max_length} characters long")
        return v
    return check


def _int_in(lo: int, hi: int) -> Callable[[Any], int]:
    def check(v: Any) -> int:
        v = _to_int(v)
        if v < lo:
            raise _Bad(f"greater than or equal to {lo}")
        if v > hi:
            raise _Bad(f"less than or equal to {hi}")
        return v
    return check


def _one_of(*choices: str) -> Callable[[Any], str]:
    def check(v: Any) -> str:
        if isinstance(v, str) and v in choices:
            return v
        raise _Bad(" or ".join(map(repr, choices)))
    return check


def _optional(check: Callable[[Any], Any]) -> Callable[[Any], Any]:
    return lambda v: None if v is None else check(v)


def _mapping(v: Any) -> dict:
    if isinstance(v, dict):
        return v
    raise _Bad("a valid dictionary")


#: (field, default or _REQUIRED, check), in the JAX model's order
_QUERY_FIELDS: tuple[tuple[str, Any, Callable[[Any], Any]], ...] = (
    ("query", _REQUIRED, _text(1, 4096)),
    ("collection", None, _optional(_to_str)),
    ("top_k", 5, _int_in(1, 100)),
    ("search_type", "hybrid", _one_of("dense", "sparse", "hybrid")),
    ("use_hyde", False, _to_bool),
    ("rerank", True, _to_bool),
    ("generate_answer", False, _to_bool),
    ("speak_answer", False, _to_bool),
    ("include_context", False, _to_bool),
    ("metadata_filter", None, _optional(_mapping)),
)


@dataclass(init=False)
class QueryRequest(_Model):
    query: str
    collection: str | None = None
    top_k: int = 5
    search_type: str = "hybrid"
    use_hyde: bool = False
    rerank: bool = True
    generate_answer: bool = False
    speak_answer: bool = False
    include_context: bool = False
    metadata_filter: dict[str, Any] | None = None

    def __init__(self, **data: Any):
        errors = []
        for name, default, check in _QUERY_FIELDS:
            if name not in data:  # defaults are not validated
                if default is _REQUIRED:
                    errors.append({"loc": (name,), "msg": "Field required"})
                setattr(self, name, default)
                continue
            try:
                setattr(self, name, check(data[name]))
            except _Bad as exc:
                errors.append({"loc": (name,),
                               "msg": f"Input should be {exc}"})
        if errors:
            raise ValidationError(errors)


@dataclass
class RetrievalResultModel(_Model):
    text: str
    score: float
    start: float
    end: float
    speaker: str | None = None
    chunk_id: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class QueryResponse(_Model):
    query: str
    results: list[RetrievalResultModel]
    response: str
    answer: str | None = None
    expanded_query: str | None = None
    context: str | None = None
    #: base64 WAV of the spoken answer when ``speak_answer`` was asked for
    answer_audio_b64: str | None = None
    elapsed_s: float
    stage_timings: dict[str, float] = field(default_factory=dict)
    request_id: str | None = None


@dataclass
class IngestResponse(_Model):
    job_id: str
    status: str
    queue: str
    estimated_wait_s: float
    collection: str | None = None
    request_id: str | None = None


@dataclass(kw_only=True)
class JobStatusResponse(_Model):
    job_id: str
    status: str
    stage: str | None = None
    progress: float
    queue: str | None = None
    error: str | None = None
    created_at: float | None = None
    updated_at: float | None = None
    result: dict[str, Any] | None = None


@dataclass
class JobCancelResponse(_Model):
    job_id: str
    cancelled: bool


@dataclass
class CollectionInfo(_Model):
    name: str
    count: int
    dim: int | None = None
    hbm_bytes: int | None = None


@dataclass
class QueueStatsResponse(_Model):
    queues: dict[str, dict[str, Any]]
    workers: dict[str, dict[str, Any]]
