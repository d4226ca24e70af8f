"""Layered configuration loading (counterpart of
``audio_rag_tpu/config/loader.py``).

Order, later wins: the schema's defaults → ``configs/base.yaml`` →
``configs/{env}.yaml`` (``env`` or else ``AUDIO_RAG_ENV``) → the explicit
file (a missing one raises) → ``AUDIO_RAG__SECTION__KEY`` variables, with
the JAX loader's coercion table → ``overrides`` → the reference-name
aliases. ``AUDIO_RAG__DEVICE=cpu`` sets the port's top-level ``device``.
The environment is read at each call.

The merged tree is then built the way the JAX schema's pydantic models
build it: keys the schema does not know are dropped, each value is
coerced by its field's type in pydantic's lax mode (``16.0`` or ``"16"``
for an int, ``1`` for a float, ``"yes"``/``"off"``/``1``/``0`` for a
bool; ``16.5`` for an int, or a number for a string, raises) and held to
the field's allowed values and bounds. The JAX schema's fields that mean
nothing on one card (:data:`~audio_rag_tpu_torch.config.schema.
TPU_ONLY_FIELDS`) are dropped at their defaults ("auto" for ``device``);
any other value raises ``ConfigError`` naming the key. YAML is read by
the port's own reader (:mod:`audio_rag_tpu_torch.config._yaml`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from pathlib import Path
from typing import Any, Mapping

from audio_rag_tpu_torch.config._yaml import read_yaml
from audio_rag_tpu_torch.config.schema import (
    TPU_ONLY_FIELDS,
    AudioRAGConfig,
    validate,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError

log = logging.getLogger(__name__)

__all__ = ["load_config", "deep_merge", "apply_env_overrides",
           "normalize_reference_config", "ENV_PREFIX"]

ENV_PREFIX = "AUDIO_RAG__"


def deep_merge(base: dict[str, Any],
               override: Mapping[str, Any]) -> dict[str, Any]:
    """Recursively merge ``override`` into a copy of ``base``."""
    out = dict(base)
    for key, val in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(
                val, Mapping):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def _convert_value(raw: str) -> Any:
    """An environment string as bool / None / int / float, else itself."""
    low = raw.strip().lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none", ""):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def apply_env_overrides(data: dict[str, Any],
                        environ: Mapping[str, str] | None = None
                        ) -> dict[str, Any]:
    """``AUDIO_RAG__SECTION__KEY=value`` overrides (nested by ``__``); a
    path through a key that holds a scalar replaces it with a mapping."""
    env = environ if environ is not None else os.environ
    out = dict(data)
    for name, raw in env.items():
        if not name.startswith(ENV_PREFIX):
            continue
        path = [p.lower() for p in name[len(ENV_PREFIX):].split("__") if p]
        if not path:
            continue
        node = out
        for part in path[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
            node[part] = dict(nxt)
            node = node[part]
        node[path[-1]] = _convert_value(raw)
    return out


#: reference (CUDA-stack) names → the schema's, as the JAX loader maps them
_REFERENCE_ALIASES: dict[tuple[str, str], dict[str, Any]] = {
    ("asr", "backend"): {"faster-whisper": "whisper-jax"},
    ("diarization", "backend"): {"nemo": "clustering", "pyannote": "ahc"},
    ("retrieval", "backend"): {"qdrant": "tpu"},
    ("generation", "backend"): {"ollama": "llm-jax"},
    ("generation", "model"): {
        "llama3.2:3b": "llama-3.2-3b",
        "llama3.2:1b": "llama-3.2-1b",
    },
    ("tts", "fallback_backend"): {"edge-tts": "null"},
}


def normalize_reference_config(data: dict[str, Any]) -> dict[str, Any]:
    """Map a reference deployment's values to the schema's, in place:
    the aliases table, ``asr.compute_type`` float16 → bfloat16, and int8
    → bfloat16 with ``cross_kv_int8`` and ``decoder_int8`` on unless set
    (an explicit false stays false)."""
    for (section, key), mapping in _REFERENCE_ALIASES.items():
        sec = data.get(section)
        if isinstance(sec, dict) and sec.get(key) in mapping:
            old = sec[key]
            sec[key] = mapping[old]
            log.info("config: mapped reference %s.%s=%r -> %r",
                     section, key, old, sec[key])
    asr = data.get("asr")
    if isinstance(asr, dict):
        ct = asr.get("compute_type")
        if ct == "float16":
            asr["compute_type"] = "bfloat16"
        elif ct == "int8":
            asr["compute_type"] = "bfloat16"
            asr.setdefault("cross_kv_int8", True)
            asr.setdefault("decoder_int8", True)
    return data


# -- building the tree, as pydantic's lax mode builds it ----------------------------

_INT_TEXT = re.compile(r"^\s*[+-]?\d+(?:_\d+)*(?:\.0+)?\s*$")
_BOOL_TEXT = {"0": False, "off": False, "f": False, "false": False,
              "n": False, "no": False, "1": True, "on": True, "t": True,
              "true": True, "y": True, "yes": True}


class _Bad(Exception):
    pass


def _to_int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 63:
        return int(v)
    if isinstance(v, str) and _INT_TEXT.match(v):
        return int(v.strip().replace("_", "").split(".")[0])
    raise _Bad("a valid integer")


def _to_float(v: Any) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            pass
    raise _Bad("a valid number")


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _BOOL_TEXT:
        return _BOOL_TEXT[v.lower()]
    raise _Bad("a valid boolean")


def _to_str(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise _Bad("a valid string")


def _to_float_list(v: Any) -> list[float]:
    if isinstance(v, (list, tuple)):
        return [_to_float(x) for x in v]
    raise _Bad("a valid list")


_COERCE = {"int": _to_int, "float": _to_float, "bool": _to_bool,
           "str": _to_str, "list[float]": _to_float_list}


def _coerce(key: str, typ: str, value: Any) -> Any:
    optional = typ.endswith(" | None")
    if optional:
        typ = typ[: -len(" | None")]
        if value is None:
            return None
    try:
        return _COERCE[typ](value)
    except _Bad as exc:
        raise ConfigError(f"config validation failed: {key} must be "
                          f"{exc}; got {value!r}",
                          context={"field": key}) from None


def _tpu_only_default(key: str, value: Any) -> None:
    """Drop a TPU-only field at its default; raise at any other value."""
    default = TPU_ONLY_FIELDS[key]
    typ = {bool: "bool", int: "int", float: "float", str: "str"}[
        type(default)]
    try:
        same = _COERCE[typ](value) == default
    except _Bad:
        same = False
    if same:
        return
    if key.endswith(".device"):
        raise ConfigError(
            f"{key}={value!r} names a TPU device choice; the port runs on "
            f"one card, chosen by the top-level 'device' "
            f"(AUDIO_RAG__DEVICE=cuda|cpu)", context={"field": key})
    raise ConfigError(f"{key}={value!r}: the port runs on one card and "
                      f"takes {key} only at its default {default!r}",
                      context={"field": key})


def _section(cls, data: Any, path: str):
    """An instance of the dataclass ``cls`` from the mapping ``data``."""
    if not isinstance(data, Mapping):
        raise ConfigError(f"config validation failed: {path or 'root'} "
                          f"must be a mapping; got {data!r}",
                          context={"field": path})
    kwargs: dict[str, Any] = {}
    known = {f.name: f for f in dataclasses.fields(cls)}
    prefix = f"{path}." if path else ""
    for name, value in data.items():
        key = f"{prefix}{name}"
        if key in TPU_ONLY_FIELDS:
            _tpu_only_default(key, value)
            continue
        if not path and name == "mesh":
            if not isinstance(value, Mapping):
                raise ConfigError("config validation failed: mesh must be "
                                  f"a mapping; got {value!r}",
                                  context={"field": "mesh"})
            for sub, v in value.items():
                if f"mesh.{sub}" in TPU_ONLY_FIELDS:
                    _tpu_only_default(f"mesh.{sub}", v)
            continue
        f = known.get(name)
        if f is None:  # as pydantic drops keys its models do not declare
            continue
        if dataclasses.is_dataclass(f.default_factory if f.default is
                                    dataclasses.MISSING else f.default):
            kwargs[name] = _section(f.default_factory, value, key)
        else:
            kwargs[name] = _coerce(key, f.type, value)
    try:
        return cls(**kwargs)
    except ConfigError as exc:
        raise ConfigError(f"config validation failed: {prefix}{exc.message}",
                          context=exc.context) from None


def load_config(config_path: str | Path | None = None,
                env: str | None = None,
                configs_dir: str | Path = "configs",
                overrides: Mapping[str, Any] | None = None
                ) -> AudioRAGConfig:
    """The layered config (see the module docstring for the order)."""
    data: dict[str, Any] = {}
    cdir = Path(configs_dir)
    base = cdir / "base.yaml"
    if base.is_file():
        data = deep_merge(data, read_yaml(base))
    env = env or os.environ.get("AUDIO_RAG_ENV")
    if env:
        env_file = cdir / f"{env}.yaml"
        if env_file.is_file():
            data = deep_merge(data, read_yaml(env_file))
    if config_path is not None:
        p = Path(config_path)
        if not p.is_file():
            raise ConfigError(f"config file not found: {p}",
                              context={"path": str(p)})
        data = deep_merge(data, read_yaml(p))
    data = apply_env_overrides(data)
    if overrides:
        data = deep_merge(data, overrides)
    cfg = _section(AudioRAGConfig, normalize_reference_config(data), "")
    validate(cfg)
    return cfg
