"""ctypes bindings of the port's native audio runtime
(``csrc/audio_native.cpp``): WAV decode, the Kaiser-sinc polyphase
resampler, the word-time DTW path and the median filter.

Counterpart of ``audio_rag_tpu/native/__init__.py``, built from the port's
own copy of the source: ``g++ -O3 -fPIC -shared -std=c++17`` at first use
into ``build/native/``, under a name that hashes the flags and the source
(an edited source builds anew). The build holds an ``fcntl`` lock and
compiles to a temporary name that ``os.replace`` moves into place, so
processes that start together build it once. Where it cannot be built (no
``g++``) every entry point returns None, once with a warning, and the
callers take their numpy versions, which give the same numbers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["BUILD_DIR", "SOURCE", "lib_path", "get_lib", "native_available",
           "wav_decode", "resample", "dtw_path", "median_filter"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "audio_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_FP = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "arag_wav_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_FP),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]),
    "arag_resample": (ctypes.c_int, [
        _FP, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_FP), ctypes.POINTER(ctypes.c_int64)]),
    "arag_dtw_path": (ctypes.c_int64, [
        _FP, ctypes.c_int64, ctypes.c_int64, _I32P, _I32P]),
    "arag_median_filter": (ctypes.c_int, [
        _FP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _FP]),
    "arag_free": (None, [ctypes.c_void_p]),
}


def lib_path() -> Path:
    """The library's path: ``build/native/`` and a hash of the flags and
    the source."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libaudio_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile into ``out`` unless another process already has; raises
    with the compiler's messages when the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(proc.stderr[-2000:])
        os.replace(tmp, out)


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None (with one warning)
    where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = lib_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            log.warning("native audio runtime unavailable (%s); the numpy "
                        "versions run instead", exc)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _take(lib: ctypes.CDLL, out, n: int) -> np.ndarray:
    """Copy a malloc'd float32 result out and free it."""
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.arag_free(out)


def wav_decode(data: bytes) -> tuple[np.ndarray, int] | None:
    """RIFF/WAVE bytes → (mono float32, sample rate); None where the
    library is missing or refuses the input (PCM 8/16/24/32-bit and
    32-bit float are decoded; channels are averaged)."""
    lib = get_lib()
    if lib is None:
        return None
    out = _FP()
    n, sr = ctypes.c_int64(), ctypes.c_int32()
    rc = lib.arag_wav_decode(data, len(data), ctypes.byref(out),
                             ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    return _take(lib, out, n.value), int(sr.value)


def resample(audio: np.ndarray, sr_in: int,
             sr_out: int) -> np.ndarray | None:
    """Kaiser-sinc polyphase resample of a 1-D signal; None where the
    library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(audio, np.float32)
    out = _FP()
    n = ctypes.c_int64()
    rc = lib.arag_resample(x.ctypes.data_as(_FP), x.size, sr_in, sr_out,
                           ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        return None
    return _take(lib, out, n.value)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """The DTW path through a (N, M) cost matrix, summed in float64 →
    ascending (token_idx, frame_idx); None where the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(cost, np.float32)
    n, m = c.shape
    ti = np.empty(n + m, np.int32)
    fi = np.empty(n + m, np.int32)
    k = lib.arag_dtw_path(c.ctypes.data_as(_FP), n, m,
                          ti.ctypes.data_as(_I32P), fi.ctypes.data_as(_I32P))
    if k < 0:
        return None
    return ti[:k], fi[:k]


def median_filter(x: np.ndarray, width: int) -> np.ndarray | None:
    """Edge-padded median of an odd ``width`` along the last axis of a
    (N, M) float32 matrix; None where the library is missing or refuses
    the width."""
    lib = get_lib()
    if lib is None or x.ndim != 2:
        return None
    c = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(c)
    rc = lib.arag_median_filter(c.ctypes.data_as(_FP), c.shape[0],
                                c.shape[1], width, out.ctypes.data_as(_FP))
    return out if rc == 0 else None
