"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Three TPU kernels of ``audio_rag_tpu/ops/pallas_kernels.py`` lie on the
ported slice's path; each is a CUDA C++ kernel for ``sm_90a`` in
``audio_rag_tpu_torch/csrc/``:

* :func:`flash_attention` ← ``flash_attention`` (Whisper encoder
  self-attention, through ``models.layers._attend``);
* :func:`matmul_q8w` ← ``matmul_q8w`` (int8-weight decode matmuls, through
  ``models.layers.linear_q8``);
* :func:`decode_cross_attention_q8` ← ``decode_cross_attention_q8`` (int8
  cross-attention of the decode loop, through
  ``models.whisper._cross_with_kv``).

The sources are compiled with ``nvcc`` at first use into ``build/kernels/``
at the repository root (one shared library per source, named by a hash of
its sources and flags, so an edited source rebuilds) and loaded with
``ctypes``. Each wrapper checks device, dtype, shape and contiguity and
raises on input its kernel does not take; a CUDA tensor goes to the kernel
(or the wrapper raises), a CPU tensor goes to the plain PyTorch version of
the same function beside it. There is no fallback from a failed build or
launch. Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "reset_launches",
    "build",
    "flash_attention",
    "flash_attention_plain",
    "matmul_q8w",
    "matmul_q8w_plain",
    "decode_cross_attention_q8",
    "decode_cross_attention_q8_plain",
]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: kernel name → its CUDA source under csrc/
KERNELS: dict[str, str] = {
    "flash_attention": "flash_attention.cu",
    "matmul_q8w": "matmul_q8w.cu",
    "decode_cross_attention_q8": "decode_cross_q8.cu",
}

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_F32, _BF16 = 0, 1
_DTYPE_CODE = {torch.float32: _F32, torch.bfloat16: _BF16}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build -----------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    h.update((_CSRC / "common.cuh").read_bytes())
    h.update((_CSRC / KERNELS[name]).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns per kernel
    ``{"seconds", "log"}`` (``log`` holds ``-Xptxas -v`` output when
    ``verbose``); raises with nvcc's messages when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(_CSRC / KERNELS[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention": ("flash_attention_launch",
                        [_VP, _VP, _VP, _VP, ctypes.POINTER(ctypes.c_longlong),
                         _I, _I, _I, _I, _I, _F, _I, _VP]),
    "matmul_q8w": ("matmul_q8w_launch",
                   [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                    _VP]),
    "decode_cross_attention_q8": ("decode_cross_q8_launch",
                                  [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                   _I, _F, _I, _I, _VP]),
}


def _entry(name: str):
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return getattr(lib, _ARGTYPES[name][0])


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True → launch the kernel (all CUDA, one device); False → plain
    version (all CPU). Anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors must all be on one CUDA device or all "
                     f"on the CPU, got {sorted(str(t.device) for t in tensors)}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


# -- flash attention ---------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: int | None = None) -> torch.Tensor:
    """softmax(q kᵀ/√D) v in f32 (keys ≥ ``kv_len`` masked), cast to q's
    dtype: the function of the TPU kernel and of :func:`flash_attention`."""
    D = q.shape[-1]
    s = torch.matmul(q.float() * D ** -0.5, k.float().transpose(-1, -2))
    if kv_len is not None and kv_len < k.shape[2]:
        s[..., kv_len:] = float("-inf")
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: int | None = None) -> torch.Tensor:
    """Unmasked attention over (B, H, T, D) q/k/v (f32 or bf16, D ≤ 128,
    feature axis contiguous; other axes may be strided, e.g. a transposed
    (B, T, H, D) projection). Keys at index ≥ ``kv_len`` are masked.
    Returns (B, H, Tq, D) in q's dtype (a view of a (B, Tq, H, D) buffer on
    CUDA, so the caller's merge of heads is free). On CUDA, bf16 with D a
    multiple of 16 and strides of whole 16-byte units runs on the tensor
    cores, the probabilities rounded to bf16 before P·V; everything else
    computes in f32 on the CUDA cores."""
    name = "flash_attention"
    _check(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape, name,
           f"need (B, H, T, D) q/k/v, got {tuple(q.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check(k.shape[0] == B and k.shape[1] == H and k.shape[3] == D, name,
           "q and k/v disagree on batch, heads or features")
    kv_len = Tk if kv_len is None else int(kv_len)
    _check(1 <= kv_len <= Tk, name, f"kv_len {kv_len} outside [1, {Tk}]")
    if not _route(name, q, k, v):
        return flash_attention_plain(q, k, v, kv_len)
    _check(q.dtype in _DTYPE_CODE and k.dtype == q.dtype
           and v.dtype == q.dtype, name,
           f"need f32 or bf16 q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
           f"{v.dtype}")
    _check(1 <= D <= 128, name, f"head dim {D} > 128")
    _check(all(t.stride(3) == 1 for t in (q, k, v)), name,
           "feature axis must be contiguous")
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    ov = o.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, ov) for s in (t.stride(0), t.stride(1),
                                           t.stride(2))])
    rc = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      strides, B, H, Tq, D, kv_len, D ** -0.5,
                      _DTYPE_CODE[q.dtype], _stream(q))
    _launched(name, rc)
    return ov


# -- int8-weight matmul --------------------------------------------------------

# csrc/matmul_q8w.cu: columns and x rows per block, most din rows per block
_Q8W_COLS, _Q8W_ROWS, _Q8W_KMAX = 256, 16, 1280
_Q8W_TARGET_BLOCKS = 2 * 132  # two blocks per H100 SM
_Q8W_MIN_ROWS = 64  # fewest din rows worth a block of its own


def matmul_q8w_plain(x: torch.Tensor, w8: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """bf16(x) · W8 in f32, then × s: the function of the TPU kernel."""
    return torch.matmul(x.bfloat16().float(), w8.float()) * s


def _q8w_splits(B: int, din: int, dout: int) -> tuple[int, int]:
    """(splits, k_per_split) of din: enough blocks to fill the card, each
    slice within the kernel's shared-memory x buffer."""
    strips = -(-dout // _Q8W_COLS) * -(-B // _Q8W_ROWS)
    want = min(-(-_Q8W_TARGET_BLOCKS // strips), din // _Q8W_MIN_ROWS)
    splits = max(-(-din // _Q8W_KMAX), want, 1)
    k_per = -(-din // splits)
    return -(-din // k_per), k_per


def matmul_q8w(x: torch.Tensor, w8: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """x (B, din) f32/bf16 · int8 W (din, dout) with per-column f32 scales
    s (dout,) → (B, dout) f32, x rounded to bf16 and summed in f32."""
    name = "matmul_q8w"
    _check(x.dim() == 2 and w8.dim() == 2 and s.dim() == 1, name,
           f"need x (B, din), w8 (din, dout), s (dout,), got "
           f"{tuple(x.shape)}, {tuple(w8.shape)}, {tuple(s.shape)}")
    B, din = x.shape
    _check(w8.shape[0] == din and s.shape[0] == w8.shape[1], name,
           f"shape mismatch {tuple(x.shape)} @ {tuple(w8.shape)}, "
           f"s {tuple(s.shape)}")
    _check(w8.dtype == torch.int8 and s.dtype == torch.float32, name,
           f"need int8 w8 and f32 s, got {w8.dtype}, {s.dtype}")
    if not _route(name, x, w8, s):
        return matmul_q8w_plain(x, w8, s)
    dout = w8.shape[1]
    _check(x.dtype in _DTYPE_CODE, name, f"need f32 or bf16 x, got {x.dtype}")
    _check(B >= 1 and x.is_contiguous() and w8.is_contiguous()
           and s.is_contiguous(), name, "x, w8 and s must be contiguous")
    out = torch.empty((B, dout), dtype=torch.float32, device=x.device)
    splits, k_per = _q8w_splits(B, din, dout)
    scratch = (torch.empty((splits, B, dout), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    vec = dout % 4 == 0 and w8.data_ptr() % 4 == 0 and s.data_ptr() % 16 == 0
    rc = _entry(name)(x.data_ptr(), w8.data_ptr(), s.data_ptr(),
                      out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      B, din, dout, splits, k_per, int(vec),
                      _DTYPE_CODE[x.dtype], _stream(x))
    _launched(name, rc)
    return out


# -- int8 decode cross-attention -------------------------------------------------

_CROSS_SMEM_MAX = 227 * 1024  # H100 per-block shared memory


def decode_cross_attention_q8_plain(q, k8, v8, ks, vs) -> torch.Tensor:
    """Dequantized f32 attention on the transposed (B, H, hd, Ta) layout:
    the function of the TPU kernel (and of the JAX package's kernel test
    reference)."""
    scale = q.shape[-1] ** -0.5
    k = k8.float() * ks
    v = v8.float() * vs
    p = torch.softmax(torch.matmul(q.float() * scale, k), dim=-1)
    return torch.matmul(p, v.transpose(-1, -2))


def decode_cross_attention_q8(q: torch.Tensor, k8: torch.Tensor,
                              v8: torch.Tensor, ks: torch.Tensor,
                              vs: torch.Tensor) -> torch.Tensor:
    """softmax(q·K/√hd)·V over int8 K/V: q (B, H, M, hd) f32/bf16 with
    M ≤ 8; k8, v8 (B, H, hd, Ta) int8; ks, vs (B, H, 1, 1) f32 →
    (B, H, M, hd) f32."""
    name = "decode_cross_attention_q8"
    _check(q.dim() == 4 and k8.dim() == 4 and v8.shape == k8.shape, name,
           f"need q (B, H, M, hd), k8/v8 (B, H, hd, Ta), got "
           f"{tuple(q.shape)}, {tuple(k8.shape)}, {tuple(v8.shape)}")
    B, H, M, hd = q.shape
    Ta = k8.shape[3]
    _check(tuple(k8.shape[:3]) == (B, H, hd), name,
           f"k8 {tuple(k8.shape)} does not match q {tuple(q.shape)}")
    _check(tuple(ks.shape) == (B, H, 1, 1) and tuple(vs.shape) == (B, H, 1, 1),
           name, f"need (B, H, 1, 1) scales, got {tuple(ks.shape)}, "
           f"{tuple(vs.shape)}")
    _check(k8.dtype == torch.int8 and v8.dtype == torch.int8
           and ks.dtype == torch.float32 and vs.dtype == torch.float32, name,
           "need int8 k8/v8 and f32 scales")
    if not _route(name, q, k8, v8, ks, vs):
        return decode_cross_attention_q8_plain(q, k8, v8, ks, vs)
    _check(q.dtype in _DTYPE_CODE, name, f"need f32 or bf16 q, got {q.dtype}")
    _check(1 <= M <= 8, name, f"M = {M} queries per row; the kernel takes ≤ 8")
    _check(4 * M * (Ta + hd) <= _CROSS_SMEM_MAX, name,
           f"M·(Ta + hd) = {M * (Ta + hd)} floats exceed shared memory")
    _check(all(t.is_contiguous() for t in (q, k8, v8, ks, vs)), name,
           "q, k8, v8, ks and vs must be contiguous")
    out = torch.empty((B, H, M, hd), dtype=torch.float32, device=q.device)
    vec4 = (Ta % 4 == 0 and k8.data_ptr() % 4 == 0
            and v8.data_ptr() % 4 == 0)
    rc = _entry(name)(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                      ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
                      B * H, M, hd, Ta, hd ** -0.5, int(vec4),
                      _DTYPE_CODE[q.dtype], _stream(q))
    _launched(name, rc)
    return out
