"""The port's hand-written Hopper kernels, their wrappers and plain versions.

The seven TPU kernels of ``audio_rag_tpu/ops/pallas_kernels.py`` lie on
the ported paths; each is a CUDA C++ kernel for ``sm_90a`` in
``audio_rag_tpu_torch/csrc/`` (:data:`KERNELS` names its source and the
TPU kernel it replaces):

* :func:`flash_attention` ← ``flash_attention`` (Whisper encoder
  self-attention, through ``models.layers._attend``);
* :func:`matmul_q8w` ← ``matmul_q8w`` and :func:`matmul_q4w` ←
  ``matmul_q4w`` (int8- and int4-weight decode matmuls, through
  ``models.layers.linear_q8``);
* :func:`decode_cross_attention_q8` ← ``decode_cross_attention_q8`` and
  :func:`decode_cross_attention_q4` ← ``decode_cross_attention_q4`` (int8
  and int4 cross-attention of the decode loop, through
  ``models.whisper._cross_with_kv``);
* :func:`decode_self_attention_q8` ← ``decode_self_attention_q8`` (the
  greedy loop's self-attention over an int8 self cache, through
  ``models.whisper.decoder_step``);
* :func:`beam_reorder_kv` ← ``beam_reorder_kv`` (beam search's per-step
  reorder of the self caches, through ``models.whisper.beam_step`` with
  ``reorder="kernel"``).

The sources are compiled with ``nvcc`` at first use into ``build/kernels/``
at the repository root (one shared library per source, named by a hash of
its sources and flags, so an edited source rebuilds) and loaded with
``ctypes``. Each wrapper checks device, dtype, shape and contiguity and
raises on input its kernel does not take; a CUDA tensor goes to the kernel
(or the wrapper raises), a CPU tensor goes to the plain PyTorch version of
the same function beside it. There is no fallback from a failed build or
launch. Each launch adds one to :data:`LAUNCHES`.

Gradients: a kernel writes a fresh tensor that autograd cannot see
through, so :func:`flash_attention` goes through :class:`FlashAttentionFn`
whenever a gradient is needed (the kernel forward, the attention gradient
in f32 torch ops backward), and every other wrapper raises when grad mode
is on and an input requires grad: nothing is silently detached. None of
the TPU kernels had a reverse rule; training on the TPU never reached them.

Kernels launch from more than one thread (the streaming mux's worker, the
caller's, a query coalescer's): :func:`build`, :func:`load` and the first
use of a kernel hold the lock of the library file they make or open, so
each library is built and loaded once per process however many threads
reach it together (libraries of other kernels or flags still build side
by side), and the counters are added to under a lock of their own.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from audio_rag_tpu_torch.device import full_f32_matmul

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "FLASH_VARIANTS",
    "reset_launches",
    "build",
    "load",
    "int4_nibbles",
    "dequant_q4w",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_backward",
    "FlashAttentionFn",
    "matmul_q8w",
    "matmul_q8w_plain",
    "matmul_q4w",
    "matmul_q4w_plain",
    "decode_cross_attention_q8",
    "decode_cross_attention_q8_plain",
    "decode_cross_attention_q4",
    "decode_cross_attention_q4_plain",
    "decode_self_attention_q8",
    "decode_self_attention_q8_plain",
    "beam_reorder_kv",
    "beam_reorder_kv_plain",
]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


class Kernel(NamedTuple):
    source: str    #: CUDA source under csrc/
    replaces: str  #: the TPU kernel's wrapper, file:line


_PK = "audio_rag_tpu/ops/pallas_kernels.py"

#: kernel name → its source and the TPU kernel it replaces
KERNELS: dict[str, Kernel] = {
    "flash_attention": Kernel("flash_attention.cu", f"{_PK}:688"),
    "matmul_q8w": Kernel("matmul_q8w.cu", f"{_PK}:368"),
    "decode_cross_attention_q8": Kernel("decode_cross_q8.cu", f"{_PK}:92"),
    "decode_cross_attention_q4": Kernel("decode_cross_q4.cu", f"{_PK}:178"),
    "matmul_q4w": Kernel("matmul_q4w.cu", f"{_PK}:481"),
    "decode_self_attention_q8": Kernel("decode_self_q8.cu", f"{_PK}:282"),
    "beam_reorder_kv": Kernel("beam_reorder.cu", f"{_PK}:572"),
}

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

#: ``flash_attention`` launches by the kernel its C entry ran: "wgmma"
#: (bf16, D = 64, q/k/v a TMA map can describe), "mma" (other bf16 with D
#: a multiple of 16 and 16-byte strides), "cuda_cores" (the rest)
FLASH_VARIANTS: dict[str, int] = {"cuda_cores": 0, "mma": 0, "wgmma": 0}
_FLASH_VARIANT_NAMES = tuple(FLASH_VARIANTS)  # index = the entry's code

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_F32, _BF16 = 0, 1
_DTYPE_CODE = {torch.float32: _F32, torch.bfloat16: _BF16}

_libs: dict[str, ctypes.CDLL] = {}
_lib_files: dict[str, Path] = {}  # the file each entry of _libs came from
#: one lock per library file, held while it is built or loaded (re-entrant:
#: load builds)
_FILE_LOCKS: dict[Path, threading.RLock] = {}
_FILE_LOCKS_GUARD = threading.Lock()
#: held while a counter is added to or reset
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, FLASH_VARIANTS):
            for name in counts:
                counts[name] = 0


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


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The kernel's shared library, named by a hash of the flags and
    ``defines``, every header under csrc/ (a source may include any of
    them) and its source."""
    h = hashlib.sha256(" ".join((*_NVCC_FLAGS, *defines)).encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update((_CSRC / KERNELS[name].source).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False,
          defines: tuple[str, ...] = ()) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together; ``defines``
    ("NAME=value") are passed as ``-D`` and select a source's compile-time
    variants (the port runs the defaults). Returns per kernel
    ``{"seconds", "log"}`` (``log`` holds ``-Xptxas -v`` output when
    ``verbose``); raises with nvcc's messages when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    outs = {name: _lib_path(name, defines) for name in names}
    with contextlib.ExitStack() as held:
        for path in sorted(set(outs.values())):  # one order: no deadlock
            held.enter_context(_file_lock(path))
        return _build(outs, verbose, defines)


def _file_lock(path: Path) -> threading.RLock:
    with _FILE_LOCKS_GUARD:
        return _FILE_LOCKS.setdefault(path, threading.RLock())


def _build(outs: dict[str, Path], verbose: bool,
           defines: tuple[str, ...]) -> dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in outs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, *(f"-D{d}" for d in defines),
               *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(_CSRC / KERNELS[name].source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in outs}
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
                         _I, _I, _I, _I, _I, _F, _I, _VP,
                         ctypes.POINTER(ctypes.c_int)]),
    "matmul_q8w": ("matmul_q8w_launch",
                   [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _VP]),
    "decode_cross_attention_q8": ("decode_cross_q8_launch",
                                  [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _I, _VP]),
    "decode_cross_attention_q4": ("decode_cross_q4_launch",
                                  [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _I, _VP]),
    "matmul_q4w": ("matmul_q4w_launch",
                   [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _VP]),
    "decode_self_attention_q8": ("decode_self_q8_launch",
                                 [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                  _I, _F, _I, _I, _I, _I, _I, _I, _I,
                                  _VP]),
    "beam_reorder_kv": ("beam_reorder_launch",
                        [_VP, _VP, _VP, _VP, _VP, _I, _I, ctypes.c_longlong,
                         _VP]),
}


def load(name: str, defines: tuple[str, ...] = ()) -> None:
    """Make the kernel's wrapper call the library built with ``defines``
    (building it if needed); ``load(name)`` goes back to the defaults.
    A library already in use is not opened again."""
    path = _lib_path(name, defines)
    with _file_lock(path):
        if _lib_files.get(name) == path:
            return
        if not path.exists():
            build([name], defines=defines)
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
        _lib_files[name] = path


def _entry(name: str):
    lib = _libs.get(name)
    if lib is None:
        load(name)
        lib = _libs[name]
    return getattr(lib, _ARGTYPES[name][0])


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True → launch the kernel (all CUDA, one device); False → plain
    version (all CPU). Anything else raises, and so does a call that
    autograd would have to differentiate: grad mode on and an input that
    requires grad (the kernel's output would carry no gradient)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            "backward; call it under torch.no_grad() or "
            "torch.inference_mode(), or on tensors that do not require grad")
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
    with _COUNT_LOCK:
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
    CUDA, so the caller's merge of heads is free). On CUDA, bf16 runs on
    the tensor cores, the probabilities rounded to bf16 before P·V: D = 64
    through warpgroup MMAs on TMA-fed tiles wherever a tensor map can
    describe q, k and v (16-byte aligned, positive strides of whole 16-byte
    units), other D a multiple of 16 with 16-byte strides through
    ``mma.sync``; everything else computes in f32 on the CUDA cores.
    :data:`FLASH_VARIANTS` counts which kernel each launch ran. With grad
    mode on and an input that requires grad the call goes through
    :class:`FlashAttentionFn`, whose output carries the gradient."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, kv_len)
    return _flash_forward(q, k, v, kv_len)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: int) -> torch.Tensor:
    """:func:`flash_attention` on checked shapes: the kernel on CUDA, the
    plain version on the CPU."""
    name = "flash_attention"
    B, H, Tq, D = q.shape
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
    variant = ctypes.c_int(-1)
    rc = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      strides, B, H, Tq, D, kv_len, D ** -0.5,
                      _DTYPE_CODE[q.dtype], _stream(q), ctypes.byref(variant))
    _launched(name, rc)
    with _COUNT_LOCK:
        FLASH_VARIANTS[_FLASH_VARIANT_NAMES[variant.value]] += 1
    return ov


#: f32 bytes of one chunk's score tensor in :func:`flash_attention_backward`
#: (four such tensors live at once: scores, probabilities, dP, dS)
FLASH_BWD_CHUNK_BYTES = 1 << 27


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, kv_len: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain` at (q, k, v), whose
    output was ``o``, for the output gradient ``do``: in f32 torch ops
    (full f32 products), cast to each input's dtype. With S = q·kᵀ/√D
    (keys ≥ ``kv_len`` masked) and P = softmax(S): dV = Pᵀ·dO,
    dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = dS·K/√D, dK = dSᵀ·Q/√D.
    P is recomputed over chunks of query rows of at most
    :data:`FLASH_BWD_CHUNK_BYTES` of scores each, so large-v3's
    (B, 20, 1500, 1500) scores are never held whole; dK and dV are summed
    over the chunks in order (the same bits from call to call).

    The TPU kernel has no counterpart: it has no reverse-mode rule, and
    the JAX package trains through XLA's autodiff of its einsum attention
    (``audio_rag_tpu/models/layers.py::_attend``), whose math this is."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    kv_len = Tk if kv_len is None else int(kv_len)
    scale = D ** -0.5
    rows = max(1, FLASH_BWD_CHUNK_BYTES // (4 * B * H * Tk))
    with full_f32_matmul():
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        delta = (dof * o.float()).sum(-1, keepdim=True)  # rowsum(dO∘O)
        dq = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
        dk = torch.zeros((B, H, Tk, D), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for r0 in range(0, Tq, rows):
            r1 = min(Tq, r0 + rows)
            qs = qf[:, :, r0:r1] * scale
            s = torch.matmul(qs, kf.transpose(-1, -2))
            if kv_len < Tk:
                s[..., kv_len:] = float("-inf")
            p = torch.softmax(s, dim=-1)
            del s
            dor = dof[:, :, r0:r1]
            dv += torch.matmul(p.transpose(-1, -2), dor)
            ds = p * (torch.matmul(dor, vf.transpose(-1, -2))
                      - delta[:, :, r0:r1])
            del p
            dq[:, :, r0:r1] = torch.matmul(ds, kf) * scale
            dk += torch.matmul(ds.transpose(-1, -2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient, the counterpart of XLA's
    autodiff of the JAX package's einsum attention. Forward: the kernel on
    CUDA (counted in :data:`LAUNCHES` as any launch), the plain version on
    the CPU; it saves q, k, v and the output (the kernel emits no row
    statistics: the backward recomputes them). Backward:
    :func:`flash_attention_backward`, torch ops only, as the TPU kernel had
    no backward of its own."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len: int):
        o = _flash_forward(q, k, v, kv_len)
        ctx.save_for_backward(q, k, v, o)
        ctx.kv_len = kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, ctx.kv_len)
        return dq, dk, dv, None


# -- weight-quantized matmuls: the launch plan -----------------------------------

# csrc/wq_matmul.cuh: din rows per ring stage, x rows per block, output
# columns per warp, x-row tiles (n8) the kernels are built for, bytes of a
# bf16 x row in a ring slot, warps per block, most ring slots, most din
# slices (one thread-block cluster)
WQ_STAGE_K, WQ_ROWS, WQ_WARP_COLS = 64, 128, 32
WQ_NT = (1, 2, 4, 8, 10, 16)
_WQ_X_STRIDE = 2 * WQ_STAGE_K + 16
WQ_WARPS = 8
WQ_STAGES_MAX = 4
WQ_SPLITS_MAX = 8
WQ_SMEM_MAX = 226 * 1024  # H100's 227 KB a block, less the static bytes
_WQ_SMEM_SM = 200 * 1024  # what the rings of an SM's blocks may share
_WQ_PART_MAX = 96 * 1024  # a block's finished sums, read by its cluster
WQ_SMS = 132  # H100 SXM streaming multiprocessors
_WQ_BLOCKS = 200  # blocks a split call aims at
_WQ_SLICE_STAGES = 6  # ring stages a din slice aims to stay within


class WqPlan(NamedTuple):
    """How one ``matmul_q8w`` / ``matmul_q4w`` call is cut into blocks: the
    grid is (column tiles of 32·wn, splits, row blocks of 128), each block
    wn × wk warps, the splits of a tile one cluster."""
    nt: int           #: n8 tiles of x rows per block (8·nt ≥ its rows)
    wn: int           #: warps along the columns, 32 columns each
    wk: int           #: warps along din, sharing a stage's 16-row chunks
    splits: int       #: din slices, reduced in the same launch
    k_per_split: int  #: din rows per slice, a multiple of WQ_STAGE_K
    stages: int       #: ring slots in shared memory
    group_mode: bool  #: int4: the group scale on each chunk's sums
    smem: int         #: dynamic shared memory per block, bytes
    col_tiles: int
    row_blocks: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.splits * self.row_blocks


def wq_slot_bytes(bits: int, wn: int, nt: int) -> int:
    """Bytes of one ring slot: a stage's weight tile (its rows padded
    against bank conflicts) and its x slice as bf16."""
    bn = WQ_WARP_COLS * wn
    w_rows, pad = (WQ_STAGE_K, 16) if bits == 8 else (WQ_STAGE_K // 2, 32)
    return w_rows * (bn + pad) + 8 * nt * _WQ_X_STRIDE


def wq_reduce_bytes(wn: int, wk: int, nt: int) -> int:
    """Shared memory the din warps hand their sums over in (the ring's)."""
    return (wk - 1) * wn * 32 * 8 * nt * 4


def wq_part_bytes(wn: int, nt: int) -> int:
    """A block's finished sums in shared memory, read by its cluster."""
    return 8 * nt * (WQ_WARP_COLS * wn + 4) * 4


def wq_plan(B: int, din: int, dout: int, bits: int = 8,
            group: int | None = None) -> WqPlan:
    """The launch plan of one weight-quantized matmul call (sizes from
    ``scripts/sweep_wq_plan.py`` on an H100, at Whisper large-v3's and
    llama-3.2-3b's decode shapes). Every x row of a row block sits in one
    block, so each weight byte is read once per call. A weight as wide as
    the logits head fills the card with 256-column tiles and is not split.
    A decode block's weight takes 64-column tiles (Whisper's 1280 columns),
    128 at 2048 columns or more (or more than 64 x rows) and 256 at 8192 or
    more (llama's fused gate/up), the block's other warps sharing din, and
    din is cut into up to 8 slices, one cluster a tile, for about 200
    blocks and at most 6 ring stages a slice. The ring is as deep as the
    blocks an SM holds at once leave room for."""
    rows = min(B, WQ_ROWS)
    nt = next(n for n in WQ_NT if 8 * n >= rows)
    group_mode = bits == 4 and group is not None and group % 16 == 0
    row_blocks = -(-B // WQ_ROWS)
    n_stages = -(-din // WQ_STAGE_K)
    if (dout >= 8192
            or -(-dout // (WQ_WARP_COLS * WQ_WARPS)) * row_blocks >= WQ_SMS):
        wn = WQ_WARPS
    else:
        wn = 4 if dout >= 2048 or nt >= 8 else 2
    while wn > 2 and wq_part_bytes(wn, nt) > _WQ_PART_MAX:
        wn //= 2
    wk = WQ_WARPS // wn
    col_tiles = -(-dout // (WQ_WARP_COLS * wn))
    tiles = col_tiles * row_blocks
    splits = 1
    if tiles < WQ_SMS:
        splits = min(WQ_SPLITS_MAX, n_stages,
                     max(-(-_WQ_BLOCKS // tiles),
                         -(-n_stages // _WQ_SLICE_STAGES)))
    k_stages = -(-n_stages // splits)
    splits = -(-n_stages // k_stages)
    slot = wq_slot_bytes(bits, wn, nt)
    per_sm = min(-(-tiles * splits // WQ_SMS),
                 4 if nt <= 2 else 2 if nt <= 8 else 1)
    stages = min(WQ_STAGES_MAX, k_stages + 1)
    while stages > 2 and stages * slot > _WQ_SMEM_SM // per_sm:
        stages -= 1
    smem = max(stages * slot, wq_reduce_bytes(wn, wk, nt),
               wq_part_bytes(wn, nt) if splits > 1 else 0)
    return WqPlan(nt, wn, wk, splits, k_stages * WQ_STAGE_K, stages,
                  group_mode, smem, col_tiles, row_blocks)


def wq_launch(name: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
              plan: WqPlan) -> torch.Tensor:
    """One launch of ``matmul_q8w``'s or ``matmul_q4w``'s kernel with the
    given plan, on inputs the wrapper has checked (the plan sweep of
    ``scripts/sweep_wq_plan.py`` passes its own plans)."""
    B, din = x.shape
    dout = w.shape[1]
    out = torch.empty((B, dout), dtype=torch.float32, device=x.device)
    quant = () if name == "matmul_q8w" else (din // s.shape[0],
                                             int(plan.group_mode))
    rc = _entry(name)(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                      out.data_ptr(), B, din, dout, *quant, plan.nt,
                      plan.wn, plan.wk, plan.splits, plan.k_per_split,
                      plan.stages, _DTYPE_CODE[x.dtype], _stream(x))
    _launched(name, rc)
    return out


# -- int8-weight matmul --------------------------------------------------------

def matmul_q8w_plain(x: torch.Tensor, w8: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """bf16(x) · W8 in f32, then × s: the function of the TPU kernel."""
    return torch.matmul(x.bfloat16().float(), w8.float()) * s


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
    return wq_launch(name, x, w8, s, wq_plan(B, din, dout, bits=8))


# -- decode cross-attention: the launch plan ----------------------------------------

# csrc/decode_cross.cuh: keys per chunk (a warp's unit), warps a block,
# most head dim, ring slots, the most dynamic shared memory beside the
# kernel's ~3.4 KB of static arrays
CROSS_KEYS, CROSS_WARPS, CROSS_HD_MAX, CROSS_STAGES = 32, 8, 128, 2
CROSS_SMEM_MAX = 223 * 1024


class CrossPlan(NamedTuple):
    """How one ``decode_cross_attention_q8`` / ``_q4`` call is cut: one
    block of eight warps per (b, h) streaming K, then V, in stages of 16
    byte rows (every key) through a ring of ``CROSS_STAGES`` slots; warp w
    takes the 32-key chunks w, w + 8, ... of each stage. The scores, then in
    place the probabilities, of every key stay in shared memory between the
    passes."""
    bulk: bool   #: each stage by one bulk copy (else by the threads)
    ldk: int     #: a stage's row stride in shared memory
    chunks: int  #: 32-key chunks over Ta
    groups: int  #: 4-key groups a query's row of scores holds
    smem: int    #: dynamic shared memory per block, bytes


def cross_plan(bits: int, hd: int, Ta: int, M: int,
               aligned: bool = True) -> CrossPlan:
    """The launch plan of one decode cross-attention call over int8
    (``bits`` 8, hd byte rows a (b, h)) or half-split int4 (hd/2 rows) K/V
    with ``Ta`` keys and ``M`` queries a row. Any 16 byte rows are 16·Ta
    contiguous bytes, a multiple of 16, so with 16-byte-aligned bases
    (``aligned``) and Ta % 4 == 0 (the rows are read as 4-byte words) each
    stage is one bulk copy; any other layout is copied by the threads into
    rows of a word-multiple stride. Raises ``ValueError`` for a head dim
    the m16 tiles do not cut evenly, or for two stages and M rows of Ta
    scores that outgrow shared memory."""
    rows = hd if bits == 8 else hd // 2
    if not (1 <= hd <= CROSS_HD_MAX and (bits == 8 or hd % 2 == 0)
            and rows in (16, 32, 64, 128)):
        raise ValueError(
            f"head dim {hd}: the kernel takes 16, 32, 64 or 128 byte rows "
            f"(hd {16 * 8 // bits}, {32 * 8 // bits}, ... up to "
            f"{CROSS_HD_MAX})")
    bulk = aligned and Ta % 4 == 0
    ldk = Ta if bulk else -(-Ta // 4) * 4
    chunks = -(-Ta // CROSS_KEYS)
    groups = -(-8 * chunks // 32) * 32
    slot = -(-(16 * ldk + 32) // 16) * 16
    # the ring also takes the warps' int64 P.V sums at the end
    reduce = CROSS_WARPS * rows // 16 * (2 if bits == 4 else 1) * 4 * 32 * 8
    smem = max(CROSS_STAGES * slot, reduce) + 16 * M * groups
    if smem > CROSS_SMEM_MAX:
        raise ValueError(f"Ta = {Ta} with M = {M}: two stages of 16 rows and "
                         f"{M} rows of scores need {smem} bytes of shared "
                         f"memory a block (most {CROSS_SMEM_MAX})")
    return CrossPlan(bulk, ldk, chunks, groups, smem)


def _cross_launch(name: str, q, k, v, ks, vs, bits: int) -> torch.Tensor:
    """One launch of a cross kernel on inputs its wrapper has checked
    (raises ``ValueError`` for a call :func:`cross_plan` refuses)."""
    B, H, M, hd = q.shape
    Ta = k.shape[3]
    try:
        plan = cross_plan(bits, hd, Ta, M, aligned=(
            k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0))
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    out = torch.empty((B, H, M, hd), dtype=torch.float32, device=q.device)
    rc = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
                      B * H, M, hd, Ta, hd ** -0.5, int(plan.bulk),
                      plan.ldk, plan.smem, _DTYPE_CODE[q.dtype], _stream(q))
    _launched(name, rc)
    return out


# -- int8 decode cross-attention -------------------------------------------------

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
    _check(all(t.is_contiguous() for t in (q, k8, v8, ks, vs)), name,
           "q, k8, v8, ks and vs must be contiguous")
    return _cross_launch(name, q, k8, v8, ks, vs, 8)


# -- int4 helpers ------------------------------------------------------------------

def int4_nibbles(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed low and high nibbles of int8 bytes as int32 in [-8, 7]: the
    TPU kernels' ``(b << 28) >> 28`` and ``b >> 4`` sign extension."""
    xi = x.to(torch.int32)
    return (xi << 28) >> 28, xi >> 4


def dequant_q4w(w4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(din/2, dout) row-pair-packed int4 weights (byte r: din row 2r in the
    low nibble, 2r + 1 in the high one) and (din/group, dout) f32 group
    scales → the (din, dout) f32 weight: each int4 value times its scale
    rounded to bf16, the product kept in f32 (the JAX package's
    ``models/layers._dequant_q4``)."""
    lo, hi = int4_nibbles(w4)
    din = 2 * w4.shape[0]
    q = torch.stack([lo, hi], dim=1).reshape(din, w4.shape[1])
    sb = s.bfloat16().float().repeat_interleave(din // s.shape[0], dim=0)
    return q.float() * sb


# -- int4-weight matmul ------------------------------------------------------------

def matmul_q4w_plain(x: torch.Tensor, w4: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """bf16(x) · dequant(w4, s) in f32: the function of the TPU kernel as
    the JAX package computes it off the TPU (``linear_q8``'s int4 path)."""
    return torch.matmul(x.bfloat16().float(), dequant_q4w(w4, s))


def matmul_q4w(x: torch.Tensor, w4: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """x (B, din) f32/bf16 · int4 W → (B, dout) f32. ``w4`` (din/2, dout)
    int8 holds din rows 2r and 2r + 1 in the low and high nibble of byte
    row r; ``s`` (din/group, dout) f32 holds one scale per group of din
    rows and column, rounded to bf16 before use. Any group that divides
    din; x rounded to bf16; each dequantized weight times x summed in f32."""
    name = "matmul_q4w"
    _check(x.dim() == 2 and w4.dim() == 2 and s.dim() == 2, name,
           f"need x (B, din), w4 (din/2, dout), s (din/group, dout), got "
           f"{tuple(x.shape)}, {tuple(w4.shape)}, {tuple(s.shape)}")
    B, din = x.shape
    dout = w4.shape[1]
    _check(2 * w4.shape[0] == din and s.shape[1] == dout
           and s.shape[0] >= 1 and din % s.shape[0] == 0, name,
           f"shape mismatch: x {tuple(x.shape)}, w4 {tuple(w4.shape)}, "
           f"s {tuple(s.shape)}")
    _check(w4.dtype == torch.int8 and s.dtype == torch.float32, name,
           f"need int8 w4 and f32 s, got {w4.dtype}, {s.dtype}")
    if not _route(name, x, w4, s):
        return matmul_q4w_plain(x, w4, s)
    _check(x.dtype in _DTYPE_CODE, name, f"need f32 or bf16 x, got {x.dtype}")
    _check(B >= 1 and x.is_contiguous() and w4.is_contiguous()
           and s.is_contiguous(), name, "x, w4 and s must be contiguous")
    return wq_launch(name, x, w4, s,
                     wq_plan(B, din, dout, bits=4, group=din // s.shape[0]))


# -- int4 decode cross-attention ---------------------------------------------------

def decode_cross_attention_q4_plain(q, k4, v4, ks, vs) -> torch.Tensor:
    """Unpacked f32 attention with the K channel scales and 1/√hd folded
    into q and the V channel scales applied to the output: the function
    of the TPU kernel."""
    hd = q.shape[-1]
    k = torch.cat(int4_nibbles(k4), dim=-2).float()  # (B, H, hd, Ta)
    v = torch.cat(int4_nibbles(v4), dim=-2).float()
    qf = q.float() * (hd ** -0.5 * ks)
    p = torch.softmax(torch.matmul(qf, k), dim=-1)
    return torch.matmul(p, v.transpose(-1, -2)) * vs


def decode_cross_attention_q4(q: torch.Tensor, k4: torch.Tensor,
                              v4: torch.Tensor, ks: torch.Tensor,
                              vs: torch.Tensor) -> torch.Tensor:
    """softmax(q·K/√hd)·V over int4 K/V: q (B, H, M, hd) f32/bf16 with
    M ≤ 8; k4, v4 (B, H, hd/2, Ta) int8, byte row r holding head dim r in
    its low nibble and r + hd/2 in its high one; ks, vs (B, H, 1, hd) f32
    per-channel scales → (B, H, M, hd) f32."""
    name = "decode_cross_attention_q4"
    _check(q.dim() == 4 and k4.dim() == 4 and v4.shape == k4.shape, name,
           f"need q (B, H, M, hd), k4/v4 (B, H, hd/2, Ta), got "
           f"{tuple(q.shape)}, {tuple(k4.shape)}, {tuple(v4.shape)}")
    B, H, M, hd = q.shape
    Ta = k4.shape[3]
    _check(hd % 2 == 0 and tuple(k4.shape[:3]) == (B, H, hd // 2), name,
           f"k4 {tuple(k4.shape)} does not match q {tuple(q.shape)}")
    _check(tuple(ks.shape) == (B, H, 1, hd)
           and tuple(vs.shape) == (B, H, 1, hd), name,
           f"need (B, H, 1, hd) scales, got {tuple(ks.shape)}, "
           f"{tuple(vs.shape)}")
    _check(k4.dtype == torch.int8 and v4.dtype == torch.int8
           and ks.dtype == torch.float32 and vs.dtype == torch.float32, name,
           "need int8 k4/v4 and f32 scales")
    if not _route(name, q, k4, v4, ks, vs):
        return decode_cross_attention_q4_plain(q, k4, v4, ks, vs)
    _check(q.dtype in _DTYPE_CODE, name, f"need f32 or bf16 q, got {q.dtype}")
    _check(1 <= M <= 8, name, f"M = {M} queries per row; the kernel takes ≤ 8")
    _check(all(t.is_contiguous() for t in (q, k4, v4, ks, vs)), name,
           "q, k4, v4, ks and vs must be contiguous")
    return _cross_launch(name, q, k4, v4, ks, vs, 4)


# -- int8 decode self-attention ----------------------------------------------------

SELF_LANES = 128  # floats per packed scale row

# csrc/decode_self_q8.cu: head-dim rows of a slice (one copy each where
# every slice is in flight), the head dims the kernel takes, bytes a ragged
# group reads past the slots, the most dynamic shared memory beside the
# kernel's < 1 KB of static arrays
SELF_SLICE_ROWS, SELF_HDS, SELF_SLACK = 16, (16, 32, 64, 128), 64
SELF_SMEM_MAX = 226 * 1024


class SelfPlan(NamedTuple):
    """How one ``decode_self_attention_q8`` call is cut: one block of eight
    warps per (b, h); K, then V, arrive in shared memory in stages of
    ``rows`` head-dim rows (every position), each stage its own copy and
    mbarrier. Where every 16-row slice fits (``slots`` = 2·``stages``, all
    port shapes) all are issued at the block's start, so the scores of a K
    slice run while the later ones land; longer caches stream stages of
    whole slices through two slots. The scores, then in place the pieces
    of p·vs, of every position stay in shared memory in rows of ``ldp``."""
    bulk: bool   #: each stage by one bulk copy (else by the threads)
    ldk: int     #: a cache row's stride in shared memory
    ldp: int     #: a score row's floats: ldk to a multiple of 4·256/hd
    rows: int    #: head-dim rows a stage holds, a multiple of 16
    stages: int  #: stages of K, and of V
    slots: int   #: stages held at once: 2·stages (all in flight) or 2
    smem: int    #: dynamic shared memory per block, bytes


def self_plan(hd: int, Cp: int, M: int, aligned: bool = True) -> SelfPlan:
    """The launch plan of one decode self-attention call over an int8 self
    cache of ``hd`` head dims and ``Cp`` positions, with ``M`` queries a
    row. Any 16 rows of a (b, h)'s K or V are 16·Cp contiguous bytes, so
    with 16-byte-aligned bases (``aligned``) and Cp % 16 == 0 each stage is
    one bulk copy; any other layout is copied by the threads into rows of a
    word-multiple stride. Every 16-row slice in flight at once where the
    slots fit beside the scores (and, for M > 4, the slices' partial
    scores), the scale and mask columns and q's pieces; else two slots of
    the most rows that fit, a multiple of 16 dividing hd. Raises
    ``ValueError`` for M outside 1–8, a head dim other than 16, 32, 64 or
    128, and a cache whose two slots of 16 rows, scores and columns
    outgrow shared memory."""
    if not 1 <= M <= 8:
        raise ValueError(f"M = {M} queries per row; the kernel takes 1 to 8")
    if hd not in SELF_HDS:
        raise ValueError(f"head dim {hd}: the kernel takes 16, 32, 64 or "
                         f"128")
    if Cp < 1:
        raise ValueError(f"need Cp ≥ 1, got {Cp}")
    bulk = aligned and Cp % 16 == 0
    ldk = Cp if bulk else -(-Cp // 4) * 4
    lanes = 4 * 256 // hd  # a P.V row's lanes read words ldp / lanes apart
    ldp = -(-ldk // lanes) * lanes
    fixed = SELF_SLACK + 8 * M * ldp + 12 * ldp + 3 * M * hd

    def smem(slots: int, rows: int) -> int:
        parts = (4 * hd // SELF_SLICE_ROWS * M * ldp
                 if slots == 2 * (hd // rows) and M > 4 else 0)
        return slots * rows * ldk + parts + fixed

    stages = hd // SELF_SLICE_ROWS
    if smem(2 * stages, SELF_SLICE_ROWS) <= SELF_SMEM_MAX:
        return SelfPlan(bulk, ldk, ldp, SELF_SLICE_ROWS, stages, 2 * stages,
                        smem(2 * stages, SELF_SLICE_ROWS))
    for rows in range(hd // 2, SELF_SLICE_ROWS - 1, -SELF_SLICE_ROWS):
        if hd % rows == 0 and smem(2, rows) <= SELF_SMEM_MAX:
            return SelfPlan(bulk, ldk, ldp, rows, hd // rows, 2,
                            smem(2, rows))
    raise ValueError(
        f"Cp = {Cp} with M = {M}, hd = {hd}: two slots of 16 rows, {M} "
        f"rows of scores, the scale and mask columns and q's pieces need "
        f"{smem(2, SELF_SLICE_ROWS)} bytes of shared memory a block (most "
        f"{SELF_SMEM_MAX})")


def decode_self_attention_q8_plain(q, k8, v8, sc) -> torch.Tensor:
    """Scores scaled per position and masked, softmax, probabilities times
    the V scales, then P·V, all in f32: the function of the TPU kernel (and
    of the JAX package's off-TPU einsum)."""
    H, hd = q.shape[1], q.shape[-1]
    ks = sc[:, :, :H].transpose(1, 2)[:, :, None, :]  # (B, H, 1, Cp)
    vs = sc[:, :, H:2 * H].transpose(1, 2)[:, :, None, :]
    mask = sc[:, None, None, :, 2 * H]  # (B, 1, 1, Cp)
    s = torch.matmul(q.float() * hd ** -0.5, k8.float()) * ks + mask
    p = torch.softmax(s, dim=-1) * vs
    return torch.matmul(p, v8.float().transpose(-1, -2))


def decode_self_attention_q8(q: torch.Tensor, k8: torch.Tensor,
                             v8: torch.Tensor, sc: torch.Tensor
                             ) -> torch.Tensor:
    """softmax(q·K/√hd + mask)·V over an int8 self cache with per-position
    scales: q (B, H, M, hd) f32/bf16 with M ≤ 8; k8, v8 (B, H, hd, Cp)
    int8; sc (B, Cp, 128) f32 holding, for position t, the K scales of the
    H heads in lanes [0, H), the V scales in [H, 2H) and the additive mask
    (0 valid, -1e30 not) in lane 2H → (B, H, M, hd) f32. On CUDA the call
    takes what :func:`self_plan` takes and raises ``ValueError`` otherwise."""
    name = "decode_self_attention_q8"
    _check(q.dim() == 4 and k8.dim() == 4 and v8.shape == k8.shape
           and sc.dim() == 3, name,
           f"need q (B, H, M, hd), k8/v8 (B, H, hd, Cp), sc (B, Cp, 128), "
           f"got {tuple(q.shape)}, {tuple(k8.shape)}, {tuple(v8.shape)}, "
           f"{tuple(sc.shape)}")
    B, H, M, hd = q.shape
    Cp = k8.shape[3]
    _check(tuple(k8.shape[:3]) == (B, H, hd), name,
           f"k8 {tuple(k8.shape)} does not match q {tuple(q.shape)}")
    _check(tuple(sc.shape) == (B, Cp, SELF_LANES) and 2 * H < SELF_LANES,
           name, f"need packed scales (B, Cp, {SELF_LANES}) with 2H < "
           f"{SELF_LANES}, got {tuple(sc.shape)} for H = {H}")
    _check(k8.dtype == torch.int8 and v8.dtype == torch.int8
           and sc.dtype == torch.float32, name,
           "need int8 k8/v8 and f32 packed scales")
    if not _route(name, q, k8, v8, sc):
        return decode_self_attention_q8_plain(q, k8, v8, sc)
    _check(q.dtype in _DTYPE_CODE, name, f"need f32 or bf16 q, got {q.dtype}")
    _check(1 <= M <= 8, name, f"M = {M} queries per row; the kernel takes ≤ 8")
    _check(B <= 65535, name, f"B = {B} rows of blocks; the grid takes ≤ 65535")
    _check(all(t.is_contiguous() for t in (q, k8, v8, sc)), name,
           "q, k8, v8 and sc must be contiguous")
    try:
        plan = self_plan(hd, Cp, M, aligned=(
            k8.data_ptr() % 16 == 0 and v8.data_ptr() % 16 == 0))
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    out = torch.empty((B, H, M, hd), dtype=torch.float32, device=q.device)
    rc = _entry(name)(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                      sc.data_ptr(), out.data_ptr(), B, H, M, hd, Cp,
                      hd ** -0.5, int(plan.bulk), plan.ldk, plan.ldp,
                      plan.rows, plan.slots, plan.smem,
                      _DTYPE_CODE[q.dtype], _stream(q))
    _launched(name, rc)
    return out


# -- beam-search reorder of the self caches -----------------------------------

def beam_reorder_kv_plain(sk: torch.Tensor, sv: torch.Tensor,
                          idx: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sk[:, idx]``, ``sv[:, idx]``: the function of the TPU kernel."""
    return sk[:, idx], sv[:, idx]


def beam_reorder_kv(sk: torch.Tensor, sv: torch.Tensor, idx: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """out[:, n] = in[:, idx[n]] on both (L, N, H, C, hd) self caches, N =
    B·K beam rows; ``idx`` (N,) int64, repeats allowed. Returns new
    tensors (the inputs are left as they are). The CUDA kernel copies bits
    and takes any shape of a contiguous f32 or bf16 cache; an index
    outside [0, N) raises on CPU tensors and is not checked on CUDA ones
    (that would cost a host sync): such a row is left unwritten."""
    name = "beam_reorder_kv"
    _check(sk.dim() == 5 and sv.shape == sk.shape and idx.dim() == 1
           and idx.shape[0] == sk.shape[1], name,
           f"need sk/sv (L, N, H, C, hd) and idx (N,), got {tuple(sk.shape)}, "
           f"{tuple(sv.shape)}, {tuple(idx.shape)}")
    _check(idx.dtype == torch.int64, name, f"need int64 idx, got {idx.dtype}")
    _check(sk.dtype in _DTYPE_CODE and sv.dtype == sk.dtype, name,
           f"need f32 or bf16 caches of one dtype, got {sk.dtype}, "
           f"{sv.dtype}")
    L, N = sk.shape[:2]
    if not _route(name, sk, sv, idx):
        _check(int(idx.min()) >= 0 and int(idx.max()) < N, name,
               f"index outside [0, {N})")
        return beam_reorder_kv_plain(sk, sv, idx)
    _check(all(t.is_contiguous() for t in (sk, sv, idx)), name,
           "sk, sv and idx must be contiguous")
    ko, vo = torch.empty_like(sk), torch.empty_like(sv)
    slab = sk[0, 0].numel() * sk.element_size()
    rc = _entry(name)(sk.data_ptr(), sv.data_ptr(), idx.data_ptr(),
                      ko.data_ptr(), vo.data_ptr(), L, N, slab, _stream(sk))
    _launched(name, rc)
    return ko, vo
