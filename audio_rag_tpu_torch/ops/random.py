"""JAX's default PRNG (threefry2x32, partitionable bits) on torch tensors.

The JAX backend's temperature-fallback ladder samples its retries with
``jax.random.PRNGKey(int(temperature * 100))``, ``split`` and
``categorical``; this module draws the same numbers on any device, so the
port's sampled windows are the JAX package's:

* :func:`threefry2x32` — the Threefry-2x32 hash (20 rounds, key schedule
  with the 0x1BD11BDA parity word), on Python ints, numpy uint32 arrays,
  or int64 tensors that hold uint32 values (masked after every add and
  shift, so that it runs on CUDA);
* :func:`PRNGKey` and :func:`split` — keys are (hi, lo) pairs of Python
  ints; ``split(key, n)``'s i-th key is the hash of the counter (0, i),
  as ``jax_threefry_partitionable`` computes it;
* :func:`random_bits` — 32 bits per element: the hash of the element's
  flat index (hi, lo), its two words xor-ed;
* :func:`uniform` — JAX's mantissa trick: the top 23 bits under the
  exponent of 1.0, minus 1, scaled into [minval, maxval);
* :func:`gumbel` and :func:`categorical` — ``-log(-log(u))`` with u in
  [tiny, 1), in f64 rounded to f32, and ``argmax(logits + gumbel)``
  along the last axis (the first index among equal maxima, as
  ``jnp.argmax``).

The bits are exact; the Gumbel noise differs from JAX's only where
``log`` does (within one ulp of max(|g|, 1) against XLA's CPU ``log``).
On the host the draws run in numpy (single-threaded uint32 and f64
arithmetic), which keeps a decode step's draw off torch's thread pool.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "threefry2x32", "random_bits", "uniform",
           "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under key (k1, k2):
    Python ints, numpy uint32 arrays or int64 tensors of uint32 values,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int) -> Key:  # noqa: N802 (JAX's name)
    """The key of an integer seed: its high and low 32-bit words (a
    negative seed is an int32, as JAX takes it: high word 0)."""
    seed = int(seed)
    if seed < 0:
        return 0, seed & _M32
    return (seed >> 32) & _M32, seed & _M32


def split(key: Key, num: int = 2) -> list[Key]:
    """``num`` new keys; key i is the hash of the counter (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits(key: Key, shape, cpu: bool):
    """The bits of :func:`random_bits`: a numpy uint32 array on the host,
    an int64 tensor on the card."""
    n = math.prod(shape)
    if cpu:
        idx = np.arange(n, dtype=np.uint64)
        b1, b2 = threefry2x32(key[0], key[1], (idx >> 32).astype(np.uint32),
                              (idx & _M32).astype(np.uint32))
        return (b1 ^ b2).reshape(shape)
    idx = torch.arange(n, dtype=torch.int64, device="cuda")
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def _on_cpu(device) -> bool:
    return torch.device(device or "cpu").type == "cpu"


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """32 random bits per element of ``shape`` as an int64 tensor: the
    hash of each element's flat index, the two output words xor-ed."""
    if _on_cpu(device):
        return torch.from_numpy(_bits(key, shape, True).astype(np.int64))
    return _bits(key, shape, False).to(device)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, floored at ``minval``. JAX's bits
    exactly where ``maxval - minval`` rounds to 1 (the ranges drawn here);
    on wider ranges XLA may fuse the scaling into one rounding."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if _on_cpu(device):
        one = (_bits(key, shape, True) >> 9) | np.uint32(0x3F800000)
        floats = one.view(np.float32) - np.float32(1.0)
        return torch.from_numpy(np.maximum(lo, floats * (hi - lo) + lo))
    bits = _bits(key, shape, False).to(device)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, device=floats.device)
    scale = torch.tensor(hi - lo, device=floats.device)
    return torch.maximum(lo_t, floats * scale + lo_t)


def gumbel(key: Key, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise, f32 (JAX's "low" mode): ``-log(-log(u))``
    in f64, rounded to f32 once, so that the host's and the card's noise
    agree and each is within one ulp of max(|g|, 1) of XLA's f32 logs."""
    u = uniform(key, shape, _F32_TINY, 1.0, device)
    if u.device.type == "cpu":  # numpy: one thread, no pool to contend
        g = -np.log(-np.log(u.numpy().astype(np.float64)))
        return torch.from_numpy(g.astype(np.float32))
    return (-torch.log(-torch.log(u.double()))).float()


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(``logits``) along the last axis of
    f32 ``logits``: ``argmax(logits + gumbel)``."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes f32 logits, got {logits.dtype}")
    return torch.argmax(gumbel(key, tuple(logits.shape), logits.device)
                        + logits, dim=-1)
