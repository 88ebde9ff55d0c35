"""Threefry-2x32 counter-based PRNG, bitwise-equal to ``jax.random``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words,
the same words a JAX ``PRNGKey`` holds (:func:`key_from_numpy` converts
one).  Every function takes keys with arbitrary leading batch dimensions
and returns results with those dimensions in front, so ``B`` agents draw
their streams in one call where the JAX package ``vmap``s.

The streams follow JAX's partitionable threefry mode (the default of the
JAX release the reference runs with): ``split`` and the random bits hash
the row-major iota of the output shape as a (hi, lo) counter pair, and
32-bit draws are ``bits1 ^ bits2``.  ``fold_in`` hashes the counter pair
``(0, data)`` as the original mode does.  uint32 arithmetic runs in int64
masked to 32 bits.  :func:`normal` reaches ``erf_inv`` and :func:`gumbel`
``log`` through XLA's own CPU polynomials (:mod:`repro_torch.xla_math`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import xla_math

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    holding uint32 values; returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def key_from_numpy(key) -> torch.Tensor:
    """A JAX key's raw ``(..., 2)`` uint32 words as a port key."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` for integer seeds in ``[0, 2**32)``
    (scalar or array: an array gives one key per seed)."""
    s = torch.as_tensor(np.asarray(seed, np.int64), device=device)
    s = s & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _iota(shape, device) -> torch.Tensor:
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_iota(key: torch.Tensor, shape: tuple):
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape((*lead, *([1] * len(shape))))
    k2 = key[..., 1].reshape((*lead, *([1] * len(shape))))
    lo = _iota(shape, key.device)          # counts < 2**32: hi word is 0
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a non-negative integer ``data``."""
    d = torch.full(key.shape[:-1], int(data) & _M32, dtype=torch.int64,
                   device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element, ``(..., *shape)`` int64."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform` of the draw whose :func:`random_bits` are
    ``bits``."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), shifted and scaled."""
    return uniform_from_bits(random_bits(key, tuple(shape)), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """:func:`gumbel` of the draw whose :func:`random_bits` are
    ``bits``."""
    u = uniform_from_bits(bits, minval=_F32_TINY, maxval=1.0)
    return -xla_math.log(-xla_math.log(u))


def gumbel(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"``: both logs as XLA
    computes them on the CPU (:func:`repro_torch.xla_math.log`)."""
    return gumbel_from_bits(random_bits(key, tuple(shape)))


def normal(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``, ``erf_inv`` as XLA computes it
    (:func:`repro_torch.xla_math.erf_inv`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0)
    return float(np.float32(np.sqrt(2.0))) * xla_math.erf_inv(u)
