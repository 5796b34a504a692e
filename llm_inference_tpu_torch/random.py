"""Counter-based random numbers, bit-equal to ``jax.random``'s default.

The JAX package samples with ``jax.random`` keys (threefry2x32, in the
partitionable scheme that JAX 0.9 uses by default: ``jax_threefry_partitionable``
True). This module keeps its own copy of that generator, importing nothing
of JAX (the names follow ``jax._src.prng``):

  - a key is two 32-bit words; ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``
    (JAX's ``threefry_seed`` of a 32-bit seed, prng.py:802-830);
  - ``fold_in(key, d)`` hashes the seed words of ``d`` under ``key``:
    ``threefry2x32(key, [0, d])`` (prng.py:1163-1170);
  - the 32-bit random word ``i`` of a key is ``y0 ^ y1`` of
    ``threefry2x32(key, (0, i))`` (the partitionable counters,
    prng.py:1184-1201).

Keys live on the host as numpy ``uint32`` arrays of shape ``[..., 2]``
(wrapping arithmetic; a chunk's keys are a few hundred words and go to the
device in one copy). The random words are made on the keys' device by
``random_bits``, batched over a leading lane axis. torch has no uint32
arithmetic that behaves alike on the CPU and on CUDA, so the device words
are ``int64`` tensors holding 32-bit values: every sum and left shift is
masked back to 32 bits before a rotate reads it, so the bits are the same
on every device.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, x0, x1, add, rotl):
    """threefry2x32's 20 rounds over words of any array type (prng.py:
    _threefry2x32_lowering); ``add`` wraps at 2**32 and ``rotl`` rotates a
    32-bit word."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _np_rotl(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """threefry2x32 of the counter words (x0, x1) under ``key`` [..., 2],
    numpy uint32, broadcast together; returns the two output words."""
    key = np.asarray(key, dtype=np.uint32)
    x0 = np.asarray(x0, dtype=np.uint32)
    x1 = np.asarray(x1, dtype=np.uint32)
    with np.errstate(over="ignore"):  # uint32 sums wrap, as threefry wants
        return _threefry(key[..., 0], key[..., 1], x0, x1, operator.add, _np_rotl)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s words, [2] uint32: the seed's low 32
    bits under a zero high word (JAX without x64 keeps 32 bits of a seed)."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``'s words for keys [..., 2] and data
    [...] (broadcast together; data taken mod 2**32): [..., 2] uint32."""
    key = np.asarray(key, dtype=np.uint32)
    data = (np.asarray(data, dtype=np.int64) & _MASK).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def to_device(keys: np.ndarray, device) -> torch.Tensor:
    """Host keys [..., 2] uint32 -> the int64 words ``random_bits`` takes,
    on ``device``, in one copy."""
    return torch.from_numpy(np.asarray(keys, dtype=np.uint32).astype(np.int64)).to(device)


def _t_add(a, b):
    return (a + b) & _MASK


def _t_rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for every key of ``keys``
    [..., 2] (int64 words, ``to_device``): [..., n] int64 in [0, 2**32),
    on the keys' device."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = _threefry(keys[..., :1], keys[..., 1:], torch.zeros_like(counts), counts,
                       _t_add, _t_rotl)
    return y0 ^ y1
