"""Token sampling, the counterpart of llm_inference_tpu/sampling.py.

Greedy argmax is the reference's sampler (reference main.cpp:192-194) and
the default. Temperature, top-k and top-p follow the JAX package's
``sample`` step for step (sampling.py:30-52) and draw with its keys
(``random.py``): the categorical draw is ``argmax(gumbel + logits)``
(jax.random.categorical, random.py:1739-1800 of JAX 0.9), its Gumbel noise
``-log(-log(u))`` of a uniform ``u`` in [tiny, 1) made from the key's random
words (``_gumbel`` "low" mode, ``_uniform``). Everything runs on the
logits' device in f32; only the ids leave it.

Two details make the ids the JAX package's and not merely alike:

  - the JAX package samples inside jit, where XLA turns the division by a
    constant temperature into a product with its f32 reciprocal; so does
    this module;
  - every quantity is f32, whatever the logits' dtype (bf16 / f32 promotes
    to f32 in jnp, and the noise takes the promoted dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .random import random_bits

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy argmax (the reference's sampler)
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def _f32(x: float) -> float:
    """``x`` rounded to f32: a Python scalar in an op on an f32 tensor is
    taken as f32, so these are the JAX constants' values (and no host copy
    to the device)."""
    return float(np.float32(x))


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` for every key
    of ``keys`` [..., 2] (random.py ``to_device`` words): the top 23 bits of
    each random word as the mantissa of a float in [1, 2), less 1, scaled to
    [minval, 1) and clamped at ``minval``. [..., n] f32 on the keys' device."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(minval)
    return (floats * _f32(np.float32(1.0) - np.float32(lo)) + lo).clamp_min(lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` ("low" mode) for every key
    of ``keys`` [..., 2]: [..., n] f32."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_TINY)))


def _draw(logits: torch.Tensor, cfg: SamplingConfig, keys: torch.Tensor) -> torch.Tensor:
    """[B, V] logits, keys [B, 2] on their device -> [B] int64 ids: the JAX
    ``sample`` of each row under its key."""
    V = logits.shape[-1]
    # XLA's x / c is x * (1 / c) for a constant c: the f32 reciprocal, then the product
    x = logits.float() * _f32(np.float32(1.0) / np.float32(cfg.temperature))
    if cfg.top_k and cfg.top_k > 0:
        # a top_k >= vocab keeps everything (tiny vocabularies); ties at the k-th stay
        kth = torch.topk(x, min(cfg.top_k, V), dim=-1).values[:, -1:]
        x = x.masked_fill(x < kth, float("-inf"))
    if cfg.top_p < 1.0:
        s = torch.sort(x, dim=-1, descending=True).values
        e = torch.exp(s - s[:, :1])  # jax.nn.softmax: exp(x - max) / sum
        cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
        # the smallest prefix whose mass reaches top_p
        idx = (cum < _f32(cfg.top_p)).sum(dim=-1, keepdim=True)
        cutoff = s.gather(-1, idx.clamp(max=V - 1))
        x = x.masked_fill(x < cutoff, float("-inf"))
    return torch.argmax(gumbel(keys, V) + x, dim=-1)


def _need_keys(keys) -> None:
    if keys is None:
        raise ValueError("stochastic sampling needs PRNG keys (llm_inference_tpu_torch.random)")


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           key: torch.Tensor | None = None) -> torch.Tensor:
    """One token id (0-d int64 tensor, on the logits' device) from [vocab]
    logits: greedy, the lowest id among the maxima (``key`` unused); else the
    JAX package's draw under ``key`` ([2] words on the logits' device)."""
    if cfg.is_greedy:
        return torch.argmax(logits)
    _need_keys(key)
    return _draw(logits[None], cfg, key.reshape(1, 2))[0]


def pick_batch(logits: torch.Tensor, cfg: SamplingConfig,
               keys: torch.Tensor | None = None) -> torch.Tensor:
    """[B, vocab] logits -> [B] int32 ids. Greedy: the lowest id among each
    row's maxima (llm_inference_tpu/serving.py:126-139). The JAX version
    returns id ``vocab``, outside the vocabulary, for a row holding NaN;
    this one keeps ``argmax`` semantics there too (NaN counts as the
    maximum, its first position wins), so every id is a valid one.
    Stochastic: row b drawn under ``keys[b]`` ([B, 2] words on the logits'
    device), as the JAX server's vmapped ``sample``."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    _need_keys(keys)
    return _draw(logits, cfg, keys).to(torch.int32)
