"""Token sampling. Greedy argmax is the reference's sampler (reference
main.cpp:192-194) and the only one ported so far; temperature / top-k /
top-p sampling needs its own counter-based generator design and is a later
slice."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy argmax (the reference's sampler)
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def sample(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """One token id (0-d int64 tensor, on the logits' device) from [vocab]
    logits: the lowest id among the maxima."""
    if not cfg.is_greedy:
        raise NotImplementedError(
            "stochastic sampling is not ported yet (ROADMAP.md queue 1, item 4)")
    return torch.argmax(logits)


def pick_batch(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """[B, vocab] logits -> [B] int32 ids, greedy: the lowest id among each
    row's maxima (llm_inference_tpu/serving.py:126-139). The JAX version
    returns id ``vocab``, outside the vocabulary, for a row holding NaN;
    this one keeps ``argmax`` semantics there too (NaN counts as the
    maximum, its first position wins), so every id is a valid one."""
    if not cfg.is_greedy:
        raise NotImplementedError(
            "stochastic sampling is not ported yet (ROADMAP.md queue 1, item 4)")
    return torch.argmax(logits, dim=-1).to(torch.int32)
