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
            "stochastic sampling is not ported yet (ROADMAP.md queue 1, item 9)")
    return torch.argmax(logits)
