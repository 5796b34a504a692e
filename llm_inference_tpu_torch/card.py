"""The card the port's measurements are taken on: the NVIDIA H100 SXM's
peak rates, the least time a piece of work could take on it, and the
card's name and power limit as nvidia-smi gives them. chip_smoke.py and
the tools under tools/ share these, so every printed bound and card line
is reckoned one way."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # HBM3
BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core operations
F32_OPS_PER_S = 67e12      # f32 CUDA-core operations


def _ops_s(bf16_ops: float, f32_ops: float) -> float:
    return bf16_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S


def bound_ms(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> float:
    """Least time for the work: moving its bytes, or its bf16 tensor-core
    and f32 CUDA-core operations at their peaks, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, _ops_s(bf16_ops, f32_ops)) * 1e3


def bound_by(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= _ops_s(bf16_ops, f32_ops) else "operations"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def card_line(device) -> str:
    """The card's name and power limit on ``cuda``, else the device."""
    import torch

    if torch.device(device).type != "cuda":
        return f"device {device}"
    return nvidia_smi()
