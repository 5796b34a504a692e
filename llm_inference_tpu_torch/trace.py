"""Named-activation tracing: the parity harness's data source.

Counterpart of llm_inference_tpu/trace.py. The reference instruments about
thirty points of its forward pass with llama.cpp-compatible tensor names
(reference model.cpp:711-988, printer tensor.h:22-85); ``models/gemma.py``
taps the same names in the same order.

  - off (the default): ``tap`` returns its argument and does nothing else;
  - on (``enable_trace``): ``tap`` copies the value to the host as f32
    numpy (a device sync, paid only while tracing) and keeps it in order;
    ``save`` writes an .npz keyed ``f"{i:04d}|{name}"`` and ``summary``
    gives one line a record (name, shape, sum, and a NaN flag where the
    reference's printer would abort, tensor.h:81-84).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_active: Optional["TraceSession"] = None


@dataclasses.dataclass
class TraceSession:
    path: str
    records: list[tuple[str, np.ndarray]] = dataclasses.field(default_factory=list)

    def add(self, name: str, value: np.ndarray) -> None:
        self.records.append((str(name), np.asarray(value)))

    def save(self) -> None:
        np.savez(self.path, **{f"{i:04d}|{name}": value
                               for i, (name, value) in enumerate(self.records)})

    def summary(self) -> str:
        lines = []
        for name, v in self.records:
            flat = v.reshape(-1)
            nan = " NAN!" if np.isnan(flat).any() else ""
            lines.append(f"{name} shape={list(v.shape)} sum={flat.sum():.6f}{nan}")
        return "\n".join(lines)


def enable_trace(path: str) -> TraceSession:
    global _active
    _active = TraceSession(path=path)
    return _active


def disable_trace() -> None:
    global _active
    _active = None


def current() -> Optional[TraceSession]:
    return _active


def tap(name: str, x: torch.Tensor) -> torch.Tensor:
    """Record ``x`` under ``name`` while tracing is on; ``x`` unchanged."""
    if _active is not None:
        _active.add(name, x.detach().float().cpu().numpy())
    return x
