"""Device meshes (llm_inference_tpu/parallel/mesh.py's counterpart)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') grid of devices: ``devices`` is a [data, model]
    object array of ``torch.device``; ``shape["model"]`` and
    ``shape["data"]`` read its axes as the JAX ``Mesh`` does."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def model_devices(self) -> list:
        """The devices of the first 'data' row: the tensor-parallel ranks, in order."""
        return list(self.devices[0])


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" is the current one), as tensors
    report theirs."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(model: int | None = None, data: int = 1, *, devices=None) -> Mesh:
    """Build a ('data', 'model') mesh, every device on the 'model' axis by
    default (the tensor-parallel layout, as the JAX ``make_mesh``).

    ``devices`` defaults to every visible CUDA device. A device may repeat:
    ``[torch.device("cuda:0")] * 2`` is a two-rank mesh on one card (both
    ranks run in one launch of the tensor-parallel step, each as a group of
    the card's SMs), the counterpart of the JAX tests' virtual CPU mesh;
    ``[torch.device("cpu")] * n`` is the same on the CPU, where the steps run
    their plain twins."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if model is None:
        model = len(devices) // data
    if data * model > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {len(devices)}")
    arr = np.empty(data * model, dtype=object)
    arr[:] = devices[: data * model]
    return Mesh(arr.reshape(data, model))
