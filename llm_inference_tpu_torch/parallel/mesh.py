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
    # multi-process meshes (parallel/distributed.py global_mesh): each device's
    # process, and each data row's process group (None: the row is one process's)
    processes: np.ndarray | None = None
    groups: tuple = ()

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def model_devices(self) -> list:
        """The devices of the first 'data' row: the tensor-parallel ranks, in order."""
        return list(self.devices[0])

    def is_local(self, d: int, r: int) -> bool:
        """Whether rank ``r`` of data row ``d`` is this process's."""
        return self.processes is None or int(self.processes[d, r]) == _process_index()

    def local_rows(self) -> list[int]:
        """The data rows that hold a device of this process."""
        return [d for d in range(self.shape["data"])
                if any(self.is_local(d, r) for r in range(self.shape["model"]))]

    def home(self, d: int = 0) -> torch.device:
        """Where data row ``d``'s activations live in this process: its
        first device of the row (the row's first device in one process)."""
        return next(self.devices[d, r] for r in range(self.shape["model"]) if self.is_local(d, r))

    def gather(self, parts: list, d: int, home: torch.device) -> list:
        """Every rank's part of data row ``d`` on ``home``, in rank order.
        ``parts[r]`` is rank r's tensor, None for a rank of another process.
        In one process the parts are moved (a no-op on their own device);
        across processes the row's processes all-gather their ranks' parts,
        all of one shape (the ranks a process holds in a row are
        consecutive, global_mesh's layout)."""
        if self.processes is None or not self.groups or self.groups[d] is None:
            return [p.to(home) for p in parts]
        import torch.distributed as dist

        mine = torch.stack([p.to(home) for p in parts if p is not None])
        got = [torch.empty_like(mine) for _ in range(dist.get_world_size(self.groups[d]))]
        dist.all_gather(got, mine.contiguous(), group=self.groups[d])
        return [t for block in got for t in block.unbind(0)]


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


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
