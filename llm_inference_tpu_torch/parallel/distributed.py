"""Multi-process start-up over ``torch.distributed``.

Counterpart of llm_inference_tpu/parallel/distributed.py. The JAX package
forms its process group with ``jax.distributed.initialize`` and runs one
program over a mesh that holds every host's devices. Here every process
runs the same port code (the Engine, the server, ``forward``) over a mesh
from :func:`global_mesh`: each process holds its own ranks' shards and
caches, and where a data row's ranks span processes, the joins and sums
between ranks go through ``Mesh.gather`` (parallel/mesh.py), an all-gather
of the row's parts followed by the same join or rank-order sum as in one
process. So every process gets the same bits as the one-process mesh of
the same ranks; a ring all-reduce would add in another order.

The backend is NCCL for CUDA devices (one card a process) and gloo on the
CPU. Call :func:`initialize` once, before any mesh is built; the
coordinator's address is given (``host:port``), or, with no arguments,
read from the environment of ``torchrun`` (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

_initialized = False


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group (idempotent)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(_card())
    _initialized = True


def _card() -> int:
    """This process's card: its rank modulo the cards it sees."""
    return dist.get_rank() % torch.cuda.device_count()


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", _card())]
    return [torch.device("cpu")]


def global_mesh(model: int | None = None, data: int = 1, *, local_devices=None) -> Mesh:
    """A ('data', 'model') mesh over every process's devices, process by
    process: process p's ``local_devices`` (default: its card, or the CPU)
    come after those of processes 0..p-1, so a data row holds consecutive
    processes' devices, and with ``data`` = the process count each process
    holds one whole row (the model axis stays within a process). Every
    process must give as many local devices. A row whose ranks span
    processes gets a process group of its own for ``Mesh.gather``; every
    process makes every row's group, in row order, as ``new_group`` asks."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call parallel.distributed.initialize first")
    local = list(local_devices) if local_devices is not None else _local_devices()
    nproc, me = dist.get_world_size(), dist.get_rank()
    counts = [None] * nproc
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"global_mesh: processes hold different device counts {counts}")
    total = nproc * len(local)
    if model is None:
        model = total // data
    if data * model != total:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, the processes "
                         f"hold {total}")
    devices = np.empty(total, dtype=object)
    processes = np.repeat(np.arange(nproc), len(local))
    for p in range(nproc):
        # another process's device is named by its own list: a placeholder here
        for j, dev in enumerate(local):
            devices[p * len(local) + j] = torch.device(dev) if p == me else torch.device("meta")
    processes = processes.reshape(data, model)
    groups = []
    for d in range(data):
        procs = sorted({int(p) for p in processes[d]})
        groups.append(dist.new_group(procs) if len(procs) > 1 else None)
    return Mesh(devices.reshape(data, model), processes=processes, groups=tuple(groups))
