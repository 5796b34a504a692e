"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/kernels/`` beside the
package (listed in .gitignore). The library name carries a hash of the
source and of the shared headers (csrc/*.cuh), so an edited kernel never
loads a stale build. The library is
loaded with ctypes; every pointer and the stream pass as ``c_void_p``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them, so a cold start costs the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("qmatmul", "fused_decode", "fused_decode_q", "fused_decode_batch", "flash_decode",
           "kv_insert")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build at first use on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless its build exists; returns
    (target, tmp, process) or (target, None, None)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> str:
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, target)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every kernel source in parallel; returns each build's
    compiler log (registers, shared memory, spills from ``-Xptxas -v``)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        target, tmp, proc = _start(name)
        _finish(name, target, tmp, proc)
        lib = ctypes.CDLL(str(target))
        _libs[name] = lib
    return lib


def check(name: str, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by library ``name``'s C entry."""
    if err != 0:
        fn = library(name)[f"{name}_error_string"]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
