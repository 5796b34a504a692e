"""Make sure llm_inference_tpu's native helper is loaded before a port test
compares the port with the JAX package.

The JAX package builds its native helper (native/llmi_native.cpp) with g++
into /tmp at first use, in every test worker at once and without a lock,
and a worker that loads the library while another worker's g++ is still
writing it gets an ``OSError``. ``native.get_lib()`` then remembers the
failure for the life of that process, and the package falls back to its
exact-f32 dequant (quant/device.py ``requantize_rowwise``): other int8
values and row scales than the default route, which the port reproduces.
Every comparison in that worker then fails.

``jax_native`` builds and loads the library once under a file lock: a
library that does not load in a child process (a g++ killed while writing
it) is deleted and built again, and a process that remembers a failed load
reloads the ``native`` module to forget it. Import it into a test module to
make it autouse there:

    from torch_jax_native import jax_native  # noqa: F401
"""

import fcntl
import hashlib
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest


def _library_path(native) -> Path:
    """Where ``native`` builds its library: /tmp, keyed by its source's path
    and mtime (llm_inference_tpu/native.py ``_build``)."""
    src = Path(native.__file__).resolve().parent.parent / "native" / "llmi_native.cpp"
    h = hashlib.sha256()
    h.update(str(src).encode())
    h.update(str(src.stat().st_mtime_ns).encode())
    return Path("/tmp") / f"llmi_native_{h.hexdigest()[:16]}.so"


def _loads(so: Path) -> bool:
    """Whether the library at ``so`` loads, tried in a child process: loading
    a truncated library whose header is intact kills the process (SIGBUS)."""
    probe = "import ctypes, sys; ctypes.CDLL(sys.argv[1])"
    return subprocess.run([sys.executable, "-c", probe, str(so)],
                          capture_output=True).returncode == 0


def require_jax_native():
    """The loaded native library of the JAX package; raises if it cannot be
    built and loaded (no g++, or LLMI_NO_NATIVE set)."""
    from llm_inference_tpu import native

    if os.environ.get("LLMI_NO_NATIVE"):
        raise RuntimeError("LLMI_NO_NATIVE is set: the port tests compare with the JAX "
                           "package's default (native) route")
    so = _library_path(native)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and not _loads(so):
            so.unlink()  # a partial library: build it again
        lib = native.get_lib()
        if lib is None:
            importlib.reload(native)  # forget this process's failed load
            lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"the JAX package's native helper did not build or load ({so}; "
                           "is g++ there?)")
    return lib


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    return require_jax_native()
