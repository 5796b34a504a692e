"""The port's multi-process group (``parallel/distributed.py``): 2 real processes over gloo.

The counterpart of tests/test_distributed.py for the port: two OS processes
form a ``torch.distributed`` group through the coordinator (gloo on the
CPU, two CPU devices a process), and run the port's sharded path over a
mesh that spans both. The worker imports no JAX (its checkpoint comes from
chip_smoke.py's writer, byte for byte tests/fixtures.py's). Its three
parts mirror the JAX test's:

  1. a sum across the process boundary: four ranks' parts over one 'model'
     row of two processes, gathered and summed in rank order;
  2. a sharded forward over that row (weights and KV heads over 4 ranks):
     its logits' bytes and token, equal on both processes and to the
     one-process ``[cpu] * 4`` mesh's, which the test computes itself;
  3. each process's own lanes (a data row a process, the model axis within
     it): its lanes' greedy ids equal those lanes of the one-process mesh.

Marked slow, as tests/test_distributed.py is: it starts two processes.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.slow

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPROC = 2

_WORKER = r"""
import os, sys
pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.getcwd())

import torch

torch.set_num_threads(1)
from llm_inference_tpu_torch.parallel.distributed import global_mesh, initialize

initialize(coord, nproc, pid)
assert "jax" not in sys.modules

from torch_dist_common import CPU, batched_lanes, sharded_forward

# 1) four ranks' parts over one 'model' row of both processes, summed in rank order
mesh = global_mesh(model=2 * nproc, data=1, local_devices=[CPU, CPU])
parts = [torch.arange(4, dtype=torch.float32) + 100.0 * r if mesh.is_local(0, r) else None
         for r in range(2 * nproc)]
got = mesh.gather(parts, 0, CPU)
total = got[0]
for p in got[1:]:
    total = total + p
want = sum(torch.arange(4, dtype=torch.float32) + 100.0 * r for r in range(2 * nproc))
assert torch.equal(total, want), (total, want)
print(f"proc {pid}: global sum ok ({float(total.sum())})", flush=True)

# 2) the sharded forward over the row
digest, tok = sharded_forward(mesh)
print(f"proc {pid}: sharded forward ok (tok {tok})", flush=True)
print(f"RESULT {pid} {digest} {tok}", flush=True)

# 3) a data row a process: this process's own lanes
mesh2 = global_mesh(model=2, data=nproc, local_devices=[CPU, CPU])
mine = batched_lanes(mesh2, pid)
print(f"proc {pid}: own lanes ok ({mine})", flush=True)
print(f"BATCHED {pid} {' '.join(map(str, mine))}", flush=True)
"""

_COMMON = r"""
import hashlib

import torch

from chip_smoke import build_gemma3_gguf
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models.gemma import (forward, forward_batched_decode,
                                                  init_batched_cache, init_cache)
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, place_weights
from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                              kv_cache_sharding)

CPU = torch.device("cpu")
N = 4
VOCAB = [f"t{i}" for i in range(512)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
BUF = build_gemma3_gguf(n_layers=2, n_embd=128, n_ff=64 * N, n_head=N, n_head_kv=N,
                        vocab=VOCAB, seed=7, weight_std=0.2)
LANES = 2  # a data row's


def sharded_forward(mesh):
    hp, w = load_weights(GGUFFile(BUF), mode="rowq8", sharding_fn=gemma_sharding_fn(mesh))
    w = fuse_projections(w)
    cache = init_cache(hp, 16, sharding=kv_cache_sharding(mesh, hp.n_head_kv))
    a, cache = forward(hp, w, cache, torch.tensor([2, 7, 8, 9]), 0)
    b, _ = forward(hp, w, cache, torch.tensor([int(a.argmax())]), 4)
    digest = hashlib.sha256(a.numpy().tobytes() + b.numpy().tobytes()).hexdigest()[:16]
    return digest, int(b.argmax())


def batched_lanes(mesh, row):
    # lanes [row * LANES, (row + 1) * LANES) of data row ``row``: ids 3 + 2 * row, 4 + 2 * row
    hp, w = load_weights(GGUFFile(BUF), mode="bf16", sharding_fn=gemma_sharding_fn(mesh))
    lanes = init_batched_cache(hp, LANES * mesh.shape["data"], 16,
                               sharding=batched_kv_cache_sharding(mesh, hp.n_head_kv))
    if row != mesh.local_rows()[0]:  # the weights load for the first local row
        w = place_weights(w, mesh, row)
    toks = torch.tensor([3 + 2 * row, 4 + 2 * row])
    logits, _ = forward_batched_decode(hp, w, lanes.rows[row], toks,
                                       torch.zeros(LANES, dtype=torch.int32))
    return [int(t) for t in logits.argmax(-1)]
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_group_and_sharded_forward(tmp_path):
    (tmp_path / "worker.py").write_text(_WORKER)
    (tmp_path / "torch_dist_common.py").write_text(_COMMON)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), os.path.abspath(ROOT)])
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(pid), str(NPROC),
                               coord], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT, env=env)
             for pid in range(NPROC)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        for what in ("global sum ok", "sharded forward ok", "own lanes ok"):
            assert what in out, out

    # the same computations in this process, over one-process meshes of [cpu] * 4
    sys.path.insert(0, str(tmp_path))
    try:
        import torch_dist_common as common
    finally:
        sys.path.remove(str(tmp_path))
    from llm_inference_tpu_torch.parallel import make_mesh

    cpu = torch.device("cpu")
    digest, tok = common.sharded_forward(make_mesh(model=4, devices=[cpu] * 4))
    results = sorted(line.split()[1:] for out in outs for line in out.splitlines()
                     if line.startswith("RESULT"))
    assert [r[1:] for r in results] == [[digest, str(tok)]] * NPROC, (results, digest, tok)
    mesh2 = make_mesh(model=2, data=NPROC, devices=[cpu] * 4)
    batched = dict(line.split(maxsplit=2)[1:] for out in outs for line in out.splitlines()
                   if line.startswith("BATCHED"))
    for row in range(NPROC):
        assert batched[str(row)].split() == [str(t) for t in common.batched_lanes(mesh2, row)]
