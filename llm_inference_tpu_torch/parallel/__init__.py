"""Multi-GPU inference: device meshes and sharding layouts
(llm_inference_tpu/parallel's counterpart).

  - tensor parallel, whole step: ``Engine(tp_mesh=...)`` runs the
    tensor-parallel decode kernels, one launch a device with the
    all-reduces inside (ops/kernels/fused_decode_tp.py, fused_decode_q_tp.py);
  - tensor parallel, per op: ``gemma_sharding_fn`` and the cache shardings
    split weights and KV heads over the mesh's 'model' ranks for the
    ``Engine``'s and ``BatchedServer``'s ``sharding_fn`` / ``cache_sharding``;
    the ranks run op by op, their outputs joined and summed in rank order;
  - data parallel: the server's dense lanes split over the 'data' axis.

A mesh may repeat a device (``[cuda:0] * n``, ``[cpu] * n``): n ranks in
one process on one card. ``distributed.initialize`` and
``distributed.global_mesh`` span processes over ``torch.distributed``.
"""

from .mesh import Mesh, make_mesh
from .sharding import (CacheSharding, batched_kv_cache_sharding, gemma_sharding_fn,
                       kv_cache_sharding)

__all__ = [
    "Mesh",
    "make_mesh",
    "gemma_sharding_fn",
    "kv_cache_sharding",
    "batched_kv_cache_sharding",
    "CacheSharding",
]
