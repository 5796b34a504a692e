"""Multi-GPU decode: device meshes (llm_inference_tpu/parallel's counterpart).

Only the mesh is ported so far; it feeds ``Engine(tp_mesh=...)``, the
tensor-parallel whole-step decode (ops/kernels/fused_decode_tp.py,
fused_decode_q_tp.py). The per-op GSPMD sharding path (``sharding.py``) and
multi-host start-up (``distributed.py``) are ROADMAP.md queue 1, item 5.
"""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
