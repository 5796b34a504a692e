"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

  qmatmul.py       quant_matmul (per-row and grouped int8), q4_matmul (csrc/qmatmul.cu)
  fused_decode.py  the whole decode step, per-row int8 (csrc/fused_decode.cu)
  fused_decode_q.py  the whole decode step, lossless group-scaled (csrc/fused_decode_q.cu)
  fused_decode_batch.py  the batched decode step  (csrc/fused_decode_batch.cu)
  fused_decode_batch_paged.py  the same step over a page pool (csrc/fused_decode_batch.cu)
  flash_decode.py  ragged one-query attention, dense or paged (csrc/flash_decode.cu)
  kv_insert.py     in-place KV row insertion      (csrc/kv_insert.cu)

The two whole steps share one skeleton (csrc/decode_step.cuh). Sources
build with nvcc at first use (_build.py); nothing here compiles or
loads a library at import time, so the package imports on any machine.
"""
