"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

  qmatmul.py       quant_matmul, rowwise branch   (csrc/qmatmul.cu)
  fused_decode.py  the whole decode step          (csrc/fused_decode.cu)
  fused_decode_batch.py  the batched decode step  (csrc/fused_decode_batch.cu)
  flash_decode.py  ragged one-query attention     (csrc/flash_decode.cu)
  kv_insert.py     in-place KV row insertion      (csrc/kv_insert.cu)

Sources build with nvcc at first use (_build.py); nothing here compiles or
loads a library at import time, so the package imports on any machine.
"""
