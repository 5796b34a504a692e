"""llm_inference_tpu_torch — the PyTorch/CUDA port of llm_inference_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100, sm_90a).
The JAX package is the reference this port is held against; the port
imports neither ``jax`` nor ``llm_inference_tpu`` and keeps its own copies
of the jax-free modules it needs (GGUF container, block codecs, hparams,
tokenizer, the parity harness). Module names mirror the JAX package:

  gguf/         container reader + writer
  quant/        block codecs, int8 / nibble / bf16 device weights
  ops/          norms, rope, matmul dispatch, the parity contract (actquant)
  ops/kernels/  hand-written CUDA kernels (sources in csrc/) + plain twins
  models/       hparams, weight mapping, the Gemma-3 / gemma4 forward
  engine.py     single-stream generation, every mode
  serving.py    continuous batching over dense lanes or a page pool
  sampling.py   greedy or sampled ids; random.py: jax.random's threefry keys
  trace.py      named activation taps; parity.py compares them
  cli.py        ``python -m llm_inference_tpu_torch``

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
