"""Inference engine: single-stream generation, greedy or sampled.

Counterpart of llm_inference_tpu/engine.py (reference main.cpp:160-234) for
its five modes: ``serve`` (the default: every matmul weight dequantized
once to bf16), ``serve-q8`` (the checkpoint requantized per row,
requantize_rowwise), ``serve-q`` (its own group-scaled int8 quants,
lossless), ``serve-q4`` (the same with Q4_0/Q4_K layer weights
nibble-packed) and ``parity`` (the reference's numeric contract,
models/gemma.py ``forward(exact=True)``: the checkpoint's quants, exact
products, the parity attention, an f16 cache; the unfused projections, so
its Q, K, V, gate and up taps come from separate products, engine.py:200-203
of the JAX package). The other modes' projections fuse. A prompt, padded to
a power-of-two bucket, prefills through the layer loop, and decode runs in
chunks of ``decode_chunk`` steps. Inside a chunk
the token ids and positions stay on the device: each step reads its token
from device memory, the sampler writes the next one there, and only the
chunk's ids come back to the host, once per chunk. (A CUDA graph over the
chunk is later work.)

Sampling (``sampling``, ``seed``; sampling.py) is greedy by default. A
stochastic ``SamplingConfig`` draws with the JAX engine's keys on every
route (engine.py:387-455 of the JAX package): the prefill's id under
``fold_in(PRNGKey(seed), n_prompt)``, decode step ``p`` (its input position)
under ``fold_in(PRNGKey(seed), p + 1)``. A chunk's keys are computed on the
host and reach the device in one copy; the draw runs on the logits'
device.

Decode routes, by the JAX engine's rule (engine.py:210-299); serve and
parity always decode per op, like the per-op route below but over bf16
(serve) or exactly contracted (parity) weights:

  - kernel route: the layers stack and every decode step is one whole-step
    kernel call (rowq8: ops/kernels/fused_decode.py; serve-q/serve-q4:
    ops/kernels/fused_decode_q.py). In serve-q/serve-q4 the prefill then
    runs plain GEMMs over a bf16 copy of the dequantized layer weights, made
    once at load under a budget (``LLMI_PREFILL_BF16``,
    ``LLMI_PREFILL_BF16_BUDGET``, engine.py:338-380), as the JAX package
    computes it outside its kernels;
  - per-op route (under ``LLMI_NO_FUSED_DECODE=1``, or for a checkpoint
    the whole step cannot take): per-layer weights, every projection with
    T <= 64 through the ``quant_matmul``/``q4_matmul`` kernels
    (ops/linear.py), prefill and decode alike.

  - capacity route (serve-q/serve-q4, the JAX engine's capacity path,
    engine.py:129-195): decided from the GGUF tensor directory before any
    load, when the lossless whole step cannot take the geometry (its limits
    from shapes alone, ``fused_decode_q.whole_step_fits``: D or H * dv
    above 1536, as every Gemma-3 from 4B up) or ``LLMI_FORCE_CAPACITY=1``
    asks for it. The layers load stacked straight from the GGUF
    (``load_capacity_stacked``), the cache is flat ([L, S, Hkv * d]), every
    decode step is one call of the capacity step
    (ops/kernels/fused_decode_stream.py), and the prefill runs per op over
    per-layer views of the stacked weights (no bf16 operand cache: it would
    cost 2 bytes a weight). If the directory check, the load or the
    post-load check refuses, the capacity weights are freed and the
    standard load follows.

A gemma4 checkpoint takes the JAX engine's gemma4 rule (engine.py:217-237):
in serve-q8 the kernel route over ``stack_layers_gemma4``'s zero-padded
stack (the whole step's gemma4 instance), with the prefill over views of
that one stack (the JAX engine keeps a second, unrolled copy for it); in
serve-q and serve-q4 the per-op route, since neither the lossless nor the
capacity step takes gemma4.

Tensor parallelism (``tp_mesh``, the JAX engine's engine.py:83-114,
:300-337, :425-465): serve-q8 / serve-q / serve-q4 decode through the
tensor-parallel whole step, one rank per device of the mesh's 'model' axis
(ops/kernels/fused_decode_tp.py, fused_decode_q_tp.py): the stacked weights
are sharded at load, each rank keeps a K/V cache replica, and each decode
step is one launch a device with the all-reduces inside. The prefill runs
on the mesh's first device, per op over the unsharded stacked weights (no
bf16 operand cache, as in JAX), and fills replica 0; the other replicas are
copied from it. ``decode_route`` is then "tp". The engine refuses what the
JAX engine refuses (``sharding_fn`` with it, another mode, an ineligible
geometry, the capacity route) and a gemma4 checkpoint. A mesh may repeat a
device: ``make_mesh(model=2, devices=[cuda:0] * 2)`` runs two ranks on one
card, ``[cpu] * 2`` the plain twins.

Sharded per op (``sharding_fn``, ``cache_sharding``; the JAX engine's
GSPMD path, engine.py:89-90, :196-199, :384-422): ``sharding_fn``
(parallel/sharding.py ``gemma_sharding_fn``) splits the matmul weights at
load over the 'model' ranks of its mesh (row-parallel Q/K/V, gate and up,
col-parallel attn_output and down, the vocabulary of the embedding; what
does not divide is replicated), and ``cache_sharding``
(``kv_cache_sharding``) splits the cache's KV heads over them where they
divide, else keeps one copy. Either may come alone. The engine runs on the
mesh's first data row: activations live on its first device, and every
sharded op runs its ranks there and joins or sums their outputs in rank
order (ops/linear.py, models/gemma.py). Prefill and decode are per op over
per-layer weights, with the T <= 64 products through the
``quant_matmul``/``q4_matmul`` kernels at the shards' shapes and
``LLMI_FLASH_DECODE=1`` attention through ``flash_decode`` on each rank's
heads; ``decode_route`` is then "sharded". As in the JAX engine the
capacity route and the whole steps are not taken under ``sharding_fn``
(engine.py:129-134, :211-216), and ``tp_mesh`` excludes it; a cache
sharding that splits the heads keeps them off too (a whole step reads one
cache). ``make_mesh(model=n, devices=[cuda:0] * n)`` runs n ranks on one
card, ``[cpu] * n`` on the CPU; parallel/distributed.py's ``global_mesh``
spans processes.

``decode_route`` says which one the engine took. An eligibility rule that
says no is a route decision; a kernel that fails to build or to launch
raises.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU;
without a GPU the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import random
from .gguf.reader import GGUFFile
from .gguf.constants import GGMLType
from .models.gemma import (KV_DTYPE, PARITY_KV_DTYPE, KVCache, forward, init_cache,
                           init_cache_splits_heads, swa_mask_enabled)
from .models.hparams import load_hparams
from .models.weights import (LayerWeights, ModelWeights, fuse_projections, layer_bytes_estimate,
                             layers_stackable, load_capacity_stacked, load_weights, stack_layers,
                             stack_layers_gemma4, weight_layer)
from .ops.kernels import (fused_decode, fused_decode_q, fused_decode_q_tp, fused_decode_stream,
                          fused_decode_tp)
from .ops.numerics import softcap
from .quant.device import DenseTensor
from .sampling import SamplingConfig, sample
from .tokenizer import Tokenizer

DEFAULT_MAX_SEQ = 4096
MIN_PREFILL_BUCKET = 32
DECODE_CHUNK = 16

# engine mode -> load mode (models/weights.py)
LOAD_MODE = {"serve": "bf16", "serve-q8": "rowq8", "serve-q": "packed-serve",
             "serve-q4": "packed-q4", "parity": "packed"}
KERNEL_MODES = ("serve-q8", "serve-q", "serve-q4")  # the modes with whole-step kernels
PREFILL_BF16_BUDGET = 3 * 1024**3  # bytes, the JAX engine's default
_PREFILL_PARTS = ("wqkv", "wo", "w_gate_up", "w_down")


def sharding_mesh(sharding_fn, cache_sharding):
    """The mesh of ``sharding_fn`` and ``cache_sharding`` (None without
    either); they must name the same devices in the same grid."""
    if sharding_fn is not None and getattr(sharding_fn, "mesh", None) is None:
        raise ValueError("sharding_fn: a function of parallel.sharding.gemma_sharding_fn, which "
                         "carries its mesh")
    if cache_sharding is not None and getattr(cache_sharding, "mesh", None) is None:
        raise ValueError("cache_sharding: a parallel.sharding.CacheSharding")
    meshes = [x.mesh for x in (sharding_fn, cache_sharding) if x is not None]
    if len(meshes) == 2 and (meshes[0].devices.shape != meshes[1].devices.shape or any(
            a != b for a, b in zip(meshes[0].devices.flat, meshes[1].devices.flat))):
        raise ValueError("sharding_fn and cache_sharding must share one mesh")
    return meshes[0] if meshes else None


def prefill_bucket(n: int) -> int:
    """Round a prompt length up to the next power-of-two bucket."""
    b = MIN_PREFILL_BUCKET
    while b < n:
        b *= 2
    return b


def prefill_operands(weights: ModelWeights) -> ModelWeights:
    """The bf16 prefill operand cache (llm_inference_tpu/engine.py:338-380):
    stacked group-scaled projections dequantized once to bf16 (q * scale -
    offset in f32, then RNE), so a prefill runs plain GEMMs instead of
    dequantizing every projection on every call. Numerics are unchanged: the
    per-op route dequantizes to the same bf16 values. Costs 2 bytes a weight,
    so it is skipped (the weights returned as they are) when
    ``LLMI_PREFILL_BF16=0`` or above ``LLMI_PREFILL_BF16_BUDGET`` bytes
    (default 3 GiB)."""
    lw = weights.layers
    budget = int(os.environ.get("LLMI_PREFILL_BF16_BUDGET", str(PREFILL_BF16_BUDGET)))
    L = lw.attn_norm.shape[0]
    need = sum(2 * L * getattr(lw, f).rows * getattr(lw, f).cols for f in _PREFILL_PARTS)
    if os.environ.get("LLMI_PREFILL_BF16", "1") == "0" or need > budget:
        return weights
    dense = {}
    for f in _PREFILL_PARTS:
        t = getattr(lw, f)
        arr = torch.empty((L, t.rows, t.cols), dtype=torch.bfloat16, device=lw.attn_norm.device)
        for l in range(L):  # one layer's f32 transient at a time
            arr[l] = weight_layer(t, l).dequant(torch.bfloat16)
        dense[f] = DenseTensor(w=arr, fmt=GGMLType.BF16, rows=t.rows, cols=t.cols)
    return dataclasses.replace(weights, layers=dataclasses.replace(lw, **dense))


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA device must exist (no quiet CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("llm_inference_tpu_torch runs on a CUDA GPU by default and none is "
                           "available; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    decode_steps: int = 0  # device steps executed (>= generated_tokens)
    first_logits: Optional[torch.Tensor] = None  # device tensor; fetched lazily

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_steps / self.decode_seconds if self.decode_seconds else 0.0


class Engine:
    """Single-model generation engine (batch 1; greedy unless ``sampling``
    says otherwise)."""

    def __init__(
        self,
        gguf: GGUFFile | str,
        *,
        max_seq: int = DEFAULT_MAX_SEQ,
        mode: str = "serve",
        decode_chunk: int = DECODE_CHUNK,
        sampling: SamplingConfig | None = None,
        seed: int = 0,
        device="cuda",
        tp_mesh=None,
        sharding_fn=None,
        cache_sharding=None,
    ):
        """``tp_mesh``: a ``parallel.Mesh`` whose 'model' axis routes decode
        through the tensor-parallel whole step (the module's notes);
        ``device`` is then the mesh's first device. ``sharding_fn`` and
        ``cache_sharding`` (parallel/sharding.py): the sharded per-op route
        (the module's notes); ``device`` is then the first device of the
        mesh's first data row (this process's, across processes)."""
        if tp_mesh is not None:
            if sharding_fn is not None:
                raise ValueError("tp_mesh and sharding_fn are mutually exclusive")
            if cache_sharding is not None:
                raise ValueError("tp_mesh keeps its own cache replicas; cache_sharding is for "
                                 "the per-op route")
            if mode not in KERNEL_MODES:
                raise ValueError("tp_mesh requires mode 'serve-q8' (rowq8 TP kernel) or "
                                 "'serve-q'/'serve-q4' (lossless TP kernel)")
        if mode not in LOAD_MODE:
            raise ValueError(f"unknown engine mode {mode!r}")
        mesh = sharding_mesh(sharding_fn, cache_sharding)
        self._cache_sharding = cache_sharding
        # the per-op sharded route: sharded weights, or a cache whose heads split
        sharded = sharding_fn is not None or (cache_sharding is not None
                                              and init_cache_splits_heads(cache_sharding))
        if tp_mesh is not None:
            device = tp_mesh.model_devices[0]
        elif mesh is not None:
            device = mesh.home(mesh.local_rows()[0])
        self.sampling = sampling or SamplingConfig()
        self._base_key = random.PRNGKey(seed)
        self.device = resolve_device(device)
        if isinstance(gguf, str):
            gguf = GGUFFile(gguf)
        hp = load_hparams(gguf.metadata)
        lossless = mode in ("serve-q", "serve-q4")
        want_kernel = (mode in KERNEL_MODES and not sharded
                       and os.environ.get("LLMI_NO_FUSED_DECODE", "0") != "1")
        gemma4 = hp.architecture == "gemma4"
        self.gguf = gguf
        self.mode = mode
        self.exact = mode == "parity"
        capacity = None
        if lossless and want_kernel and not gemma4:  # the capacity load refuses gemma4
            capacity = self._capacity_load(gguf, hp, q4=mode == "serve-q4", max_seq=max_seq)
        if capacity is not None:
            self.hparams, weights = capacity
            step = fused_decode_stream
            self.decode_route = "capacity"
        else:
            self.hparams, weights = load_weights(gguf, hp, mode=LOAD_MODE[mode],
                                                 device=self.device, sharding_fn=sharding_fn)
            if not self.exact:  # parity keeps a tap on every projection
                weights = fuse_projections(weights)
            step = fused_decode_q if lossless else fused_decode
            supported = step.decode_q_supported if lossless else step.decode_supported
            if want_kernel and gemma4 and not lossless:
                stacked = stack_layers_gemma4(self.hparams, weights)
                if stacked is not None and supported(self.hparams, stacked):
                    weights = stacked
            elif want_kernel and layers_stackable(self.hparams, weights.layers):
                stacked = dataclasses.replace(weights, layers=stack_layers(weights.layers))
                if supported(self.hparams, stacked):
                    weights = stacked
            self.decode_route = ("kernel" if isinstance(weights.layers, LayerWeights)
                                 else "sharded" if sharded else "per-op")
        self.weights = weights
        self._prefill_w = weights
        self._tp = None
        if tp_mesh is not None:
            self._tp, step = self._shard(tp_mesh, lossless)
            self._tp_step = (fused_decode_q_tp.decode_step_q_tp if lossless
                             else fused_decode_tp.decode_step_tp)
        elif lossless and self.decode_route == "kernel":
            self._prefill_w = prefill_operands(weights)
        self.tokenizer = Tokenizer(gguf.metadata, self.hparams.architecture)
        self.max_seq = max_seq
        self.decode_chunk = decode_chunk
        self._consts = None
        if self._tp is not None:
            self._consts = step.prepare(self.hparams, self._tp, swa_mask=swa_mask_enabled(),
                                        max_seq=max_seq)
        elif self.decode_route != "per-op":
            self._consts = step.prepare(self.hparams, self.device, swa_mask=swa_mask_enabled(),
                                        max_seq=max_seq)

    def _shard(self, mesh, lossless: bool):
        """The tensor-parallel shards of the stacked weights over the mesh's
        'model' axis (engine.py:300-337 of the JAX package), and the step
        module; raises where the route cannot take the checkpoint."""
        n = mesh.shape["model"]
        step = fused_decode_q_tp if lossless else fused_decode_tp
        hp, w = self.hparams, self.weights
        if hp.architecture == "gemma4":
            raise ValueError("tp_mesh: the tensor-parallel step has none of gemma4's features "
                             "(per-layer inputs, shared KV); serve gemma4 on one device")
        supported = step.tp_decode_q_supported if lossless else step.tp_decode_supported
        if self.decode_route != "kernel" or not supported(hp, w, n):
            what = "group-scaled" if lossless else "rowq8"
            raise ValueError(
                f"checkpoint/geometry not eligible for the TP {what} step (needs stacked {what} "
                f"layers off the capacity route and clean head/vocab/ffn splits over {n} "
                "devices)")
        self.decode_route = "tp"
        return step.shard_for_tp(hp, w, n, mesh.model_devices), step

    def _capacity_load(self, gguf: GGUFFile, hp, *, q4: bool, max_seq: int):
        """The capacity decision and load (llm_inference_tpu/engine.py:129-195):
        (hparams, stacked weights) when the capacity route takes the
        checkpoint, else None, with nothing left on the device."""
        if layer_bytes_estimate(gguf, q4=q4) is None:
            return None
        geom = fused_decode_stream.directory_geometry(gguf, hp, q4=q4, layers=1)
        fits = geom is not None and fused_decode_q.whole_step_fits(hp, **geom)
        if fits and os.environ.get("LLMI_FORCE_CAPACITY", "0") != "1":
            return None
        if not fused_decode_stream.stream_supported_from_directory(gguf, hp, q4=q4,
                                                                   max_seq=max_seq):
            return None
        res = load_capacity_stacked(gguf, hp, q4=q4, device=self.device)
        if res is not None and fused_decode_stream.decode_stream_supported(*res, max_seq=max_seq):
            return res
        del res  # free the capacity weights before the standard load
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return None

    def new_cache(self) -> KVCache:
        """bf16 caches; parity keeps the reference's f16 stores."""
        return init_cache(self.hparams, self.max_seq, device=self.device,
                          dtype=PARITY_KV_DTYPE if self.exact else KV_DTYPE,
                          flat=self.decode_route == "capacity", sharding=self._cache_sharding)

    def _replicas(self, cache: KVCache) -> list:
        """Rank r's K/V cache replica on its device (replica 0 ``cache``)."""
        return [cache] + [KVCache(k=cache.k.to(d, copy=True), v=cache.v.to(d, copy=True))
                          for d in self._tp.devices[1:]]

    def generate(self, prompt: str, *, n_predict: int = 100, apply_chat_template: bool = True,
                 on_token: Optional[Callable[[int], None]] = None,
                 stats: Optional[GenerationStats] = None) -> list[int]:
        """Generation (reference main.cpp:160-234; greedy by default).
        Returns generated token ids (stop token excluded). ``on_token``
        streams each id."""
        enc = self.tokenizer.encode(prompt, apply_chat_template)
        return self.generate_from_ids(enc.ids, n_predict=n_predict, on_token=on_token,
                                      stats=stats)

    def _decode_chunk(self, cache: KVCache, token: int, pos: int) -> np.ndarray:
        """``decode_chunk`` steps from ``token`` at ``pos``; the ids stay on
        the device until the chunk's one host copy."""
        n = self.decode_chunk
        toks = torch.empty(n + 1, dtype=torch.int64, device=self.device)
        toks[0] = token
        positions = torch.arange(pos, pos + n, dtype=torch.int32, device=self.device)
        keys = [None] * n
        if not self.sampling.is_greedy:  # step i's key: its input position + 1
            keys = random.to_device(random.fold_in(self._base_key, np.arange(pos + 1, pos + n + 1)),
                                    self.device)
        for i in range(n):
            if self._tp is not None:
                logits = softcap(self._tp_step(self.hparams, self._tp, cache, toks[i : i + 1],
                                               positions[i : i + 1], self._consts),
                                 self.hparams.final_logit_softcap)
            else:
                logits, cache = forward(self.hparams, self.weights, cache, toks[i : i + 1],
                                        positions[i : i + 1], consts=self._consts,
                                        exact=self.exact)
            toks[i + 1] = sample(logits, self.sampling, keys[i])
        return toks[1:].cpu().numpy()

    def generate_from_ids(self, prompt_ids: list[int], *, n_predict: int = 100,
                          on_token: Optional[Callable[[int], None]] = None,
                          stats: Optional[GenerationStats] = None) -> list[int]:
        if len(prompt_ids) + n_predict + self.decode_chunk > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt_ids)}) + n_predict ({n_predict}) + chunk margin "
                f"exceeds max_seq {self.max_seq}")
        vocab = self.weights.token_embd.rows
        if not prompt_ids or any(not 0 <= t < vocab for t in prompt_ids):
            # an out-of-range id would index past the embedding on the device
            raise ValueError(f"prompt ids must be a non-empty list in [0, {vocab})")
        t0 = time.perf_counter()
        bucket = prefill_bucket(len(prompt_ids))
        padded = torch.zeros(bucket, dtype=torch.int64)
        padded[: len(prompt_ids)] = torch.tensor(prompt_ids, dtype=torch.int64)
        key = None
        if not self.sampling.is_greedy:  # the prefill's key: the prompt's length
            key = random.to_device(random.fold_in(self._base_key, len(prompt_ids)), self.device)
        cache = self.new_cache()
        first_logits, cache = forward(self.hparams, self._prefill_w, cache,
                                      padded.to(self.device), 0, len(prompt_ids),
                                      exact=self.exact)
        if self._tp is not None:
            cache = self._replicas(cache)
        first_id = int(sample(first_logits, self.sampling, key))
        if stats is not None:
            stats.first_logits = first_logits
        t1 = time.perf_counter()

        out: list[int] = []
        device_steps = 0
        pos = len(prompt_ids)
        pending = first_id
        done = self.tokenizer.is_stop(first_id)
        while not done and len(out) < n_predict:
            out.append(pending)
            if on_token:
                on_token(pending)
            if len(out) >= n_predict:
                break
            toks = self._decode_chunk(cache, pending, pos)
            device_steps += self.decode_chunk
            pos += self.decode_chunk
            for tid in toks[:-1]:
                tid = int(tid)
                if self.tokenizer.is_stop(tid) or len(out) >= n_predict:
                    done = True
                    break
                out.append(tid)
                if on_token:
                    on_token(tid)
            else:
                pending = int(toks[-1])
                done = self.tokenizer.is_stop(pending)
                continue
            break
        t2 = time.perf_counter()

        if stats is not None:
            stats.prompt_tokens = len(prompt_ids)
            stats.generated_tokens = len(out)
            stats.prefill_seconds = t1 - t0
            stats.decode_seconds = t2 - t1
            stats.decode_steps = device_steps
        return out

    def generate_text(self, prompt: str, **kw) -> str:
        """Generate and decode to display text."""
        return self.tokenizer.decode(self.generate(prompt, **kw))
