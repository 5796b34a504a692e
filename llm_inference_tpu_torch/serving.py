"""Batched serving: slot-based continuous batching over dense lanes.

Counterpart of llm_inference_tpu/serving.py for mode ``serve-q8``, dense
caches: ``max_batch`` slots, each a lane of one stacked batched cache
``[L, max_batch, max_seq, Hkv, d]`` (models/gemma.py ``BatchedKVCache``).

  - Prefill is per request, through the single-stream ``forward`` with
    ``mm_impl="xla"`` (W8A8 projections on CUDA, as the JAX server), into
    the request's lane of the batched cache, in place. A same-bucket
    admission group is prefilled member by member: the JAX server's vmap
    over a group (padded to a power of two so its shapes compile once)
    computes each member's numbers exactly as a lone prefill, because W8A8
    quantizes every token row on its own, so the loop gives the same lanes.
  - Decode runs ``decode_chunk`` steps per host sync. Parked slots sit at
    pos = max_seq; their outputs are ignored. Two routes, chosen as the JAX
    server chooses them (serving.py:250-274):
      * kernel route: serve-q8, greedy, no sharding, no real sliding window
        (``swa_active``), LLMI_NO_FUSED_DECODE unset, and the batched
        whole-step kernel eligible (``fused_decode_batch.batch_supported``):
        one batched whole-step call a step with the argmax in the kernel;
      * per-op route otherwise: ``forward_batched_decode`` then
        ``pick_batch`` a step (``insert_rows`` and ``flash_decode`` inside).
    The JAX server also needs a TPU for the kernel route; here the route is
    the same on every device, and on the CPU each kernel runs its plain twin.
  - Requests join and retire at chunk boundaries. A freed slot's stale
    cache needs no scrubbing: the next occupant's causal mask reaches only
    positions its own prefill rewrote (row 0 included, which the kernel
    route's parked lanes overwrite).

The server runs on ``device="cuda"`` unless the caller asks for the CPU and
raises without a GPU. Paged caches, sharding and stochastic sampling are
later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .engine import _LATER_MODES, prefill_bucket, resolve_device
from .gguf.reader import GGUFFile
from .models.gemma import forward, forward_batched_decode, init_batched_cache, swa_active
from .models.hparams import load_hparams
from .models.weights import fuse_projections, layers_stackable, load_weights, stack_layers
from .ops.kernels import fused_decode_batch
from .sampling import SamplingConfig, pick_batch
from .tokenizer import Tokenizer

# The server's modes still to port: the engine's, and serve-q/serve-q4,
# which the JAX server runs per op over dequantized weights
# (llm_inference_tpu/serving.py:142-158) and which go with the paged slice.
_SERVER_LATER_MODES = {
    **_LATER_MODES,
    "serve-q": "ROADMAP.md queue 1, item 13 (paged slice)",
    "serve-q4": "ROADMAP.md queue 1, item 13 (paged slice)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: list[int]
    n_predict: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable[[int], None]] = None
    # runtime state
    slot: int = -1
    pos: int = 0
    pending: int = -1  # sampled but not yet consumed token
    # timing (perf_counter seconds): submit -> first sampled token
    t_submit: float = 0.0
    t_first: float = 0.0

    @property
    def ttft_s(self) -> float:
        """Time to first token (sampled at prefill), seconds."""
        return max(0.0, self.t_first - self.t_submit)


@dataclasses.dataclass
class ServerStats:
    prefill_seconds: float = 0.0  # host wall time of admissions (prefills + first ids)
    decode_seconds: float = 0.0   # host wall time of decode chunks, each ending in its host copy
    decode_steps: int = 0         # batched device steps run
    tokens_emitted: int = 0       # ids handed to requests by step(), first ids included


class BatchedServer:
    def __init__(
        self,
        gguf: GGUFFile | str,
        *,
        max_seq: int = 2048,
        max_batch: int = 8,
        mode: str = "serve-q8",
        decode_chunk: int = 8,
        max_admit_per_step: int = 2,
        sharding_fn=None,
        cache_sharding=None,
        kv_pages: Optional[int] = None,
        sampling: SamplingConfig | None = None,
        seed: int = 0,
        device="cuda",
    ):
        if mode in _SERVER_LATER_MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported to the server yet: {_SERVER_LATER_MODES[mode]}")
        if mode != "serve-q8":
            raise ValueError(f"unknown server mode {mode!r}; supported: serve-q8")
        if kv_pages is not None:
            raise NotImplementedError("the paged KV cache (kv_pages) is the paged-serving slice "
                                      "(ROADMAP.md queue 1, item 13)")
        if sharding_fn is not None or cache_sharding is not None:
            raise NotImplementedError("sharded weights and caches are the parallel slice "
                                      "(ROADMAP.md queue 1, item 15)")
        self.sampling = sampling or SamplingConfig()
        if not self.sampling.is_greedy:
            pick_batch(torch.zeros((1, 1)), self.sampling)  # raises NotImplementedError
        self.seed = seed  # per-lane sampling keys come with stochastic sampling
        self.device = resolve_device(device)
        if isinstance(gguf, str):
            gguf = GGUFFile(gguf)
        hp = load_hparams(gguf.metadata)
        if hp.architecture != "gemma3":
            raise NotImplementedError(
                f"architecture {hp.architecture!r}: only gemma3 is ported; gemma4 is a "
                "later slice (ROADMAP.md queue 1, item 8)")
        self.mode = mode
        self.hparams, weights = load_weights(gguf, hp, mode="rowq8", device=self.device)
        weights = fuse_projections(weights)
        if layers_stackable(self.hparams, weights.layers):
            # one stacked copy serves the prefill layer loop and both decode routes
            weights = dataclasses.replace(weights, layers=stack_layers(weights.layers))
        self.weights = weights
        self.tokenizer = Tokenizer(gguf.metadata, self.hparams.architecture)
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.decode_chunk = decode_chunk
        self.max_admit_per_step = max_admit_per_step
        self.use_kernel = (
            not swa_active(self.hparams)
            and os.environ.get("LLMI_NO_FUSED_DECODE", "0") != "1"
            and fused_decode_batch.batch_supported(self.hparams, weights, batch=max_batch,
                                                   max_seq=max_seq))
        self._consts = (fused_decode_batch.prepare_batch(self.hparams, self.device,
                                                         batch=max_batch, max_seq=max_seq)
                        if self.use_kernel else None)
        self._caches = init_batched_cache(self.hparams, max_batch, max_seq, device=self.device)
        self.stats = ServerStats()
        self._free: list[int] = list(range(max_batch))
        self._active: dict[int, Request] = {}
        self._queue: list[Request] = []
        self._uid = 0

    @property
    def decode_route(self) -> str:
        return "kernel" if self.use_kernel else "per-op"

    # -- request lifecycle ----------------------------------------------------

    def submit(self, prompt_ids: list[int], n_predict: int = 100,
               on_token: Optional[Callable[[int], None]] = None) -> Request:
        """Queue a request; it joins the batch at the next step()."""
        # anything that could overrun the preallocated cache is refused here:
        # an out-of-range write would drop and the request emit garbage
        need = len(prompt_ids) + n_predict + self.decode_chunk
        if prefill_bucket(len(prompt_ids)) > self.max_seq or need > self.max_seq:
            raise ValueError(
                f"request needs {need} cache slots (prompt {len(prompt_ids)} + "
                f"n_predict {n_predict} + chunk {self.decode_chunk}, prefill "
                f"bucket {prefill_bucket(len(prompt_ids))}) but max_seq is {self.max_seq}")
        vocab = self.weights.token_embd.rows
        if not prompt_ids or any(not 0 <= t < vocab for t in prompt_ids):
            raise ValueError(f"prompt ids must be a non-empty list in [0, {vocab})")
        self._uid += 1
        req = Request(uid=self._uid, prompt_ids=list(prompt_ids), n_predict=n_predict,
                      on_token=on_token, t_submit=time.perf_counter())
        self._queue.append(req)
        return req

    def _prefill(self, req: Request, slot: int, bucket: int) -> torch.Tensor:
        """Prefill ``req`` into lane ``slot``; returns its first id (device)."""
        padded = torch.zeros(bucket, dtype=torch.int64)
        padded[: len(req.prompt_ids)] = torch.tensor(req.prompt_ids, dtype=torch.int64)
        logits, _ = forward(self.hparams, self.weights, self._caches.lane(slot),
                            padded.to(self.device), 0, len(req.prompt_ids), mm_impl="xla")
        return pick_batch(logits[None], self.sampling)[0]

    def _admit(self) -> None:
        """Prefill queued requests into free slots (between decode chunks).

        At most ``max_admit_per_step`` prefills run per scheduler iteration
        once requests are already decoding; an idle server admits as many as
        fit. Requests are admitted in same-bucket groups, in queue order."""
        budget = len(self._free) if not self._active else self.max_admit_per_step
        t0 = time.perf_counter()
        admitted = False
        while self._queue and self._free and budget > 0:
            bucket = prefill_bucket(len(self._queue[0].prompt_ids))
            group: list[Request] = []
            while (self._queue and len(group) < len(self._free) and budget > 0
                   and prefill_bucket(len(self._queue[0].prompt_ids)) == bucket):
                group.append(self._queue.pop(0))
                budget -= 1
            slots = [self._free.pop(0) for _ in group]
            firsts = torch.stack([self._prefill(req, slot, bucket)
                                  for req, slot in zip(group, slots)]).cpu().numpy()
            for req, slot, tok in zip(group, slots, firsts):
                self._activate(req, slot, int(tok))
            admitted = True
        if admitted:
            self.stats.prefill_seconds += time.perf_counter() - t0

    def _activate(self, req: Request, slot: int, first_tok: int) -> None:
        req.slot = slot
        req.pos = len(req.prompt_ids)
        req.pending = first_tok
        req.t_first = time.perf_counter()
        self._active[slot] = req

    def _emit(self, req: Request, tid: int) -> bool:
        """Record one token; True when the request just finished."""
        if self.tokenizer.is_stop(tid) or len(req.out) >= req.n_predict:
            req.done = True
            return True
        req.out.append(tid)
        self.stats.tokens_emitted += 1
        if req.on_token:
            req.on_token(tid)
        if len(req.out) >= req.n_predict:
            req.done = True
            return True
        return False

    # -- engine loop ------------------------------------------------------------

    def _decode_chunk(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """``decode_chunk`` batched steps; the ids stay on the device until
        the chunk's one host copy. Returns [max_batch, decode_chunk]."""
        n = self.decode_chunk
        tok = torch.from_numpy(tokens).to(self.device)
        p = torch.from_numpy(pos).to(self.device)
        out = torch.empty((self.max_batch, n), dtype=torch.int32, device=self.device)
        for i in range(n):
            if self.use_kernel:
                nxt = fused_decode_batch.decode_step_batch(
                    self.hparams, self.weights, self._caches, tok, p, self._consts, greedy=True)
            else:
                logits, _ = forward_batched_decode(self.hparams, self.weights, self._caches,
                                                   tok, p)
                nxt = pick_batch(logits, self.sampling)
            out[:, i] = nxt
            tok = nxt
            p = p + 1
        return out.cpu().numpy()

    def step(self) -> int:
        """One scheduler iteration: admit + one batched decode chunk.
        Returns the number of requests still in flight."""
        self._admit()
        if not self._active:
            return len(self._queue)

        tokens = np.zeros(self.max_batch, dtype=np.int32)
        pos = np.full(self.max_batch, self.max_seq, dtype=np.int32)  # parked
        for slot, req in self._active.items():
            tokens[slot] = req.pending
            pos[slot] = req.pos
        t0 = time.perf_counter()
        toks = self._decode_chunk(tokens, pos)
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_steps += self.decode_chunk

        finished = []
        for slot, req in self._active.items():
            if self._emit(req, req.pending):
                finished.append(slot)
                continue
            req.pos += self.decode_chunk
            stopped = False
            for tid in toks[slot, :-1]:
                if self._emit(req, int(tid)):
                    finished.append(slot)
                    stopped = True
                    break
            if not stopped:
                req.pending = int(toks[slot, -1])
        for slot in finished:
            self._active.pop(slot)
            self._free.append(slot)
        return len(self._active) + len(self._queue)

    def run(self, requests: list[tuple[list[int], int]]) -> list[list[int]]:
        """Convenience: continuous-batch (prompt_ids, n_predict) pairs to
        completion; returns generated ids per request, in submit order."""
        reqs = [self.submit(ids, n) for ids, n in requests]
        while self.step():
            pass
        return [r.out for r in reqs]
