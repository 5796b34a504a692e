"""Batched serving: slot-based continuous batching over dense lanes or a paged pool.

Counterpart of llm_inference_tpu/serving.py for the engine's five modes
(engine.py; ``serve`` the default): ``max_batch`` slots, each a lane of one
stacked batched cache ``[L, max_batch, max_seq, Hkv, d]`` (models/gemma.py
``BatchedKVCache``) or, with ``kv_pages``, of a shared pool of ``kv_pages``
pages of ``PAGE`` slots a layer (``PagedKVCache``), so K/V memory follows
the live tokens rather than ``max_batch x max_seq``.

  - Prefill runs with ``mm_impl="xla"`` (W8A8 projections on CUDA in
    serve-q8; the dequantized bf16 product in serve, serve-q and serve-q4,
    as the JAX server; the exact contract in parity). Requests are admitted
    in same-bucket groups, in queue order (serving.py:625-757). In a serve
    mode every group, a request alone included, takes one pass over all its
    G x bucket rows (models/gemma.py ``forward_prefill_group``, the JAX
    server's vmapped ``_prefill_group`` / ``_prefill_paged_group``,
    serving.py:179-193, :483-540): each weight streams once for the group,
    and each member's bucket rows then go from the group's scratch cache
    into its lane with one indexed copy a stacked tensor (a KV layer's,
    under per-layer head dims), or into its pages with one copy a pool (a
    sliding-window ring layer takes only each member's live window's
    blocks, at ring row ``slot * ring + j % ring``). G is not padded: eager
    PyTorch compiles nothing, where the JAX padding to a power of two lets
    one jit shape serve; for the same reason a group of one needs no lone
    path of its own (the JAX server's, serving.py:717-733), and the pass at
    G = 1 computes the single-stream ``forward``'s numbers bit for bit.
    Parity groups (dense only) prefill member by member through the exact
    single-stream ``forward`` into each lane in place. A group pass that
    fails fails the admission; nothing falls back to prefilling member by
    member. The first ids are one ``pick_batch`` over the group's logits
    under each member's key.
  - Paged admission (serving.py:594-711): a request takes
    ceil((prompt + n_predict + decode_chunk) / PAGE) pages and its table row
    maps them; ``submit`` refuses one that needs more pages than the pool
    holds; a queue head the free pages cannot hold yet blocks the queue
    (FIFO: nothing skips ahead of it). Retirement frees the pages and resets
    the table row to the sentinel ``kv_pages``.
  - Decode runs ``decode_chunk`` steps per host sync. Parked slots sit at
    pos = max_seq; their outputs are ignored. The routes follow the JAX
    server's rule (serving.py:250-274, :354-381):
      * dense kernel route: serve-q8, greedy, no sharding, no real sliding
        window (``swa_active``), LLMI_NO_FUSED_DECODE unset, and the batched
        whole-step kernel eligible (``fused_decode_batch.batch_supported``):
        one batched whole-step call a step with the argmax in the kernel;
      * dense per-op route otherwise: ``forward_batched_decode`` then
        ``pick_batch`` a step (``insert_kv_rows`` and ``flash_decode`` inside),
        serve's one route for dense lanes; under ``sharding_fn`` or
        ``cache_sharding`` the same step over sharded weights and lanes
        split over the mesh, once a data row ("sharded"; below);
      * paged per-op route, the default with ``kv_pages`` ("paged-sharded"
        with ``sharding_fn``: whole pools, sharded weights):
        ``forward_batched_decode_paged`` (``insert_kv_rows`` and
        ``paged_flash_decode`` inside), its key blocks bounded by ``nb_cap``,
        the deepest lane's blocks at the chunk's end rounded up to a power of
        two (``LLMI_PAGED_NBCAP=0`` walks the whole table);
      * paged kernel route, opt-in as in the JAX package
        (``LLMI_PAGED_MEGAKERNEL=1``): the dense kernel route's conditions,
        no ring layers, and the paged step eligible
        (``fused_decode_batch_paged.batch_paged_supported``). Its pools get
        one more row, the trash page ``kv_pages`` that the table's sentinel
        then names, which parked lanes write; the per-op route's pools have
        ``kv_pages`` rows, where the sentinel drops.
    The JAX server also needs a TPU for its kernel routes; here a route is
    the same on every device, and on the CPU each kernel runs its plain twin.
  - Requests join and retire at chunk boundaries. A freed slot's stale
    cache (or a freed page) needs no scrubbing: the next occupant's causal
    mask reaches only positions its own prefill rewrote (row 0 included,
    which the dense kernel route's parked lanes overwrite), and the kernels
    read a lane's slots up to its position only.

``PAGE`` comes from ``LLMI_PAGE`` (default 256), read when a paged server is
built and checked: a positive multiple of 16 that divides ``max_seq``. (The
JAX package reads it once at import, unchecked, serving.py:47.) The JAX
package's ``LLMI_PAGED_UNROLL`` probes XLA's buffer assignment of its
``lax.scan`` decode loop; eager PyTorch has no such loop, so it is ignored.

gemma4 runs on the per-op routes, dense and paged, as in the JAX package
(the batched whole steps refuse it, fused_decode_batch.py:94): its layers
stay unstacked, a shared-KV layer reads its source layer's lane or pages
and writes none, and only the ``hp.n_kv_layers`` owner layers have a cache
or a pool, plain ones with no sliding-window rings (serving.py:328-330).

Per-layer head dims (sliding heads narrower than global ones) run on the
per-op routes, dense and paged, as in the JAX package (the batched whole
steps refuse them): each KV layer's lanes, pools and sliding-window rings
at that layer's widths (models/gemma.py ``init_batched_cache``,
``init_paged_cache``; serving.py:383-414), and under ``sharding_fn`` /
``cache_sharding`` each rank's lanes of its KV heads at each layer's widths
(serving.py:575-590; the paged server keeps its whole pools).

``parity`` (serving.py:81-114, :201-217 of the JAX package) is greedy by
contract (a stochastic sampler raises ``ValueError``) and serves dense lanes
only (``kv_pages`` raises ``ValueError``), over unfused weights and f16
lanes: each active lane decodes through the exact single-sequence
``forward`` on its lane of the cache (``BatchedKVCache.lane``), with f32
scores, as the JAX server vmaps that forward (f64 scores do not survive its
vmap); its caches never reach ``insert_kv_rows``, which writes bf16 pools.
Its ``decode_route`` is "per-op".

Sampling (``sampling``, ``seed``) is greedy by default. A stochastic
``SamplingConfig`` draws each lane with the JAX server's keys
(serving.py:113-140 of the JAX package): ``fold_in(fold_in(PRNGKey(seed),
slot), n_prompt)`` at the prefill and ``fold_in(fold_in(PRNGKey(seed),
slot), p)`` at a decode step whose input position is ``p`` (the Engine's
steps fold in ``p + 1``). A chunk's ``[max_batch, decode_chunk]`` keys are
computed on the host and copied once; each step draws all lanes in one
batched call over the ``[B, vocab]`` logits, so a stochastic server takes
the per-op routes (the kernel routes' argmax is in the kernel, serving.py:252,
:357).

Sharded (``sharding_fn``, ``cache_sharding``; the JAX server's
serving.py:84-85, :155, :578-586): ``sharding_fn`` (parallel/sharding.py
``gemma_sharding_fn``) splits the matmul weights over the 'model' ranks of
its mesh, as in the Engine, and ``cache_sharding``
(``batched_kv_cache_sharding``) splits the dense lanes: data row d of the
mesh owns lanes [d B/D, (d+1) B/D) (``max_batch % D`` raises) and each
row's KV heads split over its ranks where they divide
(models/gemma.py ``LaneRows``). Each data row holds its own placement of
the weights (a device it shares with another row holds them once); a
request prefills on its lane's row (a group: one pass a data row over the
members whose lanes it owns, each rank's lanes taking its KV heads of the
group's scratch), and each decode step runs
``forward_batched_decode`` once a row over the row's lanes, each rank's
K/V append and attention (``insert_kv_rows``, ``flash_decode``) on its
shard, the logits meeting on the server's device for one sampling call.
Paged pools are never sharded (the JAX server applies ``cache_sharding``
to dense lanes only): with ``kv_pages`` the weights shard and the lanes
run on the first data row. As in the JAX server no batched whole step runs
under ``sharding_fn`` (serving.py:250-253, :355-359), nor, here, over
split dense lanes. ``decode_route`` is then "sharded" or "paged-sharded";
lane keys and sampling are unchanged. The server runs in one process.

The server runs on ``device="cuda"`` unless the caller asks for the CPU and
raises without a GPU; with a sharding, on the first device of the mesh's
first data row.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import random
from .engine import LOAD_MODE, prefill_bucket, resolve_device, sharding_mesh
from .gguf.reader import GGUFFile
from .models.gemma import (KV_DTYPE, PARITY_KV_DTYPE, LaneRows, ShardedKVCache, forward,
                           forward_batched_decode, forward_batched_decode_paged,
                           forward_prefill_group, init_batched_cache,
                           init_paged_cache, ring_pages, swa_active)
from .models.hparams import load_hparams
from .models.weights import (fuse_projections, layers_stackable, load_weights, place_weights,
                             stack_layers)
from .ops.kernels import fused_decode_batch, fused_decode_batch_paged
from .sampling import SamplingConfig, pick_batch
from .tokenizer import Tokenizer

DEFAULT_PAGE = 256  # the JAX package's LLMI_PAGE default (its flash block)


def page_size(max_seq: int) -> int:
    """The paged server's page (``LLMI_PAGE``, default 256): a positive
    multiple of 16 (the TPU paged step's writeback window, a rule the port
    keeps) that divides ``max_seq``; anything else raises ``ValueError``."""
    raw = os.environ.get("LLMI_PAGE", str(DEFAULT_PAGE))
    try:
        page = int(raw)
    except ValueError:
        page = 0
    if page <= 0 or page % 16 or max_seq % page:
        raise ValueError(f"LLMI_PAGE={raw!r}: the page must be a positive multiple of 16 that "
                         f"divides max_seq {max_seq}")
    return page


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
    pages: list[int] = dataclasses.field(default_factory=list)  # paged mode
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
        mode: str = "serve",
        decode_chunk: int = 8,
        max_admit_per_step: int = 2,
        sharding_fn=None,
        cache_sharding=None,
        kv_pages: Optional[int] = None,
        sampling: SamplingConfig | None = None,
        seed: int = 0,
        device="cuda",
    ):
        self.exact = mode == "parity"
        self.sampling = sampling or SamplingConfig()
        if self.exact and not self.sampling.is_greedy:
            raise ValueError("parity mode is greedy by contract")
        if kv_pages is not None and self.exact:
            raise ValueError("paged KV serving is a serve-mode feature")
        if mode not in LOAD_MODE:
            raise ValueError(f"unknown server mode {mode!r}; supported: {sorted(LOAD_MODE)}")
        if kv_pages is not None and kv_pages < 1:
            raise ValueError(f"kv_pages must be positive, got {kv_pages}")
        self.page = page_size(max_seq) if kv_pages is not None else None
        self.seed = seed
        # lane b's key, fold_in(PRNGKey(seed), b); a step folds in its position
        self._lane_keys = random.fold_in(random.PRNGKey(seed), np.arange(max_batch))
        mesh = sharding_mesh(sharding_fn, cache_sharding)
        if mesh is not None and mesh.processes is not None:
            raise ValueError("BatchedServer runs in one process; over a mesh of several "
                             "(parallel.distributed.global_mesh) drive forward_batched_decode "
                             "on each process's data row")
        if kv_pages is not None:
            cache_sharding = None  # pools stay whole (serving.py:578-586 of the JAX package)
        self._sharded = sharding_fn is not None or cache_sharding is not None
        self._mesh = mesh
        if mesh is not None:
            device = mesh.home(mesh.local_rows()[0])
        self.device = resolve_device(device)
        if isinstance(gguf, str):
            gguf = GGUFFile(gguf)
        hp = load_hparams(gguf.metadata)
        self.mode = mode
        self.hparams, weights = load_weights(gguf, hp, mode=LOAD_MODE[mode], device=self.device,
                                             sharding_fn=sharding_fn)
        if not self.exact:  # parity keeps a tap on every projection, unstacked
            weights = fuse_projections(weights)
        if (not self.exact and not self._sharded
                and layers_stackable(self.hparams, weights.layers)):
            # one stacked copy serves the prefill layer loop and both decode routes
            weights = dataclasses.replace(weights, layers=stack_layers(weights.layers))
        self.weights = weights
        self.tokenizer = Tokenizer(gguf.metadata, self.hparams.architecture)
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.decode_chunk = decode_chunk
        self.max_admit_per_step = max_admit_per_step
        self.kv_pages = kv_pages
        # the whole-step kernels are serve-q8-only and greedy (serving.py:250-252)
        kernel_ok = (mode == "serve-q8" and self.sampling.is_greedy and not self._sharded
                     and not swa_active(self.hparams)
                     and os.environ.get("LLMI_NO_FUSED_DECODE", "0") != "1")
        # each data row's weights (one row unless the dense lanes split over rows)
        self._row_weights = [weights]
        if kv_pages is None:
            self.use_kernel = kernel_ok and fused_decode_batch.batch_supported(
                self.hparams, weights, batch=max_batch, max_seq=max_seq)
            self._caches = init_batched_cache(
                self.hparams, max_batch, max_seq, device=self.device,
                dtype=PARITY_KV_DTYPE if self.exact else KV_DTYPE, sharding=cache_sharding)
            if isinstance(self._caches, LaneRows):
                self._row_weights = [weights if d == 0 else place_weights(weights, mesh, d)
                                     for d in range(len(self._caches.rows))]
        else:
            nb = max_seq // self.page
            self._rings = ring_pages(self.hparams, self.page)
            self.use_kernel = (kernel_ok and not self._rings
                               and os.environ.get("LLMI_PAGED_MEGAKERNEL", "0") == "1"
                               and fused_decode_batch_paged.batch_paged_supported(
                                   self.hparams, weights, batch=max_batch, nb=nb,
                                   page=self.page))
            # the kernel route's pools carry the trash page: row kv_pages
            self._caches = init_paged_cache(self.hparams, kv_pages + int(self.use_kernel),
                                            self.page, rings=self._rings, max_batch=max_batch,
                                            device=self.device)
            self._table = np.full((max_batch, nb), kv_pages, dtype=np.int32)
            self._free_pages: list[int] = list(range(kv_pages))
        self._consts = (fused_decode_batch.prepare_batch(self.hparams, self.device,
                                                         batch=max_batch, max_seq=max_seq)
                        if self.use_kernel else None)
        self.stats = ServerStats()
        self._free: list[int] = list(range(max_batch))
        self._active: dict[int, Request] = {}
        self._queue: list[Request] = []
        self._uid = 0

    @property
    def paged(self) -> bool:
        return self.kv_pages is not None

    @property
    def decode_route(self) -> str:
        route = "kernel" if self.use_kernel else "sharded" if self._sharded else "per-op"
        return f"paged-{route}" if self.paged else route

    def _row_of(self, slot: int) -> int:
        """The data row that owns lane ``slot``."""
        return slot // self._caches.lanes if isinstance(self._caches, LaneRows) else 0

    def _home(self, row: int) -> torch.device:
        """Where data row ``row``'s activations live."""
        return self.device if self._mesh is None else self._mesh.home(row)

    def _pages_needed(self, n_prompt: int, n_predict: int) -> int:
        return -(-(n_prompt + n_predict + self.decode_chunk) // self.page)

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
        # a request needing more pages than the pool holds could never be
        # admitted and would block the queue behind it forever
        if self.paged and self._pages_needed(len(prompt_ids), n_predict) > self.kv_pages:
            raise ValueError(
                f"request needs {self._pages_needed(len(prompt_ids), n_predict)} KV pages "
                f"({need} tokens at {self.page} a page) but the pool only has {self.kv_pages}")
        vocab = self.weights.token_embd.rows
        if not prompt_ids or any(not 0 <= t < vocab for t in prompt_ids):
            raise ValueError(f"prompt ids must be a non-empty list in [0, {vocab})")
        self._uid += 1
        req = Request(uid=self._uid, prompt_ids=list(prompt_ids), n_predict=n_predict,
                      on_token=on_token, t_submit=time.perf_counter())
        self._queue.append(req)
        return req

    def _scratch_slots(self, bucket: int) -> int:
        """A paged prefill's scratch slots a request: max(bucket, 16) below
        a page (one partial block), else its bucket in whole pages."""
        return max(bucket, 16) if bucket < self.page else -(-bucket // self.page) * self.page

    def _prefill(self, req: Request, slot: int, bucket: int) -> torch.Tensor:
        """Prefill ``req`` into lane ``slot`` in place under the parity
        contract (parity servers are dense); returns its first id
        (device)."""
        padded = torch.zeros(bucket, dtype=torch.int64)
        padded[: len(req.prompt_ids)] = torch.tensor(req.prompt_ids, dtype=torch.int64)
        n_valid = len(req.prompt_ids)
        row = self._row_of(slot)
        logits, _ = forward(self.hparams, self._row_weights[row], self._caches.lane(slot),
                            padded.to(self._home(row)), 0, n_valid, mm_impl="xla", exact=True)
        return pick_batch(logits.to(self.device)[None], self.sampling, None)[0]

    def _prefill_group(self, group: list[Request], slots: list[int], bucket: int) -> np.ndarray:
        """Prefill a serve-mode group into its lanes (or its members'
        pages): one ``forward_prefill_group`` pass a data row over
        the members whose lanes that row owns (the whole group but under
        split dense lanes), on the row's weights and device, then one
        ``pick_batch`` over the group's logits. Returns the first ids [G]
        (host), in group order."""
        G = len(group)
        n_valids = [len(req.prompt_ids) for req in group]
        tokens = torch.zeros((G, bucket), dtype=torch.int64)
        for g, req in enumerate(group):
            tokens[g, : n_valids[g]] = torch.tensor(req.prompt_ids, dtype=torch.int64)
        keys = self._keys(slots, [[n] for n in n_valids])
        rows: dict[int, list[int]] = {}
        for g, slot in enumerate(slots):
            rows.setdefault(self._row_of(slot), []).append(g)
        logits = torch.empty((G, self.weights.token_embd.rows), device=self.device)
        for row, members in rows.items():
            row_logits, scratch = forward_prefill_group(
                self.hparams, self._row_weights[row], tokens[members].to(self._home(row)),
                [n_valids[g] for g in members],
                cache_len=self._scratch_slots(bucket) if self.paged else None)
            row_slots = [slots[g] for g in members]
            if self.paged:
                self._scatter_pages(scratch, [group[g] for g in members], row_slots, bucket)
            else:
                self._copy_lanes(scratch, row, row_slots, bucket)
            logits[torch.as_tensor(members, device=self.device)] = row_logits.to(self.device)
        return pick_batch(logits, self.sampling,
                          None if keys is None else keys[:, 0]).cpu().numpy()

    def _copy_lanes(self, scratch, row: int, slots: list[int], bucket: int) -> None:
        """Each member's bucket rows of a group's scratch (lane g of it) into
        dense lane ``slots[g]`` of data row ``row``: one indexed copy a
        stacked tensor (a KV layer's under per-layer head dims); on a
        heads-split row each rank's lanes take its KV heads. Rows past a
        member's prompt carry the padding's K/V, which decode overwrites
        before any read."""
        caches = self._caches
        lanes = slots
        if isinstance(caches, LaneRows):
            lanes = [s - row * caches.lanes for s in slots]
            caches = caches.rows[row]
        shards = caches.shards if isinstance(caches, ShardedKVCache) else [caches]
        for r, c in enumerate(shards):
            if c is None:
                continue
            idx = torch.as_tensor(lanes, device=c.k[0].device)
            for dst, src in ((c.k, scratch.k), (c.v, scratch.v)):
                # [L, B, S, Hkv, d] stacked, or one [B, S, Hkv, d_i] a KV layer
                for d, s in ([(dst, src)] if torch.is_tensor(dst) else zip(dst, src)):
                    hk = d.shape[-2]
                    d[..., idx, :bucket, :, :] = s[..., :bucket, r * hk:(r + 1) * hk, :].to(
                        d.device)

    def _scatter_pages(self, scratch, group: list[Request], slots: list[int],
                       bucket: int) -> None:
        """A group's scratch rows (lane g of it: ``group[g]``'s) into its
        requests' pages, one copy a pool (a stacked pair when the pools are
        one tensor): block j into page ``pages[j]`` (blocks past the
        request's pages are dropped), or on a ring layer into ring row
        ``slot * ring + j % ring`` for the live window's blocks only (the
        others would alias live ring rows and are masked anyway). A bucket
        below a page is one block: its rows [0, bucket) alone are copied.
        Page rows past a prompt hold the scratch's zeros or the padding's
        K/V and are never read before decode writes them."""
        page, pools = self.page, self._caches
        nbk = -(-bucket // page)
        n = min(bucket, page)  # rows copied a block
        dev = pools.k[0].device
        plain = [(g * nbk + j, req.pages[j]) for g, req in enumerate(group)
                 for j in range(min(nbk, len(req.pages)))]

        def blocks(t):  # [..., G, S, Hkv, d] -> [..., G * nbk, S / nbk, Hkv, d]
            return t.reshape(*t.shape[:-4], len(group) * nbk, -1, *t.shape[-2:])

        def index(pairs):
            src, dst = zip(*pairs) if pairs else ((), ())
            return (torch.as_tensor(src, dtype=torch.int64, device=dev),
                    torch.as_tensor(dst, dtype=torch.int64, device=dev))

        if pools.k_all is not None:
            src, dst = index(plain)
            pools.k_all[:, dst, :n] = blocks(scratch.k)[:, src, :n]
            pools.v_all[:, dst, :n] = blocks(scratch.v)[:, src, :n]
            return
        ids = {0: index(plain)}
        for i in range(len(pools.k)):
            r = self._rings.get(i, 0)
            if r not in ids:
                live = []
                for g, (req, slot) in enumerate(zip(group, slots)):
                    last_blk = max(len(req.prompt_ids) - 1, 0) // page
                    live += [(g * nbk + j, slot * r + j % r)
                             for j in range(max(0, last_blk - r + 1), min(nbk, last_blk + 1))]
                ids[r] = index(live)
            src, dst = ids[r]
            pools.k[i][dst, :n] = blocks(scratch.k[i])[src, :n]
            pools.v[i][dst, :n] = blocks(scratch.v[i])[src, :n]

    def _admit(self) -> None:
        """Prefill queued requests into free slots (between decode chunks).

        At most ``max_admit_per_step`` prefills run per scheduler iteration
        once requests are already decoding; an idle server admits as many as
        fit. Requests are admitted in same-bucket groups, in queue order: a
        serve-mode group in one ``_prefill_group`` pass, a parity group
        member by member through ``_prefill``."""
        budget = len(self._free) if not self._active else self.max_admit_per_step
        t0 = time.perf_counter()
        admitted = False
        while self._queue and self._free and budget > 0:
            bucket = prefill_bucket(len(self._queue[0].prompt_ids))
            group: list[Request] = []
            pages_left = len(self._free_pages) if self.paged else 0
            while (self._queue and len(group) < len(self._free) and budget > 0
                   and prefill_bucket(len(self._queue[0].prompt_ids)) == bucket):
                head = self._queue[0]
                if self.paged:
                    need = self._pages_needed(len(head.prompt_ids), head.n_predict)
                    if need > pages_left:
                        break  # the pool cannot hold the head yet: wait for retirements
                    pages_left -= need
                group.append(self._queue.pop(0))
                budget -= 1
            if not group:
                break
            slots = [self._free.pop(0) for _ in group]
            if self.paged:
                for req, slot in zip(group, slots):
                    need = self._pages_needed(len(req.prompt_ids), req.n_predict)
                    req.pages = [self._free_pages.pop(0) for _ in range(need)]
                    self._table[slot, :] = self.kv_pages
                    self._table[slot, :need] = req.pages
            if self.exact:
                firsts = torch.stack([self._prefill(req, slot, bucket)
                                      for req, slot in zip(group, slots)]).cpu().numpy()
            else:
                firsts = self._prefill_group(group, slots, bucket)
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

    def _nb_cap(self) -> int | None:
        """The paged per-op step's key-block bound (serving.py:797-807): the
        deepest lane's blocks at the chunk's end, rounded up to a power of
        two (a cap under a lane's live depth would truncate its attention),
        at most the table's blocks; None (the whole table) under
        ``LLMI_PAGED_NBCAP=0``."""
        if os.environ.get("LLMI_PAGED_NBCAP", "1") == "0":
            return None
        deepest = max(req.pos for req in self._active.values())
        blocks = -(-(deepest + self.decode_chunk + 1) // self.page)
        return min(self.max_seq // self.page, 1 << max(0, blocks - 1).bit_length())

    def _keys(self, slots, positions):
        """The lane keys ``fold_in(fold_in(base, slot), position)`` of
        ``slots`` [B] at ``positions`` [B, n], on the device in one copy
        ([B, n, 2]); None for a greedy server."""
        if self.sampling.is_greedy:
            return None
        lanes = self._lane_keys[np.asarray(slots)][:, None]
        return random.to_device(random.fold_in(lanes, np.asarray(positions)), self.device)

    def _decode_chunk_exact(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """The parity mode's chunk: each active lane ``decode_chunk`` steps of
        the exact single-sequence ``forward`` on its lane of the cache, with
        f32 scores (serving.py:201-217 of the JAX package vmaps it so);
        parked lanes are skipped, their ids left 0. Returns [max_batch,
        decode_chunk]."""
        n = self.decode_chunk
        out = torch.zeros((self.max_batch, n), dtype=torch.int64, device=self.device)
        for b in np.flatnonzero(pos < self.max_seq):
            cache = self._caches.lane(int(b))
            row = self._row_of(int(b))
            tok = torch.full((1,), int(tokens[b]), dtype=torch.int64, device=self._home(row))
            for i in range(n):
                logits, _ = forward(self.hparams, self._row_weights[row], cache, tok,
                                    int(pos[b]) + i, exact=True, f64_scores=False)
                tok = pick_batch(logits[None], self.sampling).long()
                out[b, i] = tok[0].to(self.device)
        return out.cpu().numpy()

    def dense_step_logits(self, tok: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """One per-op decode step of every dense lane (``tok``, ``p`` [B] on
        the server's device): ``forward_batched_decode`` over the lanes, or
        once a data row over its lanes, the rows' logits [B, V] meeting on
        the server's device. Writes each live lane's K/V row."""
        caches = self._caches
        if not isinstance(caches, LaneRows):
            return forward_batched_decode(self.hparams, self.weights, caches, tok, p)[0]
        B = caches.lanes
        return torch.cat([forward_batched_decode(
            self.hparams, self._row_weights[d], rows, tok[d * B:(d + 1) * B].to(self._home(d)),
            p[d * B:(d + 1) * B].to(self._home(d)))[0].to(self.device)
            for d, rows in enumerate(caches.rows)])

    def _decode_chunk(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """``decode_chunk`` batched steps; the ids stay on the device until
        the chunk's one host copy. Returns [max_batch, decode_chunk]."""
        if self.exact:
            return self._decode_chunk_exact(tokens, pos)
        n = self.decode_chunk
        tok = torch.from_numpy(tokens).to(self.device)
        p = torch.from_numpy(pos).to(self.device)
        out = torch.empty((self.max_batch, n), dtype=torch.int32, device=self.device)
        # step i of lane b draws at its input position pos[b] + i
        keys = self._keys(np.arange(self.max_batch),
                          pos.astype(np.int64)[:, None] + np.arange(n))
        if self.paged:
            table = torch.from_numpy(self._table).to(self.device)
            nb_cap = None if self.use_kernel else self._nb_cap()
        hp, w, caches = self.hparams, self.weights, self._caches
        for i in range(n):
            if self.use_kernel and self.paged:
                nxt = fused_decode_batch_paged.decode_step_batch_paged(
                    hp, w, caches.k_all, caches.v_all, table, tok, p, self._consts, greedy=True)
            elif self.use_kernel:
                nxt = fused_decode_batch.decode_step_batch(hp, w, caches, tok, p, self._consts,
                                                           greedy=True)
            else:
                if self.paged:
                    logits, _ = forward_batched_decode_paged(
                        hp, w, caches, table, tok, p, ring_layers=tuple(self._rings),
                        nb_cap=nb_cap)
                else:
                    logits = self.dense_step_logits(tok, p)
                nxt = pick_batch(logits, self.sampling, None if keys is None else keys[:, i])
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
            self._retire(slot)
        return len(self._active) + len(self._queue)

    def _retire(self, slot: int) -> None:
        """Free lane ``slot`` (and, paged, its request's pages and table row)."""
        req = self._active.pop(slot)
        self._free.append(slot)
        if self.paged:
            self._free_pages.extend(req.pages)
            req.pages = []
            self._table[slot, :] = self.kv_pages

    def run(self, requests: list[tuple[list[int], int]]) -> list[list[int]]:
        """Convenience: continuous-batch (prompt_ids, n_predict) pairs to
        completion; returns generated ids per request, in submit order."""
        reqs = [self.submit(ids, n) for ids, n in requests]
        while self.step():
            pass
        return [r.out for r in reqs]
