#!/usr/bin/env python3
"""Per-kernel roofline report of the PyTorch port's decode step on a CUDA
GPU (counterpart of tools/roofline.py, which traces the JAX package):

    python tools/torch_roofline.py [--mode serve-q8] [--max-seq 1024] [--chunks 2]
    python tools/torch_roofline.py --per-op --chunks 1
    python tools/torch_roofline.py --batch 4 [--paged [N]]
    python tools/torch_roofline.py -m model.gguf --device cpu --max-seq 128

``torch.profiler`` traces whole decode chunks of the ``Engine``'s own route
(``--per-op``: under ``LLMI_NO_FUSED_DECODE=1``; ``--batch B``: a
``BatchedServer`` of B lanes, dense or ``--paged`` out of N pages), after
one chunk that is not traced and a timed run of the same chunks that is not
traced either. The report gives the weight bytes a step by class and the
live K/V bytes (the rows [0, pos] each step attends to), the step's bound
(``llm_inference_tpu_torch.card.bound_ms``: the larger of those bytes over
3.35 TB/s and the operations at the H100's peaks, 989 TFLOP/s bf16), the
device time a step (the union of the device's kernel, copy and set
intervals: kernels that overlap under programmatic dependent launch count
once) and the bound's share of it, the wall time a step untraced (its
tok/s) and under the profiler, the device's busy share of the traced
window (device time and window from the same run), a table by op class (the port's kernels by name, torch GEMMs,
elementwise ops, copies, the sampler) and the top kernels, both in summed
kernel durations. Every port
kernel's calls in the trace must equal its wrapper's launch counter over
the same window, or the tool exits 1. Then the prefill buckets (32-512 up
to ``--max-seq``): wall and device ms, the gap between them, GFLOPs (2 x T
x matmul parameters) and the MFU of device time against 989 TFLOP/s.

Runs on ``cuda`` unless given ``--device cpu``, where "device time" is the
CPU ops' own time (no kernels, no launch counts). The checkpoint is the
tame Gemma-3-1B that ``chip_smoke.tame_checkpoint`` writes, unless ``-m``
names another. Prints the card's name and power limit; ``--out PATH`` also
writes the report there.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from llm_inference_tpu_torch.card import BF16_OPS_PER_S, bound_by, bound_ms, card_line  # noqa: E402

MATMUL_FIELDS = ("wqkv", "wq", "wk", "wv", "wo", "w_gate_up", "w_gate", "w_up", "w_down",
                 "per_layer_inp_gate", "per_layer_proj")
BATCHED = "batched step (rows 8-9)"
# each __global__ function of llm_inference_tpu_torch/csrc and its op class
PORT_KERNELS = {
    "decode_step_kernel": "whole step, rowq8 (row 3)",
    "decode_step_g4_kernel": "whole step, rowq8 (row 3)",
    "decode_step_q_kernel": "whole step, lossless (row 4)",
    "decode_step_stream_kernel": "capacity step (row 10)",
    "tp_step_kernel": "tensor-parallel step (rows 11-12)",
    "qmatmul_grouped_kernel": "quant_matmul / q4_matmul (rows 1, 1b, 2)",
    "flash_decode_kernel": "flash_decode / paged_flash_decode (rows 5-6)",
    "insert_kernel": "insert_kv_rows (row 7)",
    "gemm_kernel": BATCHED, "qkv_prep_kernel": BATCHED, "attn_scores_kernel": BATCHED,
    "attn_pv_kernel": BATCHED, "attn_combine_kernel": BATCHED,
    "residual_norm_kernel": BATCHED, "argmax_reduce_kernel": BATCHED,
}
# the port kernels whose calls a wrapper counts: (kernels, the counters that count them)
LAUNCH_GROUPS = (
    (("qmatmul_grouped_kernel",), ("quant_matmul", "quant_matmul_grouped", "q4_matmul")),
    (("decode_step_kernel", "decode_step_g4_kernel"), ("decode_step",)),
    (("decode_step_q_kernel",), ("decode_step_q",)),
    (("decode_step_stream_kernel",), ("decode_step_stream",)),
    (("tp_step_kernel",), ("decode_step_tp", "decode_step_q_tp")),
    (("flash_decode_kernel",), ("flash_decode", "paged_flash_decode")),
    (("insert_kernel",), ("insert_kv_rows",)),
    # a greedy batched step ends in one argmax reduction
    (("argmax_reduce_kernel",), ("decode_step_batch", "decode_step_batch_paged")),
)
_ATEN = {
    "torch GEMM": {"mm", "addmm", "bmm", "matmul", "linear", "baddbmm", "addmv", "mv", "dot",
                   "_int_mm", "einsum"},
    "sampler (argmax, sort, top-k)": {"argmax", "sort", "topk", "cumsum", "multinomial"},
    "softmax": {"softmax", "_softmax", "log_softmax", "_log_softmax"},
    "copies / casts / indexing": {
        "copy_", "to", "_to_copy", "index", "index_select", "gather", "scatter", "cat", "stack",
        "clone", "contiguous", "index_put_", "index_copy_", "index_add_", "fill_", "zero_",
        "zeros", "empty", "empty_like", "full", "arange", "select", "slice", "view", "reshape",
        "narrow", "expand", "unsqueeze", "squeeze", "permute", "transpose", "t", "as_strided",
        "_unsafe_view", "item", "_local_scalar_dense", "embedding", "new_zeros", "detach",
        "flatten", "lift_fresh", "alias", "resize_", "split", "chunk", "unbind", "repeat"},
}


def op_class(name: str) -> str:
    """The op class of a profiled kernel (or, on the CPU, aten op) name."""
    for k, cls in PORT_KERNELS.items():
        if re.search(rf"\b{k}\b", name):
            return cls
    if name.startswith("aten::"):
        op = name[len("aten::"):]
        return next((cls for cls, ops in _ATEN.items() if op in ops),
                    "elementwise / reductions")
    n = name.lower()
    if any(s in n for s in ("argmax", "argmin", "sort", "topk", "cumsum", "scan", "multinomial")):
        return "sampler (argmax, sort, top-k)"
    if "softmax" in n:
        return "softmax"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "gemv", "matmul")):
        return "torch GEMM"
    if any(s in n for s in ("memcpy", "memset", "copy", "catarray", "gather", "scatter",
                            "index", "fill")):
        return "copies / casts / indexing"
    if any(s in n for s in ("elementwise", "reduce", "norm", "pointwise")):
        return "elementwise / reductions"
    return "other"


def port_kernel(name: str) -> str | None:
    """The csrc __global__ function a profiled kernel name is, if any."""
    return next((k for k in PORT_KERNELS if re.search(rf"\b{k}\b", name)), None)


# -- bytes and parameters ----------------------------------------------------------------


def _depth(p) -> int:
    """Stacked layers a weight holds (its leading dims), 1 if unstacked."""
    inner = p.shards[0] if getattr(p, "shards", None) else p
    arr = next(getattr(inner, k) for k in ("q", "packed", "w") if getattr(inner, k, None)
               is not None)
    return int(np.prod(arr.shape[:-2], dtype=np.int64))


def matmul_params(w) -> int:
    """Logical weight elements the matmuls touch a token (the layer
    projections and the tied-embedding logits): FLOPs a token = 2x. A
    stacked weight counts each of its layers (the JAX tool counts a stacked
    weight's rows x cols once, one layer's)."""
    def elems(p):
        if p is None:
            return 0
        return int(p.rows) * int(p.cols) * _depth(p)

    layers = w.layers if isinstance(w.layers, (list, tuple)) else [w.layers]
    total = sum(elems(getattr(lw, f, None)) for lw in layers for f in MATMUL_FIELDS)
    return total + elems(w.token_embd)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def nbytes(obj) -> int:
    """Bytes of every tensor ``obj`` holds (a view counts its own elements),
    each distinct tensor once."""
    seen, total = set(), 0
    for t in _tensors(obj):
        key = (t.data_ptr(), t.numel(), t.element_size(), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def weight_bytes(w) -> dict[str, int]:
    """Bytes a decode step reads, by weight class: every weight once, and
    one row of gemma4's per-layer embedding."""
    out = {"layers": nbytes(w.layers), "logits (tied embd)": nbytes(w.token_embd),
           "norms/other": nbytes(w.output_norm)}
    pl = getattr(w, "token_embd_per_layer", None)
    if pl is not None:
        out["per-layer inputs"] = (nbytes(pl) // pl.rows + nbytes(w.per_layer_model_proj)
                                   + nbytes(w.per_layer_proj_norm))
    return out


def kv_row_bytes(k_layers, v_layers, lead: int) -> list[int]:
    """One cache row's K and V bytes, each KV layer: ``k_layers[i]``'s
    ``lead`` leading dims (slot; lane and slot; page and slot) stripped."""
    def row(t):
        idx = (0,) * lead
        return t[idx].numel() * t.element_size()

    return [row(k_layers[i]) + row(v_layers[i]) for i in range(len(k_layers))]


def step_work(hp, w, rows_kv: list[int]):
    """A function of the lanes' positions giving the bytes, bf16 operations
    and f32 operations of one decode step: the weights once, each lane's
    live K/V rows [0, pos] (its written row included), the f32 logits out;
    the projections 2 x params a lane, attention 2 x H x (dk + dv) a live
    row, a layer and a lane."""
    from llm_inference_tpu_torch.models.gemma import head_dims

    wb, params, V = sum(weight_bytes(w).values()), matmul_params(w), w.token_embd.rows
    row, att = sum(rows_kv), sum(2 * hp.n_head * sum(head_dims(hp, i))
                                 for i in range(hp.block_count))

    def work(lanes_pos: list[int]) -> tuple[float, float, float]:
        live = sum(p + 1 for p in lanes_pos)
        return (wb + live * row + 4 * V * len(lanes_pos), 2.0 * params * len(lanes_pos),
                float(live * att))

    return work


# -- the profiler ----------------------------------------------------------------------


def launch_counts() -> dict[str, int]:
    """The port wrappers' launch counters."""
    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode,
                                                     fused_decode_batch,
                                                     fused_decode_batch_paged, fused_decode_q,
                                                     fused_decode_q_tp, fused_decode_stream,
                                                     fused_decode_tp, kv_insert, qmatmul)

    return {"quant_matmul": qmatmul.launches, "quant_matmul_grouped": qmatmul.grouped_launches,
            "q4_matmul": qmatmul.q4_launches, "decode_step": fused_decode.launches,
            "decode_step_q": fused_decode_q.launches,
            "decode_step_stream": fused_decode_stream.launches,
            "decode_step_tp": fused_decode_tp.launches,
            "decode_step_q_tp": fused_decode_q_tp.launches,
            "flash_decode": flash_decode.launches,
            "paged_flash_decode": flash_decode.paged_launches,
            "insert_kv_rows": kv_insert.launches,
            "decode_step_batch": fused_decode_batch.launches,
            "decode_step_batch_paged": fused_decode_batch_paged.launches}


def union_us(spans) -> float:
    """Length of the union of [start, end) intervals: the time at least one
    of them was running."""
    total, end = 0.0, -float("inf")
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


@dataclasses.dataclass
class Trace:
    """One traced window: each event name's summed (us, calls), the
    wrappers' launches over the window, the wall time of the traced calls,
    the device's busy us (the union of its event intervals; on the CPU the
    summed ops' own time) and the profiler's own seconds around them
    (start, stop, processing)."""
    events: dict
    launches: dict
    wall_s: float
    busy_us: float = 0.0
    profiler_s: float = 0.0

    @property
    def total_us(self) -> float:
        """Summed event durations: overlapping kernels each count whole."""
        return sum(us for us, _ in self.events.values())

    def by_class(self) -> collections.Counter:
        out = collections.Counter()
        for name, (us, _) in self.events.items():
            out[op_class(name)] += us
        return out

    def launch_rows(self) -> list[tuple[str, int, int]]:
        """(kernels, calls in the trace, wrapper launches) for each group of
        port kernels either side saw."""
        calls = collections.Counter()
        for name, (_, n) in self.events.items():
            k = port_kernel(name)
            if k is not None:
                calls[k] += n
        rows = []
        for kernels, counters in LAUNCH_GROUPS:
            got = sum(calls[k] for k in kernels)
            want = sum(self.launches.get(x, 0) for x in counters)
            if got or want:
                rows.append((" + ".join(kernels), got, want))
        return rows


def trace(fn, device) -> Trace:
    """Run ``fn`` once under torch.profiler: on CUDA each kernel, copy and
    set's device time and calls, on the CPU each aten op's own time. On
    CUDA the host activity is traced too: without it the profiler dropped
    kernel records (up to 14 of a window's 32 steps) in a process whose
    profiler had first run minutes before, as its device clock drifted from
    the window's."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = launch_counts()
    t_all = time.perf_counter()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = launch_counts()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    events = {}
    for e in prof.key_averages():
        if cuda:
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        else:
            us = e.self_cpu_time_total
        if e.count:
            events[e.key] = (float(us), int(e.count))
    busy = union_us(spans) if cuda else sum(us for us, _ in events.values())
    return Trace(events, {k: after[k] - before[k] for k in after}, wall, busy_us=busy,
                 profiler_s=time.perf_counter() - t_all - wall)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- the report --------------------------------------------------------------------------


def _step_lines(title: str, w, tr: Trace, steps: int, lanes: int, wall_s: float,
                work: list[tuple[float, float, float]], kv_bytes: float,
                top: int) -> tuple[list[str], dict]:
    wb = weight_bytes(w)
    bound = float(np.mean([bound_ms(*x) for x in work]))
    by = bound_by(*work[len(work) // 2])
    dev_ms = tr.busy_us / steps / 1e3
    summed_ms = tr.total_us / steps / 1e3
    wall_ms = wall_s / steps * 1e3
    # the busy share within the traced window: the untraced run's wall time
    # is another run, and its spread can put device / wall above 1
    traced_ms = tr.wall_s / steps * 1e3
    busy = dev_ms / traced_ms
    if tr.busy_us == 0:
        raise RuntimeError(f"{title}: the trace holds no events; the profiler did not see "
                           "the device")
    lines = [f"# {title}", "",
             f"- weight bytes a step: {sum(wb.values()) / 1e6:.3f} MB ("
             + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in wb.items()) + ")",
             f"- live K/V bytes a step (rows [0, pos] of every KV layer, mean over the traced "
             f"steps): {kv_bytes / 1e6:.3f} MB",
             f"- bound a step: {bound:.6f} ms (by {by}; {lanes * 1e3 / bound:.1f} tok/s)",
             f"- device time a step: {dev_ms:.4f} ms, the union of its kernel, copy and set "
             f"intervals (the bound is {100 * bound / dev_ms:.1f}% of it); summed kernel "
             f"durations {summed_ms:.4f} ms (overlapping kernels each counted whole)",
             f"- wall time a step: {wall_ms:.4f} ms ({lanes * 1e3 / wall_ms:.1f} tok/s); under "
             f"the profiler {traced_ms:.4f} ms, the device busy {100 * busy:.1f}% of it", "",
             "## By op class (summed kernel durations a step)", "",
             "| op class | us/step | % of the summed time |", "|---|---|---|"]
    total = max(tr.total_us, 1e-9)
    classes = tr.by_class()
    for cls, us in classes.most_common():
        lines.append(f"| {cls} | {us / steps:.1f} | {100 * us / total:.1f}% |")
    lines += ["", "## Top kernels (summed durations)", "",
              "| kernel | us/step | calls/step | us/call |",
              "|---|---|---|---|"]
    for name, (us, n) in sorted(tr.events.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"| `{name[:70]}` | {us / steps:.1f} | {n / steps:.2f} | "
                     f"{us / max(n, 1):.1f} |")
    lines += launch_lines(tr)
    info = dict(bound_ms=bound, bound_by=by, device_ms=dev_ms, summed_ms=summed_ms,
                wall_ms=wall_ms,
                traced_ms=traced_ms, busy=busy, weight_bytes=wb, kv_bytes=kv_bytes,
                classes={k: v / steps for k, v in classes.items()},
                launch_rows=tr.launch_rows(), profiler_s=tr.profiler_s)
    return lines, info


def launch_lines(tr: Trace) -> list[str]:
    rows = tr.launch_rows()
    if not rows:
        return ["", "No port kernel launched in this window."]
    out = ["", "## Port kernels: calls in the trace against the wrappers' launches", "",
           "| kernel | traced calls | wrapper launches |", "|---|---|---|"]
    return out + [f"| {k} | {got} | {want} |" for k, got, want in rows]


def _prefill(eng, prompt: list[int]):
    """The engine's prefill as ``generate_from_ids`` runs it: (cache, first id)."""
    from llm_inference_tpu_torch.engine import prefill_bucket
    from llm_inference_tpu_torch.models.gemma import forward

    padded = torch.zeros(prefill_bucket(len(prompt)), dtype=torch.int64)
    padded[: len(prompt)] = torch.tensor(prompt, dtype=torch.int64)
    logits, cache = forward(eng.hparams, eng._prefill_w, eng.new_cache(),
                            padded.to(eng.device), 0, len(prompt), exact=eng.exact)
    return cache, int(logits.argmax())


def _prompt(T: int, vocab: int, seed: int = 0) -> list[int]:
    """The JAX tool's prompt: <bos> and seeded ids in [10, 10000) (within the vocabulary)."""
    hi = min(10000, vocab)
    rng = np.random.default_rng(seed)
    return [2] + rng.integers(min(10, hi - 1), hi, size=T - 1).tolist()


def _single_only(eng) -> None:
    from llm_inference_tpu_torch.models.gemma import KVCache

    if getattr(eng, "_tp", None) is not None or not isinstance(eng.new_cache(), KVCache):
        raise ValueError("the roofline profiles one device: build the Engine without tp_mesh "
                         "and cache_sharding")


def roofline_engine(eng, *, chunks: int = 2, top: int = 25, prompt_len: int = 32) -> dict:
    """Trace ``chunks`` decode chunks of the ``Engine`` after an untraced
    one and an untraced timed run of ``chunks`` chunks; the report's lines
    and numbers."""
    _single_only(eng)
    hp, n = eng.hparams, eng.decode_chunk
    need = prompt_len + (2 * chunks + 1) * n
    if need > eng.max_seq:
        raise ValueError(f"{chunks} traced chunks of {n} need max_seq >= {need}")
    cache, tok = _prefill(eng, _prompt(prompt_len, eng.weights.token_embd.rows))
    pos = prompt_len
    toks = eng._decode_chunk(cache, tok, pos)  # settle
    pos += n
    t0 = time.perf_counter()
    for _ in range(chunks):
        toks = eng._decode_chunk(cache, int(toks[-1]), pos)
        pos += n
    wall = time.perf_counter() - t0
    lo = pos

    def traced():
        nonlocal toks, pos
        for _ in range(chunks):
            toks = eng._decode_chunk(cache, int(toks[-1]), pos)
            pos += n

    tr = trace(traced, eng.device)
    steps = chunks * n
    rows_kv = kv_row_bytes(cache.k, cache.v, 1)
    at = step_work(hp, eng.weights, rows_kv)
    work = [at([p]) for p in range(lo, lo + steps)]
    kv = float(np.mean([(p + 1) * sum(rows_kv) for p in range(lo, lo + steps)]))
    title = (f"Roofline: the PyTorch port, mode={eng.mode}, {eng.decode_route} route, "
             f"max_seq={eng.max_seq}, {hp.architecture} {hp.block_count} layers d "
             f"{hp.embedding_length}; {chunks} chunks of {n} steps traced at positions "
             f"[{lo}, {lo + steps})")
    lines, info = _step_lines(title, eng.weights, tr, steps, 1, wall, work, kv, top)
    info.update(lines=lines, positions=(lo, lo + steps))
    return info


def roofline_prefill(eng, buckets=(32, 64, 128, 256, 512), reps: int = 3) -> dict:
    """Each bucket's prefill: wall ms (untraced), device ms (traced), the
    gap, GFLOPs and the MFU of device time; with the launch checks."""
    _single_only(eng)
    params = matmul_params(eng.weights)
    rows, traces = [], []
    for T in buckets:
        if T > eng.max_seq:
            continue
        prompt = _prompt(T, eng.weights.token_embd.rows)

        def run():
            for _ in range(reps):
                _prefill(eng, prompt)
            _sync(eng.device)

        _prefill(eng, prompt)  # settle
        _sync(eng.device)
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) / reps * 1e3
        tr = trace(run, eng.device)
        dev = tr.busy_us / reps / 1e3
        flops = 2.0 * T * params
        mfu = flops / (dev * 1e-3) / BF16_OPS_PER_S if dev else 0.0
        rows.append(dict(T=T, wall_ms=wall, device_ms=dev, gap_ms=wall - dev,
                         gflops=flops / 1e9, mfu=mfu, tok_s=T / wall * 1e3))
        traces.append(tr)
    lines = ["", "## Prefill (bucketed prompt lengths)", "",
             f"bf16 tensor-core peak {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s. FLOPs = 2 x T x "
             f"{params / 1e6:.1f} M matmul parameters; MFU is of device time; the gap is wall - "
             f"device (host work between kernels); means over {reps} prefills.", "",
             "| bucket | wall ms | device ms | gap ms | GFLOPs | MFU (device) | "
             "prefill tok/s (wall) |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['T']} | {r['wall_ms']:.3f} | {r['device_ms']:.3f} | "
                     f"{r['gap_ms']:.3f} | {r['gflops']:.2f} | {100 * r['mfu']:.2f}% | "
                     f"{r['tok_s']:.0f} |")
    for T, tr in zip((r["T"] for r in rows), traces):
        for k, got, want in tr.launch_rows():
            lines.append(f"- bucket {T}: {k} traced {got} calls, wrappers {want} launches")
    return dict(lines=lines, rows=rows, launch_rows=[r for tr in traces
                                                      for r in tr.launch_rows()])


def roofline_server(server, *, chunks: int = 1, top: int = 25, prompt_len: int = 32) -> dict:
    """Trace ``chunks`` chunks of a full ``BatchedServer`` (one request a
    lane) after an admitting chunk, an untraced one and an untraced timed
    run of ``chunks`` chunks."""
    if server.exact or server._sharded:
        raise ValueError("the roofline profiles a one-device serve-mode server")
    B, n = server.max_batch, server.decode_chunk
    server.tokenizer.eos_id = -1
    server.tokenizer.end_of_turn_id = -1
    need = (2 * chunks + 3) * n + 8
    vocab = server.weights.token_embd.rows
    reqs = [server.submit(_prompt(prompt_len, vocab, seed=b), need) for b in range(B)]
    server.step()  # admit every lane
    server.step()  # settle
    t0 = time.perf_counter()
    for _ in range(chunks):
        server.step()
    wall = time.perf_counter() - t0
    lanes = [r.pos for r in reqs]
    if len(server._active) != B:
        raise RuntimeError(f"{len(server._active)} of {B} lanes active")

    def traced():
        for _ in range(chunks):
            server.step()

    tr = trace(traced, server.device)
    steps = chunks * n
    caches = server._caches
    rows_kv = kv_row_bytes(caches.k, caches.v, 2)
    at = step_work(server.hparams, server.weights, rows_kv)
    work = [at([p + i for p in lanes]) for i in range(steps)]
    kv = float(np.mean([sum(p + i + 1 for p in lanes) * sum(rows_kv) for i in range(steps)]))
    hp = server.hparams
    title = (f"Roofline: the PyTorch port's BatchedServer, mode={server.mode}, "
             f"{server.decode_route} route, B={B}, max_seq={server.max_seq}"
             + (f", {server.kv_pages} pages of {server.page}" if server.paged else "")
             + f", {hp.architecture} {hp.block_count} layers d {hp.embedding_length}; {chunks} "
             f"chunks of {n} steps traced, lanes at positions [{min(lanes)}, "
             f"{max(lanes) + steps})")
    lines, info = _step_lines(title, server.weights, tr, steps, B, wall, work, kv, top)
    info.update(lines=lines, positions=(min(lanes), max(lanes) + steps))
    return info


def check_launches(*reports) -> None:
    """Raise where a port kernel's traced calls differ from its wrappers'
    launches over the same window."""
    bad = [row for r in reports for row in r["launch_rows"] if row[1] != row[2]]
    if bad:
        raise RuntimeError("traced calls != wrapper launches: "
                           + "; ".join(f"{k} {got} against {want}" for k, got, want in bad))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", default=None,
                    help="the checkpoint (default: chip_smoke's tame Gemma-3-1B)")
    ap.add_argument("--mode", default="serve-q8",
                    choices=["serve", "serve-q", "serve-q4", "serve-q8", "parity"])
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--decode-chunk", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--per-op", action="store_true",
                    help="the per-op route (LLMI_NO_FUSED_DECODE=1)")
    ap.add_argument("--no-prefill", action="store_true", help="skip the prefill buckets")
    ap.add_argument("--batch", type=int, default=0, help="a BatchedServer of this many lanes")
    ap.add_argument("--paged", type=int, nargs="?", const=-1, default=0,
                    help="with --batch: a paged pool of N pages (default: enough for every "
                         "lane's whole cache)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args(argv)

    from llm_inference_tpu_torch.engine import Engine, resolve_device
    from llm_inference_tpu_torch.serving import BatchedServer, page_size

    device = resolve_device(args.device)
    if args.model:
        path = args.model
    else:
        import chip_smoke

        path = str(chip_smoke.tame_checkpoint())
    saved = os.environ.get("LLMI_NO_FUSED_DECODE")
    if args.per_op:
        os.environ["LLMI_NO_FUSED_DECODE"] = "1"
    try:
        if args.batch:
            pages = args.paged
            if pages == -1:
                pages = args.batch * (args.max_seq // page_size(args.max_seq))
            server = BatchedServer(path, max_seq=args.max_seq, max_batch=args.batch,
                                   mode=args.mode, decode_chunk=args.decode_chunk,
                                   max_admit_per_step=args.batch, kv_pages=pages or None,
                                   device=device)
        else:
            eng = Engine(path, max_seq=args.max_seq, mode=args.mode,
                         decode_chunk=args.decode_chunk, device=device)
    finally:
        if saved is None:
            os.environ.pop("LLMI_NO_FUSED_DECODE", None)
        else:
            os.environ["LLMI_NO_FUSED_DECODE"] = saved
    if args.batch:
        reports = [roofline_server(server, chunks=args.chunks, top=args.top)]
    else:
        reports = [roofline_engine(eng, chunks=args.chunks, top=args.top)]
        if not args.no_prefill:
            reports.append(roofline_prefill(eng))
    out = "\n".join([card_line(device), ""] + [x for r in reports for x in r["lines"]])
    print(out)
    if args.out:
        Path(args.out).write_text(out + "\n")
    try:
        check_launches(*reports)
    except RuntimeError as e:
        print(f"torch_roofline: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
