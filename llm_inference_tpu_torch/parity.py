"""Cross-engine activation-parity harness.

The port's own copy of llm_inference_tpu/parity.py (pure numpy; the port
imports nothing of the JAX package), itself the counterpart of the
reference's llama.cpp comparison tooling (diff_with_llama_cpp.sh and
compare_tensors.py): parse a reference-engine verbose dump (the
print_tensor format, reference tensor.h:22-85) or llama.cpp's
``llama-eval-callback`` output, align its tensors by name and occurrence
with this engine's trace records (trace.py), and report the divergence of
each.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_HDR = re.compile(r"^(?P<name>.*\S)\s*=\s*\{(?P<shape>[\d,\s]+)\}\s*$")
_SUM = re.compile(r"^\s*sum\s*=\s*(?P<sum>[-\d.naif]+)\s*$", re.IGNORECASE)


@dataclasses.dataclass
class DumpRecord:
    name: str
    shape: tuple[int, ...]
    total: float
    corners: list[float]


def parse_reference_dump(text: str) -> list[DumpRecord]:
    """Parse the reference's -v stdout into named records (name, shape,
    checksum sum, corner samples)."""
    records: list[DumpRecord] = []
    current: DumpRecord | None = None
    for line in text.splitlines():
        m = _HDR.match(line)
        if m and "[" not in line:
            shape = tuple(int(x) for x in m.group("shape").split(","))
            current = DumpRecord(name=m.group("name"), shape=shape, total=float("nan"), corners=[])
            records.append(current)
            continue
        if current is None:
            continue
        s = _SUM.match(line)
        if s:
            try:
                current.total = float(s.group("sum"))
            except ValueError:
                current.total = float("nan")
            current = None
            continue
        # corner-value rows look like "      [   0.1234, ..., -0.5678],"
        stripped = line.strip()
        if stripped.startswith("[") and any(c.isdigit() for c in stripped):
            for tok in stripped.strip("[],").split(","):
                tok = tok.strip().rstrip("],")
                if tok and tok != "...":
                    try:
                        current.corners.append(float(tok))
                    except ValueError:
                        pass
    return records


_EC_HDR = re.compile(
    r"^(?P<name>[^=]+?)\s*=\s*\((?P<dtype>\w+)\)\s*(?P<op>\w+)?.*"
    r"\{(?P<shape>[\d,\s]+)\}\s*$")


def parse_eval_callback_dump(text: str) -> list[DumpRecord]:
    """Parse llama.cpp's ``llama-eval-callback`` output into DumpRecords —
    the reference's golden-model leg (diff_with_llama_cpp.sh:17-24 pipes
    this format through compare_tensors.py after normalizing it).

    Normalizations applied here, mirroring the reference's sed lines:
      - strip the ``ggml_debug: `` / ``common_debug_cb_eval: `` prefix
        (anything before the first colon+whitespace);
      - rename ``<X>cur-<i> = (f32) ROPE(...)`` headers to
        ``<X>cur-<i> (post rope)`` so they align with the reference
        engine's tap names (diff_with_llama_cpp.sh:26).

    Header lines look like
    ``Qcur-0 = (f32) ROPE(Qcur-0 (reshaped){128, 4, 7, 1}, ...) = {128, 4, 7, 1}``
    — name before the first '=', shape from the LAST {...} group; then
    bracketed corner-value rows; ``sum = X`` ends the block."""
    records: list[DumpRecord] = []
    current: DumpRecord | None = None
    prefix = re.compile(r"^[^:\s]+:\s+")
    rope_hdr = re.compile(r"^(?P<base>\w*cur-\d+)\s*=\s*\(f32\)\s*ROPE\b")
    for line in text.splitlines():
        line = prefix.sub("", line)
        s = _SUM.match(line)
        if s and current is not None:
            try:
                current.total = float(s.group("sum"))
            except ValueError:
                current.total = float("nan")
            current = None
            continue
        m = _EC_HDR.match(line)
        if m and not line.lstrip().startswith("["):
            name = m.group("name").strip()
            r = rope_hdr.match(line)
            if r:
                name = f"{r.group('base')} (post rope)"
            shape = tuple(int(x) for x in m.group("shape").split(","))
            current = DumpRecord(name=name, shape=shape, total=float("nan"),
                                 corners=[])
            records.append(current)
            continue
        if current is None:
            continue
        stripped = line.strip()
        if stripped.startswith("[") and any(c.isdigit() for c in stripped):
            for tok in stripped.strip("[],").split(","):
                tok = tok.strip().rstrip("],")
                if tok and tok != "...":
                    try:
                        current.corners.append(float(tok))
                    except ValueError:
                        pass
    return records


def corner_sample(arr: np.ndarray) -> np.ndarray:
    """Sample an array exactly like the reference's tensor printer
    (print_tensor_generic, reference tensor.h:48-70): per axis, the first
    3 and last 3 indices when the axis exceeds 6 — in print order, so the
    flat result aligns positionally with the corner values parsed from a
    reference dump."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 0:
        return a.reshape(1)

    def sel(n: int) -> np.ndarray:
        if n > 6:
            return np.array([0, 1, 2, n - 3, n - 2, n - 1])
        return np.arange(n)

    return a[np.ix_(*(sel(n) for n in a.shape))].reshape(-1)


def format_reference_dump(records: list[tuple[str, np.ndarray]]) -> str:
    """Trace records [(name, array)] as a dump in the reference printer's
    format (reference tensor.h:22-85: each tensor's ggml shape, corner
    values and sum), which ``parse_reference_dump`` reads back."""
    blocks = []
    for name, v in records:
        v = np.asarray(v)
        dims = ", ".join(str(d) for d in list(v.shape[::-1]) + [1] * (4 - v.ndim))
        flat = corner_sample(v)
        body = "\n".join("      [" + ", ".join(f"{x:10.4f}" for x in flat[i : i + 6]) + "],"
                         for i in range(0, len(flat), 6))
        blocks.append(f"{name} = {{{dims}}}\n{body}\n      sum = {float(np.sum(v)):.6f}\n")
    return "".join(blocks)


@dataclasses.dataclass
class TensorComparison:
    name: str
    index: int  # position in forward-pass order
    sum_diff: float
    value_mse: float  # per-element MSE over the printer's corner samples
    n_values: int


def compare_values(
    ref_records: list[DumpRecord],
    our_records: list[tuple[str, np.ndarray]],
) -> list[TensorComparison]:
    """Per-tensor |Δsum| and corner-value MSE, aligned by (name,
    occurrence) — the reference's own cross-engine metric
    (compare_tensors.py:67-202). The reference prints corners with 4
    decimals, so MSE carries a ~2e-9 quantization floor."""
    ref_map: dict[str, list[DumpRecord]] = {}
    for rec in ref_records:
        ref_map.setdefault(rec.name, []).append(rec)
    ref_idx: dict[str, int] = {name: 0 for name in ref_map}

    out: list[TensorComparison] = []
    for name, value in our_records:
        if name not in ref_map or ref_idx[name] >= len(ref_map[name]):
            continue
        rec = ref_map[name][ref_idx[name]]
        ref_idx[name] += 1
        ours_sum = float(np.asarray(value, dtype=np.float64).sum())
        ours_vals = corner_sample(value)
        n = min(len(rec.corners), len(ours_vals))
        mse = 0.0
        if n:
            d = np.asarray(rec.corners[:n]) - ours_vals[:n]
            mse = float(np.mean(d * d))
        out.append(TensorComparison(
            name=name, index=len(out),
            sum_diff=abs(ours_sum - rec.total) if rec.total == rec.total else float("nan"),
            value_mse=mse, n_values=n,
        ))
    return out


def format_comparison_report(
    comparisons: list[TensorComparison], *, first: int = 40, top: int = 5
) -> str:
    """The reference comparer's report: first-N table, top-N offenders by
    |Δsum| and by value-MSE, overall average MSE
    (compare_tensors.py:147-202, matplotlib plot replaced by text)."""
    if not comparisons:
        return "No matching tensors found to compare."
    lines = [f"{'Index':<6} {'Tensor Name':<40} {'Sum Diff':<15} {'Value MSE':<15}",
             "-" * 80]
    for c in comparisons[:first]:
        lines.append(f"{c.index:<6} {c.name:<40} {c.sum_diff:<15.6e} {c.value_mse:<15.6e}")
    lines.append("")
    lines.append(f"Top {top} Sum Deviations:")
    for c in sorted(comparisons, key=lambda c: c.sum_diff, reverse=True)[:top]:
        lines.append(f"  {c.name} (idx {c.index}): {c.sum_diff:.6e}")
    lines.append("")
    lines.append(f"Top {top} Value MSEs:")
    for c in sorted(comparisons, key=lambda c: c.value_mse, reverse=True)[:top]:
        lines.append(f"  {c.name} (idx {c.index}): {c.value_mse:.6e}")
    avg = sum(c.value_mse for c in comparisons) / len(comparisons)
    lines.append("")
    lines.append(f"OVERALL AVG MSE: {avg:.6e}")
    return "\n".join(lines)


def mse_logplot(comparisons: list[TensorComparison], *, width: int = 64,
                rows: int = 12) -> str:
    """Text log-scale MSE-vs-tensor-index plot — the artifact form of the
    reference comparer's matplotlib figure (compare_tensors.py:150-202:
    log-y MSE over forward-pass order shows WHERE error grows)."""
    if not comparisons:
        return "(no tensors)"
    mses = np.array([max(c.value_mse, 0.0) for c in comparisons])
    floor = 1e-12
    logs = np.log10(np.maximum(mses, floor))
    lo, hi = float(logs.min()), float(logs.max())
    if hi - lo < 1e-9:
        hi = lo + 1.0
    n = len(logs)
    # bucket tensor indices into `width` columns, max-pool each column
    cols = np.full(width, -np.inf)
    for i, v in enumerate(logs):
        cols[min(i * width // n, width - 1)] = max(
            cols[min(i * width // n, width - 1)], v)
    grid = []
    for r in range(rows):
        level = hi - (hi - lo) * r / (rows - 1)
        # mark every column whose max MSE reaches this row's level
        line = "".join("*" if c >= level else " " for c in cols)
        grid.append(f"1e{level:+06.1f} |{line}")
    grid.append(" " * 8 + "+" + "-" * width)
    grid.append(" " * 9 + f"tensor index 0..{n - 1} (forward-pass order), "
                "log10 value-MSE")
    return "\n".join(grid)


@dataclasses.dataclass
class Divergence:
    name: str
    ref_sum: float
    our_sum: float
    abs_diff: float
    rel_diff: float


def compare_sums(
    ref_records: list[DumpRecord],
    our_records: list[tuple[str, np.ndarray]],
    *,
    rel_tol: float = 1e-3,
) -> list[Divergence]:
    """Align by (name, occurrence) and report checksum divergences, in
    forward-pass order — the first entries localize where engines split."""
    ours: dict[tuple[str, int], float] = {}
    seen: dict[str, int] = {}
    order: list[tuple[str, int]] = []
    magnitudes: dict[tuple[str, int], float] = {}
    for name, value in our_records:
        k = (name, seen.get(name, 0))
        seen[name] = seen.get(name, 0) + 1
        ours[k] = float(np.asarray(value, dtype=np.float64).sum())
        magnitudes[k] = float(np.abs(np.asarray(value, dtype=np.float64)).sum())
        order.append(k)

    out: list[Divergence] = []
    seen_ref: dict[str, int] = {}
    for rec in ref_records:
        k = (rec.name, seen_ref.get(rec.name, 0))
        seen_ref[rec.name] = seen_ref.get(rec.name, 0) + 1
        if k not in ours:
            continue
        diff = abs(ours[k] - rec.total)
        denom = max(abs(rec.total), magnitudes.get(k, 0.0), 1e-6)
        rel = diff / denom
        if rel > rel_tol:
            out.append(Divergence(rec.name, rec.total, ours[k], diff, rel))
    return out
