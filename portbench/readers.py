"""What the per-layer metric readers share: device time by kernel, the
roofline bound of a layer from portbench/rooflines/, and the host spans of
a traced stretch (portbench/trace.py's record)."""

from __future__ import annotations

import importlib.util
import json
import statistics
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent


def peaks() -> Dict:
    with open(HERE / "rooflines" / "peaks.json") as f:
        return json.load(f)


def bound_s(layer: str, shape: Dict) -> float:
    """The least time of one unit of the layer's work on the card: the
    larger of its bytes over the HBM rate and its fp32 operations over the
    fp32 peak."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_roofline_{layer}", HERE / "rooflines" / f"{layer}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    nbytes, flops = mod.count(shape)
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["fp32_flops_per_s"])


def kernel_ops(rec: Dict, kernel: str):
    """The device operations whose name holds ``kernel``."""
    return [op for op in rec["ops"] if kernel in op[0]]


def device_s(ops) -> float:
    return sum(e - s for _, s, e in ops) * 1e-6


def kernel_roofline(rec: Dict, kernel: str, layer: str,
                    per: str = "launch") -> Optional[float]:
    """The layer's bound over the kernel's profiled device time, in %.
    ``per`` "launch": one unit of the layer's work per launch; "step": one
    per counted step of the stretch.  None where the kernel never ran."""
    ops = kernel_ops(rec, kernel)
    t = device_s(ops)
    if not ops or t <= 0:
        return None
    units = len(ops) if per == "launch" else counted_steps(rec)
    if units == 0:
        return None
    return 100.0 * units * bound_s(layer, rec["shape"]) / t


def counted_steps(rec: Dict) -> int:
    return sum(1 for r in rec["steps"] if r["fit"])


def span_ops(rec: Dict, span: str):
    """The device operations launched inside the benchmark's ``span``
    spans (each ended by a synchronize, so their work ends inside them)."""
    spans = sorted((s, e) for n, s, e in rec["spans"] if n == span)
    out = []
    for op in rec["ops"]:
        if any(s <= op[1] <= e for s, e in spans):
            out.append(op)
    return out


def pace(rec: Dict) -> Optional[float]:
    """The traced stretch's wall time over the window's own time for the
    same steps: for each traced step the median of the window's steps at
    its place in the cycle (``frame``).  Over 1 by the profiler's cost, so
    the stretch's idle time is no reading of the device's.  None where the
    window has no such step."""
    by = defaultdict(list)
    for r in rec["window_steps"]:
        by[r.get("frame", 0)].append(r["s"])
    want = 0.0
    for r in rec["steps"]:
        vals = by.get(r.get("frame", 0))
        if not vals:
            return None
        want += statistics.median(vals)
    return rec["window_s"] / want if want > 0 else None


def mean_span_ms(rec: Dict, key: str) -> Optional[float]:
    """The mean of a step field (host seconds) over the window's counted
    steps, in ms."""
    vals = [r[key] for r in rec["window_steps"] if r["fit"] and key in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
