"""The program's own spans over a traced run's window, for the per-layer
metrics that read them (``portbench/metrics/*`` with ``program_counter``).

The program (gsmpm_tpu_torch/utils/spans.py) records a span at each layer
boundary, timed on the host and, by CUDA events, on the device, at the
window's own pace: the profiler is on only for the traced stretch.  Every
span carries the request id of the frame it belongs to (``sim.frame``,
``fit.frame``, ``fit.appearance``), so a step of the benchmark's loop is
one request.  ``steps(rec)`` picks the window's steps:

- the requests before the profiled stretch, which is the last
  ``len(rec["steps"])`` request ids;
- of those, the last ``len(rec["window_steps"])``;
- without any step that holds a ``graph.capture`` span (a first call:
  warm-up and capture, not a replay).

It returns None where the program has no spans (an older program), where
records were lost in that range (``spans.dropped`` moved) or where fewer
than half of the steps are left.  A test hands the records in as
``rec["program_spans"]``.

A leaf span is one with no child.  On the cells' paths every device launch
falls inside a leaf span and a span boundary sits at every host read of
device data, so the device is idle between leaf spans; each helper below
reads the leaves' device intervals (seconds on the device's clock).
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional

# the records of the last record handed in, by identity: every reader of a
# traced run reads the same records
_MEMO: list = []


def records(rec: Dict) -> Optional[List[Dict]]:
    """The program's span records (the test's, or the program's own)."""
    if "program_spans" in rec:
        return rec["program_spans"]
    if _MEMO and _MEMO[0] is rec:
        return _MEMO[1]
    try:
        from gsmpm_tpu_torch.utils import spans
    except ImportError:   # a program without spans
        return None
    out = spans.records()
    _MEMO[:] = [rec, out]
    return out


def steps(rec: Dict) -> Optional[List[List[Dict]]]:
    """The window's steps, each the records of one request (see the
    module's doc), or None."""
    recs = records(rec)
    if not recs:
        return None
    ids = sorted({r["request"] for r in recs if r["request"] > 0})
    n_trace, n_window = len(rec["steps"]), len(rec["window_steps"])
    before = ids[:len(ids) - n_trace]
    chosen = set(before[-n_window:]) if n_window else set()
    if not chosen:
        return None
    at = [i for i, r in enumerate(recs) if r["request"] in chosen]
    i0, i1 = at[0], at[-1]
    base = recs[i0 - 1]["dropped"] if i0 > 0 else 0
    if recs[i1]["dropped"] != base:
        return None
    by = defaultdict(list)
    for r in recs[i0:i1 + 1]:
        if r["request"] in chosen:
            by[r["request"]].append(r)
    out = [by[i] for i in sorted(by)
           if not any(r["name"] == "graph.capture" for r in by[i])]
    if len(out) < n_window / 2:
        return None
    return out


def of_kind(rec: Dict, frame: str) -> Optional[List[List[Dict]]]:
    """The window's steps whose request is a ``frame`` span."""
    got = steps(rec)
    if got is None:
        return None
    return [s for s in got if any(r["name"] == frame for r in s)] or None


def timed(r: Dict) -> bool:
    return r["dev_start"] is not None and r["dev_end"] is not None


def leaves(step: List[Dict], under: Optional[str] = None) -> List[Dict]:
    """The step's leaf spans (no child), those below a ``under`` span if
    given; None where any of them lacks its device times."""
    parents = {r["parent"] for r in step}
    by_id = {r["id"]: r for r in step}
    out = []
    for r in step:
        if r["id"] in parents:
            continue
        if under is not None:
            p = by_id.get(r["parent"])
            while p is not None and p["name"] != under:
                p = by_id.get(p["parent"])
            if p is None:
                continue
        out.append(r)
    if not all(timed(r) for r in out):
        return None
    return out


def gap_s(spans: List[Dict]) -> float:
    """Device idle between the spans' device intervals: the gaps of their
    union, from the first start to the last end."""
    total, end = 0.0, None
    for r in sorted(spans, key=lambda r: r["dev_start"]):
        if end is not None and r["dev_start"] > end:
            total += r["dev_start"] - end
        end = r["dev_end"] if end is None else max(end, r["dev_end"])
    return total


def device_s(step: List[Dict], name: str) -> Optional[float]:
    """The device seconds of the step's ``name`` spans, summed; None where
    it has none, or one without device times."""
    got = [r for r in step if r["name"] == name]
    if not got or not all(timed(r) for r in got):
        return None
    return sum(r["dev_end"] - r["dev_start"] for r in got)


def median_ms(values) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return 1e3 * statistics.median(vals) if vals else None


def gap_share(steps_: List[List[Dict]]) -> Optional[float]:
    """The median over the steps of the device idle between leaf spans
    over the device interval from the step's first leaf start to its last
    leaf end."""
    vals = []
    for s in steps_:
        lv = leaves(s)
        if not lv:
            continue
        span = (max(r["dev_end"] for r in lv)
                - min(r["dev_start"] for r in lv))
        if span > 0:
            vals.append(gap_s(lv) / span)
    return statistics.median(vals) if vals else None


def gap_ms(steps_: List[List[Dict]], under: str) -> Optional[float]:
    """The median over the steps of the device idle between the leaf spans
    below the step's ``under`` span, in ms."""
    vals = []
    for s in steps_:
        lv = leaves(s, under)
        if lv:
            vals.append(gap_s(lv))
    return median_ms(vals)
