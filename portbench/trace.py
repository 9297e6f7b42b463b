"""The profiled stretch of a traced run, reduced to a plain record.

``record`` turns a ``torch.profiler`` profile into what the per-layer
metric readers take (portbench/metrics/), so that a reader can be tested
on a record written by hand:

- ``ops``: device operations (kernels, copies, sets) as [name, start_us,
  end_us];
- ``spans``: the benchmark's own host spans (``portbench.<name>``) and
  ``host``: every other host operation, each as [name, start_us, end_us],
  on the device operations' clock;
- ``steps``: the stretch's step records, ``shape``: the cell's sizes,
  ``counters``: the program's counters over the stretch;
- ``window_s``: the stretch's wall time, ``busy_s``: the union of the
  device operations' intervals, and ``breakdown``: the device operations
  that took most time and the longest idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10
# host operations looked back over to name an idle gap
SCAN = 256


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_us(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle [start, end) gaps between the union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def breakdown(ops, host, spans) -> Dict:
    per = defaultdict(float)
    for name, s, e in ops:
        per[name] += (e - s) * 1e-6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    by_host = defaultdict(float)
    cands = sorted(host + spans, key=lambda h: h[1])
    starts = [h[1] for h in cands]
    for gs, ge in gaps_us([(s, e) for _, s, e in ops]):
        mid = 0.5 * (gs + ge)
        # the innermost host operation open at the gap's middle: the latest
        # started one that is still open (nested ranges start later)
        name = "(none)"
        i = bisect.bisect_right(starts, mid) - 1
        for h in cands[max(i - SCAN, -1) + 1:i + 1][::-1]:
            if h[2] > mid:
                name = h[0]
                break
        by_host[name] += (ge - gs) * 1e-6
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_ops=[[n, v] for n, v in top],
                idle_gaps=[[n, v] for n, v in gaps])


def _events(prof):
    """(device ops, portbench spans, other host ops) of a profile."""
    import torch

    ops, spans, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        row = [e.name, float(tr.start), float(tr.end)]
        if e.name.startswith("portbench."):
            # the spans show on the device's timeline too (as annotations)
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append([e.name[len("portbench."):], row[1], row[2]])
        elif e.device_type != torch.autograd.DeviceType.CPU:
            ops.append(row)
        else:
            host.append(row)
    return ops, spans, host


def record(prof, window_s: float, steps, shape, counters) -> Dict:
    ops, spans, host = _events(prof)
    busy = union_us([(s, e) for _, s, e in ops]) * 1e-6
    return dict(ops=ops, spans=spans, host=host, steps=steps, shape=shape,
                counters=counters, window_s=window_s, busy_s=busy,
                breakdown=breakdown(ops, host, spans))
