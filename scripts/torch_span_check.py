"""Check the program's spans on one GPU at each benchmark cell's full size.

    python3 scripts/torch_span_check.py [--cells a,b] [--seed N] \
        [--pairs N] [--out chiprun_out/span_check.jsonl]

For each cell of BENCHMARK.json, the cell's own loop (portbench/loops) is
set up as a benchmark run sets it up, then:

1. **Cost.** Steps with the recorder on and off in turns (spans.enable),
   paired by place in the loop's cycle (simulate: step by step; identify:
   iteration by iteration, frame by frame): each side's mean time of
   the counted steps, and their ratio.  Measured first, before the
   profiler or the sync check has run in the process.
2. **Host reads.** A few steps under ``torch.cuda.set_sync_debug_mode``:
   every synchronizing call is put down to the innermost span open on its
   thread.  One inside a span that ends up a leaf breaks the placement
   rule (a span boundary at every host read).
3. **Coverage and clock.** Two steps under ``torch.profiler`` (CUDA
   activity), lined up with the spans' device clock by one offset (the
   one that best lines the two clocks up): the device time of kernels
   outside every leaf span's device interval, as a share of the busy
   time (also without the copies to the host: the host reads, which sit
   between leaves by design, and the loop's image copy after the
   program's last span of a step); how far any kernel hangs out of the
   leaf it falls in (us); and the same with one offset for each half of
   the stretch, with the two offsets' difference (the drift between the
   profiler's clock and the events').  Device ops named after a span are
   counted too (there must be none: the spans open no range).

Writes one JSON line a cell to ``--out`` and prints it.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsmpm_tpu_torch.utils import spans  # noqa: E402
from portbench import run as pr  # noqa: E402


def _loop(bench, workload, seed):
    c = pr.cell(bench, workload)
    mix = c["mix"]
    mod = pr._load(pr.HERE / "loops" / f"{mix['loop']}.py",
                   f"portbench_loop_{mix['loop']}")
    loop = mod.Loop(c["config"], mix, seed, "cuda", span=pr.Spans())
    loop.setup()
    return loop


def _to_position(loop, at):
    while loop.position() != at:
        loop.step(keep=False)


def host_reads(loop, n_steps):
    """The synchronizing calls of n_steps steps, by the innermost open span
    and whether that span is a leaf."""
    hits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = spans.RECORDER._stack()
        top = stack[-1] if stack else None
        # the innermost frame of the program or the loop: where the read is
        at = next((f"{Path(f.filename).name}:{f.lineno} {f.name}"
                   for f in reversed(traceback.extract_stack()[:-1])
                   if "gsmpm_tpu_torch" in f.filename
                   or "portbench" in f.filename), "?")
        hits.append((None if top is None else top.id,
                     "(none)" if top is None else top.name, at))

    r0 = spans.RECORDER.request
    with warnings.catch_warnings():   # restores showwarning and the filters
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n_steps):
                loop.step(keep=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    recs = [r for r in spans.records() if r["request"] > r0]
    parents = {r["parent"] for r in recs}
    leaf = {r["id"] for r in recs if r["id"] not in parents}
    out = {}
    for sid, name, at in hits:
        key = f"{name}{' (leaf)' if sid in leaf else ''} @ {at}"
        out[key] = out.get(key, 0) + 1
    bad = sum(n for k, n in out.items() if " (leaf) @ " in k)
    return dict(by_span=out, inside_leaves=bad)


def _uncovered(kern, starts, ends, d):
    """Kernel time (us) whose middle falls in no leaf after offset d."""
    mid = (kern[:, 0] + kern[:, 1]) / 2 + d
    i = np.searchsorted(starts, mid, side="right") - 1
    inside = (i >= 0) & (mid <= ends[np.maximum(i, 0)])
    return float(((kern[:, 1] - kern[:, 0]) * ~inside).sum()), inside, i


def _align(kern, starts, ends, d0=None, reach=2000.0):
    """The one offset (us) that lines the kernels up with the leaves: from
    ``d0`` (default: the first leaf's start on the first kernel's), the
    best within +-``reach`` us by uncovered time, then centred in the
    interval that encloses every assigned kernel.  Returns (offset,
    uncovered us, inside, leaf index, each inside kernel's overhang us)."""
    if d0 is None:
        d0 = starts[0] - kern[0, 0]
    grid = d0 + np.arange(-reach, reach, 1.0)
    scores = [_uncovered(kern, starts, ends, d)[0] for d in grid]
    d = float(grid[int(np.argmin(scores))])
    for _ in range(3):
        _, inside, i = _uncovered(kern, starts, ends, d)
        lo = float(np.max(starts[i[inside]] - kern[inside, 0]))
        hi = float(np.min(ends[i[inside]] - kern[inside, 1]))
        d = 0.5 * (lo + hi)
    out_us, inside, i = _uncovered(kern, starts, ends, d)
    over = np.maximum(np.maximum(starts[i[inside]] - (kern[inside, 0] + d),
                                 (kern[inside, 1] + d) - ends[i[inside]]),
                      0.0)
    return d, out_us, inside, i, over


def coverage(loop, n_steps=2):
    """Kernels against the leaf spans' device intervals over n_steps
    profiled steps."""
    torch.cuda.synchronize()
    r0 = spans.RECORDER.request
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            loop.step(keep=False)
        torch.cuda.synchronize()
    recs = [r for r in spans.records() if r["request"] > r0]
    names = {r["name"] for r in recs}
    ops = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CPU),
                 key=lambda o: o[1])
    named = sum(1 for n, _, _ in ops if n in names)
    parents = {r["parent"] for r in recs}
    leaves = sorted((r for r in recs if r["id"] not in parents
                     and r["dev_start"] is not None),
                    key=lambda r: r["dev_start"])
    starts = np.array([r["dev_start"] * 1e6 for r in leaves])
    ends = np.array([r["dev_end"] * 1e6 for r in leaves])
    kern = np.array([(s, e) for _, s, e in ops], dtype=np.float64)
    if not len(kern) or not len(leaves):
        return dict(error="no kernels or no timed leaves", ops=len(ops),
                    leaves=len(leaves))
    busy = 0.0
    cur_s = cur_e = None
    for s, e in kern:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    d, out_us, inside, i, over = _align(kern, starts, ends)
    # the same with one offset for each half of the stretch: how far the
    # profiler's clock drifts from the events' over it
    half = len(kern) // 2
    halves = [_align(k, starts, ends, d, reach=100.0)
              for k in (kern[:half], kern[half:])]
    worst = {}
    to_host = 0.0
    for (n, s, e), ok in zip(ops, inside):
        if not ok:
            worst[n[:60]] = worst.get(n[:60], 0.0) + (e - s)
            if n.startswith("Memcpy DtoH"):
                to_host += e - s
    by_leaf = {}
    for r in leaves:
        by_leaf[r["name"]] = by_leaf.get(r["name"], 0) + 1
    k_in = np.flatnonzero(inside)
    w = int(np.argmax(over))
    worst_at = [ops[k_in[w]][0][:60], leaves[i[k_in[w]]]["name"]]
    return dict(kernels=len(kern), leaves=len(leaves), leaf_names=by_leaf,
                overhang_worst=worst_at,
                busy_us=busy, uncovered_us=out_us,
                uncovered_share=out_us / busy,
                uncovered_share_no_dtoh=(out_us - to_host) / busy,
                uncovered_top=sorted(worst.items(), key=lambda kv: -kv[1])[:8],
                offset_us=d, overhang_max_us=float(over.max()),
                overhang_max_us_halves=[float(h[4].max()) for h in halves],
                offset_drift_us=halves[1][0] - halves[0][0],
                overhang_p99_us=float(np.quantile(over, 0.99)),
                ops_named_after_spans=named)


def cost(loop, pairs, cycle):
    """Counted steps' summed seconds with the recorder on and off, in
    turns (ABBA), ``cycle`` steps a turn."""
    on, off = [], []
    order = []
    for p in range(pairs):
        order += [True, False] if p % 2 == 0 else [False, True]
    for state in order:
        spans.enable(state)
        got = []
        for _ in range(cycle):
            r = loop.step(keep=False)
            if r["fit"]:
                got.append(r["s"])
        (on if state else off).append(got)
    spans.enable(True)
    pair = [sum(a) / sum(b) for a, b in zip(on, off)]
    return dict(turns=len(order), steps_a_turn=cycle,
                on_ms=[1e3 * sum(t) / len(t) for t in on],
                off_ms=[1e3 * sum(t) / len(t) for t in off],
                ratio_median=statistics.median(pair),
                ratio_all=sum(map(sum, on)) / sum(map(sum, off)),
                ratios=pair)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--seed", type=int, default=2_718_281_828)
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--out", default="chiprun_out/span_check.jsonl")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = pr._json(pr.ROOT / "BENCHMARK.json")
    cells = (a.cells.split(",") if a.cells
             else [w["name"] for w in bench["workloads"]])
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    for wl in cells:
        t0 = time.perf_counter()
        spans.clear()
        loop = _loop(bench, wl, a.seed)
        cycle = getattr(loop, "cycle", 1)
        if cycle > 1:   # from an appearance step: one of each kind
            _to_position(loop, 0)
        res = dict(cell=wl, device=torch.cuda.get_device_name(0),
                   setup_s=time.perf_counter() - t0)
        # the cost first: the profiler's and the sync check's state must not
        # weigh on either side
        res["cost"] = cost(loop, a.pairs if cycle == 1 else
                           max(2, a.pairs // 4) * 2, cycle if cycle > 1
                           else 4)
        res["host_reads"] = host_reads(loop, 3)
        if cycle > 1:
            _to_position(loop, 10)
        res["coverage"] = coverage(loop)
        res["dropped"] = spans.dropped
        res["seconds"] = time.perf_counter() - t0
        line = json.dumps(res)
        print(line, flush=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
        loop.release()
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
