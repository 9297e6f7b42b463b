"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root: the
cell's configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<mix>.json``, whose ``loop`` names the general loop in
``portbench/loops/``), its limits (``portbench/limits/<cell>.json``) and,
with ``--trace 1``, each per-layer metric's reader
(``portbench/metrics/<metric>.py``).

A run: set-up (the program's set-up and warm-up steps, all counted in
``setup_s``), a closed-loop window of ``--seconds`` in which each step
starts when the last one ended, with ``--trace 1`` a short profiled stretch
right after it, then the check: the program's state is released and the
reference recomputes the steps the seed sampled.  The last line on standard
output is one JSON object; the numbers compared and their limits are also
the last lines on standard error.
"""

from __future__ import annotations

import time

T_START = time.time()


def _process_age() -> float:
    """Seconds since this process started (Linux), so that set-up counts
    the interpreter's start too; 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        import os as _os

        return max(0.0, up - start_ticks / _os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START -= _process_age()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from portbench import readers  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gsmpm_tpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, workload: str) -> Dict:
    """The cell's entry, its configuration, mix and limits, all by name."""
    w = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return dict(workload=w, config=_json(ROOT / conf["file"]),
                mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{workload}.json"))


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port's runs must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def quantile(values: List[float], q: float) -> float:
    """The q-th quantile of every value (Python's exclusive method)."""
    if len(values) < 2:
        return float(max(values, default=float("nan")))
    n = 100
    return float(statistics.quantiles(values, n=n)[int(q * n) - 1])


class Spans:
    """Host spans of the benchmark's own calls, as profiler ranges while a
    profile records them."""

    def __init__(self):
        self.profiling = False

    def __call__(self, name: str):
        if not self.profiling:
            return nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")


def sample(seed: int, within: int, k: int, eligible) -> List[int]:
    """k step indices below ``within`` drawn from the seed among those
    ``eligible(i)`` accepts."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pool = [i for i in range(within) if eligible(i)]
    return sorted(int(i) for i in rng.choice(pool, size=min(k, len(pool)),
                                             replace=False))


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None) -> Dict:
    """One run of one cell; returns the result object."""
    import torch

    c = cell(bench, workload)
    cfg, mix, limits = c["config"], c["mix"], c["limits"]
    for key, val in (overrides or {}).items():   # tests: tiny sizes
        (cfg if key in cfg else mix)[key] = val
    loop_mod = _load(HERE / "loops" / f"{mix['loop']}.py",
                     f"portbench_loop_{mix['loop']}")
    spans = Spans()
    loop = loop_mod.Loop(cfg, mix, seed, device, span=spans)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    loop.setup()
    # which steps the check keeps, drawn from the seed
    per = getattr(loop, "cycle", 1)
    keep = set(sample(seed, int(mix["check_within"]), int(mix["check_steps"]),
                      lambda i: i % per != 0 if per > 1 else True))
    # and, where the mix asks, steps that the end-to-end metrics do not
    # count (an iteration's appearance step)
    if per > 1 and mix.get("check_uncounted"):
        keep |= set(sample(seed, int(mix["check_within"]),
                           int(mix["check_uncounted"]),
                           lambda i: i % per == 0))
    if cuda:
        torch.cuda.synchronize(dev)
    t_window = time.time()
    setup_s = t_window - T_START
    recs = []
    t0 = time.perf_counter()
    while True:
        recs.append(loop.step(keep=len(recs) in keep))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    trace_rec = None
    if trace:
        trace_rec = profile_stretch(loop, spans, mix, dev)
        trace_rec["window_steps"] = recs
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    shape, counters = loop.shape(), loop.counters()
    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = loop.check()
    check_s = time.perf_counter() - t_check
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)

    fits = [r for r in recs if r["fit"]]
    attempted = len(fits)
    failed = sum(1 for r in fits if r["n_dropped"])
    need = min(len(keep), sum(1 for i in keep if i < len(recs)))
    checks = []
    correct = numbers.get("frames_checked", 0) >= max(need, 1)
    for name, limit in limits.items():
        v = numbers[name]
        ok = bool(np.isfinite(v) and v <= limit)
        correct = correct and ok
        checks.append(dict(name=name, value=v, limit=limit))
    checks.append(dict(name="frames_checked",
                       value=numbers.get("frames_checked", 0),
                       limit=f">= {max(need, 1)}"))
    correct = correct and failed == 0

    if trace:
        metrics = layer_metrics(bench, workload, trace_rec)
    else:
        metrics = e2e_metrics(bench, workload, recs, window_s, setup_s,
                              mix["end_to_end"])
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_rec = dict(platform="gpu" if cuda else "cpu", kind=kind, count=1,
                      memory_peak_bytes=int(memory_peak))
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=device_rec)
    if trace:
        device_rec.update(busy_s=trace_rec["busy_s"],
                          window_s=trace_rec["window_s"])
        result["breakdown"] = trace_rec["breakdown"]
        result["trace_pace"] = readers.pace(trace_rec)
    result["detail"] = dict(window_s=window_s, steps=len(recs),
                            check_s=check_s,
                            engines=sorted({r["engine"] for r in recs}),
                            rerenders=sum(r.get("rerenders", 0) for r in recs),
                            rebuilds=sum(r.get("rebuilds", 0) for r in recs),
                            counters=counters, shape=shape, seed=seed)
    result["checks"] = checks
    return result


def e2e_metrics(bench: Dict, workload: str, recs, window_s, setup_s,
                scale: Dict) -> Dict:
    """The cell's end-to-end metrics: the window's wall time over the steps
    it completed (the counted steps are those with ``fit`` set), the 90th
    percentile of those steps' times, and the set-up time."""
    fits = [r["s"] for r in recs if r["fit"]]
    vals = {"per_step": window_s / max(len(fits), 1) * 1e3,
            "p90": quantile(fits, 0.9) * 1e3, "setup_s": setup_s}
    out = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        what = scale.get(m["name"], m["name"])
        out[m["name"]] = dict(value=vals[what], unit=m["unit"])
    return out


def layer_metrics(bench: Dict, workload: str, rec: Dict) -> Dict:
    """Each per-layer metric of this cell, read by its own reader; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = _load(HERE / "metrics" / f"{m['name']}.py",
                       "portbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def profile_stretch(loop, spans, mix: Dict, dev) -> Dict:
    """The mix's ``trace_steps`` more steps under torch.profiler: the
    trace record the metric readers take (portbench/trace.py)."""
    import torch

    from portbench import trace

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    # start on a counted step, at the mix's place in the cycle if it names
    # one, so that every run profiles the same kind of step
    at = mix.get("trace_from")
    if at is not None:
        at = int(at) % getattr(loop, "cycle", 1)
    while not loop.next_counted() or (at is not None
                                      and loop.position() != at):
        loop.step(keep=False)
    c0 = loop.counters()
    spans.profiling = True
    recs = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(int(mix["trace_steps"])):
            recs.append(loop.step(keep=False))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    spans.profiling = False
    c1 = loop.counters()
    return trace.record(prof, window_s, recs, loop.shape(),
                        {k: c1[k] - c0[k] for k in c1})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))
    bench_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "gsmpm_tpu_torch").is_dir():
        print("gsmpm_tpu_torch is not beside portbench: nothing to measure",
              file=sys.stderr)
        return 2
    bench = _json(bench_path)
    w = next((c for c in bench["workloads"] if c["name"] == a.workload), None)
    if w is None:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {w['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace)))
    return 0


def emit(result: Dict) -> None:
    """The compared numbers with their limits as the last lines on standard
    error, then the result as the last line on standard output, its
    ``checks`` key last."""
    checks = result.pop("checks")
    for ch in checks:
        print(f"check {ch['name']}: {ch['value']!r} (limit {ch['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {ch["name"]: dict(value=ch["value"], limit=ch["limit"])
                        for ch in checks}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
