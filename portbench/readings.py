"""Readings for a cell's limits: the compared numbers of sound runs of the
program and of the control, over many seeds in one process.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \
        --seconds 6 [--control] [--keep N | --steps 0,3]
        [--fault unchanged|half|altered]

For each seed: the cell's set-up, a window of ``--seconds`` (keeping the
steps the seed samples, the first N counted steps with ``--keep``, or the
window's steps ``--steps`` names), the
check of the program and, with ``--control``, the check of the control:
the reference itself in bfloat16, the precision below the configuration's
float32, put in the program's place.  ``--fault`` plants one of
portbench/faults.py's faults in the program for the whole run.  One JSON
line a seed.  The
benchmark's own runs never run the control; the limits in
portbench/limits/ are set from these readings (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="",
                   help="a fault of portbench/faults.py planted in the run")
    p.add_argument("--keep", type=int, default=0,
                   help="keep the first N counted steps instead of a sample")
    p.add_argument("--steps", default="",
                   help="keep these steps of the window (0 is an "
                        "iteration's appearance step)")
    a = p.parse_args(argv)
    bench = run._json(run.ROOT / "BENCHMARK.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in a.seeds.split(",")):
        c = run.cell(bench, a.workload)
        mix = c["mix"]
        mod = run._load(run.HERE / "loops" / f"{mix['loop']}.py",
                        f"portbench_loop_{mix['loop']}")
        loop = mod.Loop(c["config"], mix, seed, "cuda", span=run.Spans())
        stack = contextlib.ExitStack()
        if a.fault:
            stack.enter_context(faults.planted(a.fault, mix["loop"]))
        t0 = time.perf_counter()
        loop.setup()
        per = getattr(loop, "cycle", 1)
        counted = (lambda i: i % per != 0) if per > 1 else (lambda i: True)
        if a.steps:
            keep = [int(i) for i in a.steps.split(",")]
        elif a.keep:
            keep = [i for i in range(10 * a.keep) if counted(i)][:a.keep]
        else:
            keep = run.sample(seed, int(mix["check_within"]),
                              int(mix["check_steps"]), counted)
        t1 = time.perf_counter()
        steps = []
        while (time.perf_counter() - t1 < a.seconds
               or len(steps) <= max(keep)):
            steps.append(loop.step(keep=len(steps) in keep))
        t2 = time.perf_counter()
        stack.close()
        loop.release()
        torch.cuda.empty_cache()
        out = dict(seed=seed, setup_s=t1 - t0, window_s=t2 - t1,
                   steps=len(steps), program=loop.check())
        t3 = time.perf_counter()
        if a.control:
            out["control"] = loop.check(dtype=torch.bfloat16)
        out.update(check_s=t3 - t2, control_s=time.perf_counter() - t3)
        print(json.dumps(out), flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
