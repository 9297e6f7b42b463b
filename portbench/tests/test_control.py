"""The control: the reference itself in bfloat16, the precision below the
configuration's float32, put in the program's place, is judged not
correct by the cell's limits; the sound program at the same size is."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests import tiny

CELLS = ["lego_jelly.sim_render", "torus_sysid.fit_windowed"]


def _loop(cell, seed):
    c = run.cell(tiny.bench(), cell)
    cfg, mix = c["config"], c["mix"]
    for k, v in tiny.overrides(cell).items():
        (cfg if k in cfg else mix)[k] = v
    mod = run._load(run.HERE / "loops" / f"{mix['loop']}.py",
                    f"portbench_loop_{mix['loop']}")
    loop = mod.Loop(cfg, mix, seed, "cpu", span=run.Spans())
    loop.setup()
    # every step kept: an identify cell's first is its appearance step
    for _ in range(getattr(loop, "cycle", 1) + 1):
        loop.step(keep=True)
    loop.release()
    return loop, c["limits"]


def _fails(numbers, limits):
    return [n for n, lim in limits.items()
            if not (np.isfinite(numbers[n]) and numbers[n] <= lim)]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    loop, limits = _loop(cell, 777)
    assert not _fails(loop.check(), limits)
    assert _fails(loop.check(dtype=torch.bfloat16), limits)


def test_control_fails_the_appearance_step():
    loop, limits = _loop("torus_sysid.fit_windowed", 778)
    app = {n: lim for n, lim in limits.items() if n.startswith("app_")}
    assert app and not _fails(loop.check(), app)
    assert _fails(loop.check(dtype=torch.bfloat16), app)
