"""Each cell's traffic mix at a tiny size on the CPU, with the kernels'
plain twins: a whole run, and the last line the contract asks for."""

import json

import pytest

from portbench import run
from portbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


def _run(cell, trace, seed=20260401):
    return run.run_cell(tiny.bench(), cell, seed, 3.0, trace, device="cpu",
                        overrides=tiny.overrides(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_mix_runs_and_prints_the_result_line(cell, capsys):
    result = _run(cell, trace=False)
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = tiny.bench()
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["device"]["platform"] == "cpu"
    # each compared number, with its limit, ends standard error
    tail = err.strip().splitlines()
    assert tail[-1].startswith("correct: ")
    assert any(t.startswith("check ") for t in tail)


# no device here: the device readers find nothing and are left out, and
# the twins replay no graph, so rerun_share.fit has nothing to read
@pytest.mark.parametrize("cell,want", [
    ("lego_jelly.sim_render", {"sim_ms.sim", "render_ms.sim"}),
    ("torus_sysid.fit_windowed", set())])
def test_traced_run_reads_the_host_metrics(cell, want):
    result = _run(cell, trace=True, seed=5)
    assert set(result["metrics"]) == want
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
