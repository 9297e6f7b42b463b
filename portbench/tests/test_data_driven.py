"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files plus entries in BENCHMARK.json, and edits no file the
benchmark has: in a copy of portbench/, run the new cell at a tiny size."""

import hashlib
import json
import shutil
import subprocess
import sys

from portbench.tests import tiny

ROOT = tiny.ROOT


def _digests(top):
    return {str(p.relative_to(top)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    before = _digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = tiny.config("lego_jelly")
    cfg.update(name="lego_small")
    cfg["sim_config"]["mpm"]["E"] = 1e5
    (pb / "configs" / "lego_small.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "sim_render.json").read_text())
    mix.update(what="one warm-up frame", warmup_frames=1)
    (pb / "traffic" / "sim_short.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps_traced.sim.py").write_text(
        '"""steps_traced.sim: the counted steps of the traced stretch."""\n\n'
        "\ndef read(rec):\n"
        '    return float(sum(1 for r in rec["steps"] if r["fit"]))\n')
    (pb / "limits" / "lego_small.sim_short.json").write_text(
        (pb / "limits" / "lego_jelly.sim_render.json").read_text())
    bench = tiny.bench()
    bench["configs"].append(dict(bench["configs"][0], name="lego_small",
                                 file="portbench/configs/lego_small.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="lego_small.sim_short",
                                   config="lego_small", traffic="sim_short"))
    for m in bench["end_to_end"]:
        if "lego_jelly.sim_render" in m.get("workloads", []):
            m["workloads"].append("lego_small.sim_short")
    bench["per_layer"].append(dict(
        name="steps_traced.sim", unit="steps", better="higher",
        source="program_counter", layer="frame loop", moves="frame_ms",
        workloads=["lego_small.sim_short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(pb)
    assert all(after[k] == v for k, v in before.items())

    code = (
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "b = run._json(run.ROOT / 'BENCHMARK.json')\n"
        "c = 'lego_small.sim_short'\n"
        "ov = tiny.overrides('lego_jelly.sim_render')\n"
        "ov['sim_config']['mpm']['E'] = 1e5\n"
        "out = [run.run_cell(b, c, 11, 0.3, t, device='cpu', overrides=ov)\n"
        "       for t in (False, True)]\n"
        "res = [o['metrics'] for o in out] + [out[0]['correct']]\n"
        "print(json.dumps(res))\n")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin",
             "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert res.returncode == 0, res.stderr[-3000:]
    e2e, layer, correct = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(e2e) == {"frame_ms", "frame_p90_ms", "setup_s"}
    assert layer["steps_traced.sim"]["value"] == 1.0
    assert correct is True
