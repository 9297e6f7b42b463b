"""No module of the JAX package (or JAX) in a run; nothing of the program in
the reference.  Top-level names, compared whole: the port's name begins
with the JAX package's."""

import json
import subprocess
import sys

from portbench.tests import tiny

ROOT = str(tiny.ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "gsmpm_tpu"}


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "c = 'lego_jelly.sim_render'\n"
        "r = run.run_cell(tiny.bench(), c, 3, 0.2, False, device='cpu',\n"
        "                 overrides=tiny.overrides(c))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _modules(code)
    assert not mods & FORBIDDEN
    assert "gsmpm_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys, torch\n"
        "from portbench.reference import loss, mpm, splat\n"
        "x = torch.rand(64, 3) * 0.5 + 0.75\n"
        "st = mpm.initial_state(x, torch.tensor([[1e-4, 0, 0, 1e-4, 0, 1e-4]])"
        ".expand(64, 6), 8, 2.0, 100.0)\n"
        "mu, lam = mpm.mu_lam(torch.full((64,), 4.0), torch.zeros(64))\n"
        "st = mpm.run(st, mu, lam, mpm.law('fitting'), [0, -9.8, 0], 1e-3,\n"
        "             2, 8, 2.0, mpm.grid_bcs([{'type': 'sticky_ground'}]))\n"
        "cam = splat.ring_cameras(x.mean(0).numpy(), 32)[0]\n"
        "img = splat.image(x, mpm.covariance(st['F'], st['init_cov']),\n"
        "                  torch.full((64,), 0.5), torch.zeros(64, 16, 3),\n"
        "                  cam,\n"
        "                  torch.ones(3))\n"
        "loss.photometric(img, img)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _modules(code)
    assert not mods & (FORBIDDEN | {"gsmpm_tpu_torch"})


def test_the_harness_refuses_without_a_card_or_the_program(tmp_path):
    import shutil

    for where, copy in ((ROOT, False), (str(tmp_path), True)):
        if copy:
            shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench")
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "lego_jelly.sim_render", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": where,
                              "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert out.stdout.strip() == ""
