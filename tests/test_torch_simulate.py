"""The whole slice: gsmpm_tpu_torch.apps.simulate vs gsmpm_tpu.apps.simulate.

On the CPU the JAX app takes its XLA engine and XLA renderer (which its own
tests hold equal to the tiled and stream paths); the port takes its TPU
route on every device (tiled engine + stream renderer, here through the
kernels' plain twins).
"""

import json
import os
import struct
import zlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsmpm_tpu.apps.simulate import simulate as jax_simulate
from gsmpm_tpu.config import SimConfig

from gsmpm_tpu_torch.apps import simulate as tsim
from gsmpm_tpu_torch.config import SimConfig as TSimConfig
from gsmpm_tpu_torch.io.video import encode_png
from gsmpm_tpu_torch.models.gaussians import GaussianScene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by ``encode_png`` -> (H, W, C) uint8 (filter 0 only)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat = 8, b""
    w = h = c = None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, ct = struct.unpack(">IIBB", body[:10])
            c = 3 if ct == 2 else 4
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if np.any(raw[:, 0]):
        raise ValueError("only filter type 0 is supported")
    return raw[:, 1:].reshape(h, w, c)

# n_grid 16, 10 substeps per frame, lego-like jelly falling onto the
# ground collider
CONFIG = {
    "mpm": {"n_grid": 16, "E": 2e5, "nu": 0.3, "material": "jelly",
            "density": 200.0, "substep_dt": 1e-3, "frame_dt": 1e-2,
            "gravity": [0.0, 0.0, -9.8]},
}
# the same with every boundary-condition type the app builds from a config,
# SH rotation by the polar R of F, and a white background
CONFIG_BCS = {
    "model": {"white_background": True},
    "mpm": dict(CONFIG["mpm"], rotate_sh=True, boundary_conditions=[
        {"type": "impulse", "center": [1.0, 1.0, 1.0], "size": [0.3, 0.3, 0.3],
         "force": [0.0, 2.0, 0.0], "start_time": 0.0, "num_dt": 15},
        {"type": "fixed_cube", "center": [1.0, 1.0, 0.6], "size": [0.2, 0.2, 0.1],
         "start_time": 0.0, "num_dt": 100},
        {"type": "additional_params", "center": [1.2, 1.0, 1.0],
         "size": [0.2, 0.3, 0.3], "E": 5e4, "nu": 0.25, "density": 300.0},
        {"type": "modify_material", "center": [0.8, 1.0, 1.0],
         "size": [0.2, 0.3, 0.3], "material": "metal"},
    ]),
}


def _config(tmp_path, name, base=CONFIG, **render):
    cfg = json.loads(json.dumps(base))
    cfg["render"] = {"output_path": str(tmp_path / name), **render}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("base", [CONFIG, CONFIG_BCS], ids=["plain", "bcs"])
def test_simulate_matches_jax(tmp_path, base):
    want = jax_simulate(SimConfig.from_json(_config(tmp_path, "jax", base)),
                        synthetic=512, frames=2, quiet=True, mesh="none",
                        synthetic_res=64)
    stats = {}
    got = tsim.simulate(TSimConfig.from_json(_config(tmp_path, "port", base)),
                        synthetic=512, frames=2, quiet=True, synthetic_res=64,
                        device="cpu", stats=stats)
    assert len(got) == len(want) == 3
    assert stats["n_dropped"] == [0, 0, 0]
    assert stats["substeps_per_frame"] == 10
    for a, b in zip(want, got):
        assert b.shape == (64, 64, 3)
        # f32 rounding of two engines (scatter/gather vs tiled transfers)
        # over 20 substeps, then two renderers (XLA blend vs stream blend)
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-4)
    assert np.abs(got[-1] - got[0]).max() > 1e-3  # the scene moved
    pngs = sorted((tmp_path / "port" / "images").glob("*.png"))
    assert [p.name for p in pngs] == ["0000.png", "0001.png", "0002.png"]
    np.testing.assert_array_equal(
        decode_png(pngs[-1].read_bytes()),
        (255 * np.clip(got[-1], 0, 1)).astype(np.uint8))


def test_import_pulls_in_neither_jax_nor_gsmpm_tpu():
    code = (
        "import sys, gsmpm_tpu_torch.apps.simulate, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'gsmpm_tpu')\n"
        "             or m.startswith(('jax.', 'gsmpm_tpu.')))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import gsmpm_tpu\.|"
                     r"from gsmpm_tpu[ .])", re.M)
    files = sorted((REPO / "gsmpm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_point_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TSimConfig.from_json(_config(tmp_path, "nocuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate(cfg, synthetic=64, frames=1, quiet=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.main(["--config_path", _config(tmp_path, "nocuda"),
                   "--synthetic", "64", "--frames", "1"])


def test_cli_runs_on_cpu_and_rejects_unported_flags(tmp_path):
    path = _config(tmp_path, "cli", save_pcd_interval=1)
    tsim.main(["--config_path", path, "--synthetic", "256", "--frames", "1",
               "--synthetic_res", "64", "--device", "cpu", "--save_pcd"])
    assert len(list((tmp_path / "cli" / "images").glob("*.png"))) == 2
    pcd = tmp_path / "cli" / "point_cloud" / "iteration_1" / "point_cloud.ply"
    moved = GaussianScene.from_ply(str(pcd))
    assert moved.num_gaussians == 256
    assert torch.isfinite(moved.xyz).all()
    # --resume is accepted (no checkpoint under output_path: a fresh run)
    tsim.main(["--config_path", path, "--synthetic", "256", "--frames", "1",
               "--synthetic_res", "64", "--device", "cpu", "--resume"])
    # the halo engines are not ported, nor is identify's --mesh
    with pytest.raises(SystemExit):
        tsim.main(["--config_path", path, "--synthetic", "256",
                   "--device", "cpu", "--mesh", "data=2,engine=halo"])
    from gsmpm_tpu_torch.apps import identify as tident

    with pytest.raises(SystemExit):
        tident.main(["--synthetic", "64", "--device", "cpu",
                     "--mesh", "data=2"])


def test_png_codec_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), img)
