"""simulate's route to the golden engine vs gsmpm_tpu.

- the golden substep with ``incremental_cov`` (cov advanced every substep
  by dt (grad v cov + cov grad v^T)) against gsmpm_tpu's planes engine;
- ``apps.simulate`` with ``incremental_cov`` (the golden engine for every
  frame) against ``gsmpm_tpu.apps.simulate`` frame for frame;
- ``apps.simulate`` with an occupied-tile cap below the bootstrap
  occupancy, and at it with a scene pushed into new tiles in its second
  frame: the frame is redone on the golden engine, which runs from there
  on, and every frame equals the JAX app's (on the CPU the JAX app takes
  its XLA engine for every frame).

The frames go through two renderers: the JAX app's XLA blend and the
port's stream blend.  The golden-engine-only scene agrees to 2e-4; the
pushed scene's frames are held to the JAX package's own stream-vs-XLA
tolerance (tests/test_torch_stream_raster.py) but at one pixel, where a
splat's alpha sits on the alpha_min skip threshold and one blend adds it,
the other not (that pixel to alpha_min); its particle state after every
frame (both apps' checkpoints) is held to 1e-5 of each field's max (C
1e-4), so the route check does not rest on the renderers.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.apps.simulate import simulate as jax_simulate
from gsmpm_tpu.config import MPMConfig, SimConfig
from gsmpm_tpu.sim.boundary import BCSet, make_surface_collider
from gsmpm_tpu.sim.solver import run_substeps
from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
from gsmpm_tpu.sim.volume import particle_volume

from gsmpm_tpu_torch.apps import simulate as tsim
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.config import SimConfig as TSimConfig
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim.solver import run_substeps as t_run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.io.checkpoint import restore_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_golden_substeps_with_incremental_cov_match_jax():
    """5 golden substeps with incremental_cov: cov (never postprocessed
    here) and the rest of the state."""
    n = 400
    kw = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
              substep_dt=1e-3, frame_dt=1e-2, density=200.0)
    cfg = MPMConfig(**kw)
    rng = np.random.default_rng(7)
    xyz = jnp.asarray(rng.uniform(0.5, 1.5, size=(n, 3)).astype(np.float32))
    A = 0.01 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = jnp.asarray(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    v0 = jnp.asarray(2.0 * rng.normal(size=(n, 3)).astype(np.float32))
    state = init_state(xyz, cov6, particle_volume(xyz, 16, 2.0), cfg, v0)
    bcs = BCSet(grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    stj, tj = run_substeps(state, init_model(cfg, n), bcs, jnp.float32(0.0),
                           5, GridConfig(16, 2.0), cfg.substep_dt,
                           incremental_cov=True, checkpoint_policy=None)

    t_bcs = tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.4),
                                                        (0, 0, 1)),))
    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    st, t = t_run_substeps(t_state, t_init_model(TMPMConfig(**kw), n, "cpu"),
                           t_bcs, 0.0, 5, TGridConfig(16, 2.0),
                           cfg.substep_dt, checkpoint_policy=None,
                           incremental_cov=True)
    assert t == float(tj)
    moved = np.abs(np.asarray(stj.cov) - np.asarray(state.cov)).max()
    assert moved > 1e-3 * np.abs(np.asarray(state.cov)).max()
    for name in ("x", "v", "C", "F", "F_trial", "cov"):
        want = np.asarray(getattr(stj, name))
        got = getattr(st, name).numpy()
        # index_add_ vs scatter-add order over 5 substeps: 1e-5 of the
        # field's max
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


# tests/test_torch_simulate.py's CONFIG
SMALL = {"mpm": {"n_grid": 16, "E": 2e5, "nu": 0.3, "material": "jelly",
                 "density": 200.0, "substep_dt": 1e-3, "frame_dt": 1e-2,
                 "gravity": [0.0, 0.0, -9.8]}}
# n_grid 32, so the scene occupies 9 of the 64 tiles at boot; an impulse
# throws it along +y for 5 substeps and its particles enter 4 more tiles at
# the rebucket in substep 5 of frame 2
PUSHED = {"mpm": dict(SMALL["mpm"], n_grid=32, boundary_conditions=[
    {"type": "impulse", "center": [1.0, 1.0, 1.0], "size": [1.0, 1.0, 1.0],
     "force": [0.0, 50.0, 0.0], "start_time": 0.0, "num_dt": 5}])}
N_PUSHED = 2048
RES_PUSHED = 64
BOOT_OCC = 9


def _config(tmp_path, name, base, **mpm):
    cfg = json.loads(json.dumps(base))
    cfg["mpm"].update(mpm)
    cfg["render"] = {"output_path": str(tmp_path / name)}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _same_frames(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        # f32 rounding of two engines over 20 substeps, then two renderers
        # (XLA blend vs stream blend): test_simulate_matches_jax's atol
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4)
    assert np.abs(got[-1] - got[0]).max() > 1e-3  # the scene moved


def test_incremental_cov_app_matches_jax(tmp_path):
    want = jax_simulate(
        SimConfig.from_json(_config(tmp_path, "jax", SMALL,
                                    incremental_cov=True)),
        synthetic=512, frames=2, quiet=True, mesh="none", synthetic_res=64)
    stats = {}
    got = tsim.simulate(
        TSimConfig.from_json(_config(tmp_path, "port", SMALL,
                                     incremental_cov=True)),
        synthetic=512, frames=2, quiet=True, synthetic_res=64, device="cpu",
        stats=stats)
    assert stats["engine"] == ["golden", "golden"]
    assert stats["n_dropped"] == [0, 0, 0]
    _same_frames(got, want)
    assert len(list((tmp_path / "port" / "images").glob("*.png"))) == 3


@pytest.fixture(scope="module")
def jax_pushed(tmp_path_factory):
    """The JAX app's frames and checkpoint directory (one a frame)."""
    root = tmp_path_factory.mktemp("pushed")
    frames = jax_simulate(SimConfig.from_json(_config(root, "jax", PUSHED)),
                          synthetic=N_PUSHED, frames=2, quiet=True,
                          mesh="none", synthetic_res=RES_PUSHED,
                          checkpoint_interval=1)
    return frames, str(root / "jax" / "checkpoints")


STATE_FIELDS = ("x", "v", "F", "F_trial", "C", "cov")
# tests/test_torch_parallel.py's: C, the velocity field's moments scaled by
# 4 / dx^2, 1e-4
RTOL = dict(x=1e-5, v=1e-5, F=1e-5, F_trial=1e-5, C=1e-4, cov=1e-5)


@pytest.mark.parametrize("cap,engines", [
    (BOOT_OCC - 1, ["golden", "golden"]),   # overflows at bootstrap
    (BOOT_OCC, ["tiled", "golden"]),        # overflows in frame 2
], ids=["boot", "mid_frame"])
def test_tile_cap_overflow_redoes_the_frame_on_golden(tmp_path, jax_pushed,
                                                      cap, engines, capsys,
                                                      monkeypatch):
    path = _config(tmp_path, "port", PUSHED)
    su = tsim.prepare(TSimConfig.from_json(path), N_PUSHED, RES_PUSHED,
                      "cpu", True)
    real = tsim.default_tile_config
    monkeypatch.setattr(tsim, "default_tile_config",
                        lambda g, n: real(g, n)._replace(n_occ_cap=cap))
    stats = {}
    got = tsim.simulate(TSimConfig.from_json(path), synthetic=N_PUSHED,
                        frames=2, quiet=False, synthetic_res=RES_PUSHED,
                        device="cpu", stats=stats, checkpoint_interval=1)
    assert stats["engine"] == engines
    switch = [l for l in capsys.readouterr().out.splitlines()
              if "golden engine" in l]
    assert len(switch) == 1 and f"({cap})" in switch[0]
    assert stats["n_dropped"] == [0, 0, 0]
    want, jax_ckpt = jax_pushed
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        # stream blend vs XLA blend: the JAX package's own tolerance
        # (tests/test_torch_stream_raster.py), except at a pixel where a
        # splat's alpha sits on the alpha_min = 1/255 skip threshold (frame
        # 0's pixel (30, 29): alpha 1/255 + 4e-9), which the XLA blend
        # (opacity * exp(power)) adds and the stream blend (exp(power +
        # log opacity)) skips: at most alpha_min of that pixel
        diff = np.abs(a - np.asarray(b))
        over = diff > 2e-3 + 1e-3 * np.abs(np.asarray(b))
        assert int(over.sum()) <= 1 and diff.max() <= 1.0 / 255.0
        assert diff.mean() < 5e-6
    assert np.abs(got[-1] - got[0]).max() > 1e-3  # the scene moved
    assert len(list((tmp_path / "port" / "images").glob("*.png"))) == 3
    template = (su.state, su.model, 0.0)
    for fid in (1, 2):
        (st, _, t), _, _ = restore_checkpoint(
            str(tmp_path / "port" / "checkpoints"), template, step=fid)
        (st_j, _, t_j), _, _ = restore_checkpoint(jax_ckpt, template,
                                                  step=fid)
        assert t == t_j
        for name in STATE_FIELDS:
            want_f = getattr(st_j, name)
            # the port's engines' and the XLA engine's f32 sums in other
            # orders over 10-20 substeps: RTOL of the field's max (>= 1)
            err = float((getattr(st, name) - want_f).abs().max()) \
                / max(1.0, float(want_f.abs().max()))
            assert err <= RTOL[name], (fid, name, err)
