"""The port's io/checkpoint.py and simulate's --checkpoint_interval /
--resume vs gsmpm_tpu/io/checkpoint.py, and models/knn.py vs gsmpm_tpu's.

Checkpoints of the two packages share one layout (step_%08d.ckpt.npz with
leaf_0.., manifest.json): each package restores the other's files.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.io import checkpoint as jckpt
from gsmpm_tpu.sim.state import init_model, init_state
from gsmpm_tpu.sim.volume import particle_volume

from gsmpm_tpu_torch.apps import simulate as tsim
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.config import SimConfig as TSimConfig
from gsmpm_tpu_torch.io import checkpoint as tckpt
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim.solver import run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
          substep_dt=1e-4, frame_dt=1e-2, density=200.0)


def _jax_setup(n=256):
    """tests/test_checkpoint.py's problem on the JAX side."""
    cfg = MPMConfig(**KW)
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0.6, 1.4, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.asarray([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    vol = particle_volume(jnp.asarray(xyz), cfg.n_grid, cfg.grid_extent)
    return init_state(jnp.asarray(xyz), jnp.asarray(cov6), vol, cfg), \
        init_model(cfg, n)


def _setup(n=256):
    """The same problem in the port."""
    state, _ = _jax_setup(n)
    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    bcs = tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.4),
                                                      (0, 0, 1)),))
    return (t_state, t_init_model(TMPMConfig(**KW), n, "cpu"), bcs,
            GridConfig(16, 2.0))


def test_roundtrip_and_latest(tmp_path):
    state, model, _, _ = _setup()
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    tckpt.save_checkpoint(d, 3, (state, model), extra={"frame": 3})
    tckpt.save_checkpoint(d, 7, (state, model), extra={"frame": 7})
    assert tckpt.latest_step(d) == 7
    (state2, model2), step, extra = tckpt.restore_checkpoint(d, (state, model))
    assert step == 7 and extra == {"frame": 7}
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state2, f.name), getattr(state, f.name))
    assert torch.equal(model2.logE, model.logE)
    assert model2.material.dtype == torch.int32
    # non-tensor fields come from the template
    assert model2.active_materials == model.active_materials
    assert model2.hardening == model.hardening
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_structure_mismatch_is_rejected(tmp_path):
    state, model, _, _ = _setup()
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 1, (state, model, 0.5))
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(d, (state, model))
    small, _, _, _ = _setup(128)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(d, (small, model, 0.5))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), (state, model))


def test_resumed_golden_substeps_equal_uninterrupted(tmp_path):
    """5 substeps + checkpoint + restore + 5 == 10, bit for bit (as
    tests/test_checkpoint.py:48)."""
    state, model, bcs, grid = _setup()
    dt = KW["substep_dt"]
    ref, ref_t = run_substeps(state, model, bcs, 0.0, 10, grid, dt,
                              checkpoint_policy=None)
    mid, mid_t = run_substeps(state, model, bcs, 0.0, 5, grid, dt,
                              checkpoint_policy=None)
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 5, (mid, model, mid_t))
    (r_state, r_model, r_t), _, _ = tckpt.restore_checkpoint(
        d, (state, model, 0.0))
    assert r_t == mid_t and isinstance(r_t, float)
    out, out_t = run_substeps(r_state, r_model, bcs, r_t, 5, grid, dt,
                              checkpoint_policy=None)
    assert out_t == ref_t
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name)), f.name


def test_manifest_and_files_match_the_jax_module(tmp_path):
    """The JAX module restores the port's checkpoint with a JAX template and
    the port restores the JAX module's; the manifests carry the same keys
    and leaf counts."""
    jstate, jmodel = _jax_setup()
    state, model, _, _ = _setup()
    dj, dt_ = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(dj, 4, (jstate, jmodel, jnp.float32(0.25)),
                          extra={"frame": 4})
    tckpt.save_checkpoint(dt_, 4, (state, model, 0.25), extra={"frame": 4})
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt_)) == [
        "manifest.json", "step_00000004.ckpt.npz"]
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    mt = json.load(open(os.path.join(dt_, "manifest.json")))
    assert sorted(mj) == sorted(mt)
    assert (mj["latest_step"], mj["n_leaves"], mj["extra"]) == \
        (mt["latest_step"], mt["n_leaves"], mt["extra"]) == (4, 23, {"frame": 4})

    (js, jm, jt), _, _ = jckpt.restore_checkpoint(
        dt_, (jstate, jmodel, jnp.float32(0.0)))
    (ts, tm, tt), _, _ = tckpt.restore_checkpoint(dj, (state, model, 0.0))
    assert float(jt) == tt == 0.25
    for f in dataclasses.fields(state):
        np.testing.assert_array_equal(np.asarray(getattr(js, f.name)),
                                      getattr(state, f.name).numpy())
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(jstate, f.name)))
    for name in ("material", "logE", "mu", "gravity", "alpha"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(model, name).numpy())
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jmodel, name)))


# tests/test_torch_simulate.py's CONFIG
APP = {"mpm": {"n_grid": 16, "E": 2e5, "nu": 0.3, "material": "jelly",
               "density": 200.0, "substep_dt": 1e-3, "frame_dt": 1e-2,
               "gravity": [0.0, 0.0, -9.8]}}


def _config(tmp_path, name, **mpm):
    cfg = json.loads(json.dumps(APP))
    cfg["mpm"].update(mpm)
    cfg["render"] = {"output_path": str(tmp_path / name)}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("engine", ["tiled", "golden"])
def test_app_resume_equals_uninterrupted(tmp_path, engine):
    """3 frames in one run vs 1 frame with --checkpoint_interval 1, then
    --resume to frame 3 (the resumed run draws frame 1 again from the
    restored state)."""
    mpm = dict(incremental_cov=True) if engine == "golden" else {}
    stats = {}
    want = tsim.simulate(TSimConfig.from_json(_config(tmp_path, "once",
                                                      **mpm)),
                         synthetic=512, frames=3, quiet=True,
                         synthetic_res=64, device="cpu", stats=stats)
    assert stats["engine"] == [engine] * 3
    path = _config(tmp_path, "resumed", **mpm)
    tsim.main(["--config_path", path, "--synthetic", "512", "--frames", "1",
               "--synthetic_res", "64", "--device", "cpu",
               "--checkpoint_interval", "1"])
    ckpt = tmp_path / "resumed" / "checkpoints"
    assert tckpt.latest_step(str(ckpt)) == 1
    got = tsim.simulate(TSimConfig.from_json(path), synthetic=512, frames=3,
                        quiet=True, synthetic_res=64, device="cpu",
                        resume=True)
    assert len(got) == 3
    # frame 1: the restored state, drawn again
    np.testing.assert_array_equal(got[0], want[1])
    for a, b in zip(got[1:], want[2:]):
        if engine == "golden":
            np.testing.assert_array_equal(a, b)
        else:
            # the tiled engine bootstraps a fresh layout on resume, so its
            # grid sums run in another order over 20 substeps
            np.testing.assert_allclose(a, b, atol=1e-5)
    pngs = sorted(p.name for p in (tmp_path / "resumed" / "images").glob("*"))
    assert pngs == ["0000.png", "0001.png", "0002.png", "0003.png"]


def test_mean_knn_dist_matches_jax():
    """Blocked k-NN mean squared distance, a block that does not divide N."""
    from gsmpm_tpu.models.knn import mean_knn_dist as j_knn

    from gsmpm_tpu_torch.models.knn import mean_knn_dist

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    want = np.asarray(j_knn(jnp.asarray(pts), k=3, block=128))
    got = mean_knn_dist(torch.from_numpy(pts), k=3, block=128).numpy()
    assert got.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ref = np.sort(d2, axis=1)[:, :3].mean(axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
