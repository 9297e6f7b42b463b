"""The port's system identification vs gsmpm_tpu: losses, the fitting
stress, the golden engine, the observed-dataset loader and apps.identify
(the fit frame itself: tests/test_torch_fit_frame.py).

Inputs are made with numpy from seeds and handed to both packages.  The
JAX side takes its TPU route where it has one: the windowed render with
``impl="pallas"`` (interpret mode) and the tiled-VJP engine with
``transfer_vjp.FORCE_PALLAS``; the port runs the kernels' plain twins.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.io import dataset as jds
from gsmpm_tpu.models.synthetic import synthetic_blob_scene
from gsmpm_tpu.ops import constitutive as jc
from gsmpm_tpu.ops import losses as jl
from gsmpm_tpu.sim.boundary import BCSet, StickyGroundBC
from gsmpm_tpu.sim.solver import run_substeps

from gsmpm_tpu_torch.apps import identify as tidentify
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.io import dataset as tds
from gsmpm_tpu_torch.io.video import encode_png
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.ops import constitutive as tc
from gsmpm_tpu_torch.ops import losses as tl
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import fitting as tf
from gsmpm_tpu_torch.sim.solver import run_substeps as t_run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y as t_mu_lam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    err = np.abs(np.asarray(got) - want).max()
    assert err / scale <= rel, (what, err, scale)


# ---------------------------------------------------------------------------
# losses and the fitting stress
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    """L1, SSIM, both photometric losses and d(loss)/d(pred) to 1e-6."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(64, 48, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    for name in ("l1_loss", "ssim", "photometric_loss",
                 "photometric_loss_as_committed"):
        want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tl, name)(_t(a), _t(b)))
        assert abs(got - want) <= 1e-6, (name, got, want)
    assert abs(float(tl.ssim(_t(a), _t(a))) - 1.0) < 1e-5
    want = jax.grad(jl.photometric_loss)(jnp.asarray(a), jnp.asarray(b))
    p = _t(a).requires_grad_(True)
    tl.photometric_loss(p, _t(b)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), atol=1e-6)


def test_green_stvk_stress_matches_jax():
    rng = np.random.default_rng(1)
    n = 500
    F = (np.eye(3)[None] + 0.2 * rng.normal(size=(n, 3, 3))).astype(
        np.float32)
    F[:5] *= 0.1  # |J| under the clamp
    mu = rng.uniform(1e2, 1e4, n).astype(np.float32)
    lam = rng.uniform(1e2, 1e4, n).astype(np.float32)
    Fp = tuple(F[:, r, c] for r in range(3) for c in range(3))
    want = jc.cauchy_stress_stvk_green_soa(
        tuple(jnp.asarray(f) for f in Fp), jnp.asarray(mu), jnp.asarray(lam))
    got = tc.cauchy_stress_stvk_green_soa(tuple(_t(f) for f in Fp), _t(mu),
                                          _t(lam))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=2e-6 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("tie", [False, True])
def test_sgd_learn_matches_jax(tie):
    """Clipped SGD, non-finite gradients dropped (inf too, not clipped)."""
    from gsmpm_tpu.sim.fitting import FitConfig, sgd_learn

    g = np.array([0.5, -3.0, 2.0, 0.0, np.inf, -np.inf, np.nan],
                 np.float32)
    z = np.zeros_like(g)
    want = sgd_learn(jnp.asarray(z), jnp.asarray(z), jnp.asarray(g),
                     jnp.asarray(-g), FitConfig(tie_params=tie))
    got = tf.sgd_learn(_t(z), _t(z), _t(g), _t(-g),
                       tf.FitConfig(tie_params=tie))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------------------
# the golden engine
# ---------------------------------------------------------------------------

KW = dict(material="jelly", E=1e4, nu=0.3, n_grid=24, grid_extent=2.0,
          gravity=[0.0, -9.81, 0.0], fitting=True)
DT = 0.03 / 30


def _sticky():
    return tb.BCSet(grid_ops=(tb.StickyGroundBC(
        torch.tensor([1.0, 0.6, 1.0]), torch.tensor([1.0, 0.1, 1.0])),))


def test_golden_fitting_substeps_and_grads_match_jax():
    """run_substeps(fitting=True): 5 golden substeps with the sticky ground
    (forward), and d(loss)/d(logE) through them with the per-substep
    checkpoint, vs gsmpm_tpu's XLA planes engine."""
    from gsmpm_tpu.sim.coupling import world2grid
    from gsmpm_tpu.sim.state import (
        GridConfig, init_model, init_state, mu_lam_from_logE_y,
    )
    from gsmpm_tpu.sim.volume import particle_volume

    n = 256
    scene = synthetic_blob_scene(n=n, seed=5, radius=0.4,
                                 center=(0.0, 0.8, 0.0))
    cfg = MPMConfig(**KW)
    g_xyz, _, sc = world2grid(scene.xyz, cfg.grid_extent, pad=0.3)
    vol = particle_volume(g_xyz, cfg.n_grid, cfg.grid_extent)
    v0 = jnp.tile(jnp.asarray([0.0, -2.0, 0.0], jnp.float32)[None], (n, 1))
    state = init_state(g_xyz, scene.get_covariance() * sc * sc, vol, cfg, v0)
    model = init_model(cfg, n)
    grid = GridConfig(cfg.n_grid, cfg.grid_extent)
    bcs = BCSet(grid_ops=(StickyGroundBC(),))

    def jloss(logE):
        mu, lam = mu_lam_from_logE_y(logE, model.y)
        m = dataclasses.replace(model, logE=logE, mu=mu, lam=lam)
        st, _ = run_substeps(state, m, bcs, jnp.float32(0.0), 5, grid, DT,
                             fitting=True)
        return jnp.sum(st.x * jnp.sin(st.x)) + jnp.sum(st.F * st.F), st

    (lj, stj), gj = jax.value_and_grad(jloss, has_aux=True)(model.logE)

    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    t_model = t_init_model(TMPMConfig(**KW), n, "cpu")
    logE = t_model.logE.clone().requires_grad_(True)
    mu, lam = t_mu_lam(logE, t_model.y)
    m = dataclasses.replace(t_model, logE=logE, mu=mu, lam=lam)
    st, t = t_run_substeps(t_state, m, _sticky(), 0.0, 5, TGridConfig(*grid),
                           DT, fitting=True)
    assert t == pytest.approx(float(jnp.float32(5 * DT)), rel=1e-6)
    for name in ("x", "v", "C", "F"):
        # index_add_ vs scatter-add order, 5 substeps
        _close(getattr(st, name).detach().numpy(), getattr(stj, name), 1e-5,
               name)
    loss = torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-6)
    loss.backward()
    _close(logE.grad.numpy(), gj, 1e-4, "d_logE")


def test_golden_simulation_substeps_match_jax():
    """run_substeps(fitting=False): the golden engine's simulation branch
    (particle impulse, jelly return map, surface collider), 5 substeps,
    tests/test_torch_tiles.py's scene, vs gsmpm_tpu's planes engine."""
    from gsmpm_tpu.sim.boundary import ImpulseBC, make_surface_collider
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu.sim.volume import particle_volume

    n = 600
    kw = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
              substep_dt=1e-4, frame_dt=1e-2, density=200.0)
    cfg = MPMConfig(**kw)
    rng = np.random.default_rng(5)
    xyz = jnp.asarray(rng.uniform(0.1, 1.9, size=(n, 3)).astype(np.float32))
    cov6 = jnp.tile(jnp.asarray([1e-4, 0, 0, 1e-4, 0, 1e-4], jnp.float32),
                    (n, 1))
    v0 = jnp.asarray(2.0 * rng.normal(size=(n, 3)).astype(np.float32))
    state = init_state(xyz, cov6, particle_volume(xyz, 16, 2.0), cfg, v0)
    grid = GridConfig(16, 2.0)
    imp = dict(center=[1.0, 1.0, 1.0], size=[0.5, 0.5, 0.5],
               force=[0.0, 0.0, 50.0])
    bcs = BCSet(particle_ops=(ImpulseBC(
        *(jnp.asarray(imp[k], jnp.float32) for k in imp),
        jnp.float32(0.0), jnp.float32(1.0)),),
        grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    stj, _ = run_substeps(state, init_model(cfg, n), bcs, jnp.float32(0.0),
                          5, grid, cfg.substep_dt, checkpoint_policy=None)

    t_bcs = tb.BCSet(particle_ops=(tb.ImpulseBC(
        *(torch.tensor(imp[k]) for k in imp), 0.0, 1.0),),
        grid_ops=(tb.make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    st, _ = t_run_substeps(
        state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                          for f in dataclasses.fields(state)}),
        t_init_model(TMPMConfig(**kw), n, "cpu"), t_bcs, 0.0, 5,
        TGridConfig(*grid), cfg.substep_dt, checkpoint_policy=None)
    for name in ("x", "v", "C", "F", "F_trial"):
        # index_add_ vs scatter-add order, 5 substeps
        _close(getattr(st, name).numpy(), getattr(stj, name), 1e-5, name)


def _write_dataset(root, n_frames=2, res=32):
    """A two-camera RGBA dataset: camera "a" written by the port's PNG
    writer (filter 0), camera "b" by imageio (filtered scanlines)."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(8)
    cams = []
    for i, name in enumerate(("a", "b")):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.3 * i, 0.5, 3.0]
        cams.append({"camera": name, "K": [[40.0, 0, 16], [0, 40.0, 16],
                                           [0, 0, 1]],
                     "c2w": c2w.tolist()})
        os.makedirs(os.path.join(root, name))
        for fid in range(n_frames):
            px = rng.integers(0, 256, size=(res, res, 4), dtype=np.uint8)
            path = os.path.join(root, name, f"{fid:03d}.png")
            if name == "a":
                with open(path, "wb") as f:
                    f.write(encode_png(px))
            else:
                imageio.imwrite(path, px)
    with open(os.path.join(root, "camera.json"), "w") as f:
        json.dump(cams, f)
    with open(os.path.join(root, "frame.json"), "w") as f:
        json.dump([{f"{i:03d}": 0.04 * i} for i in range(n_frames)], f)
    with open(os.path.join(root, "physical.json"), "w") as f:
        json.dump({"E": 3e3, "nu": 0.3}, f)


def test_load_observed_dataset_matches_jax(tmp_path):
    _write_dataset(str(tmp_path))
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    want = jds.load_observed_dataset(str(tmp_path), 32, 32, bg)
    got = tds.load_observed_dataset(str(tmp_path), 32, 32, bg)
    assert (got.n_frames, got.n_cameras) == (want.n_frames, want.n_cameras)
    assert got.frame_dts == pytest.approx(want.frame_dts)
    assert got.physics == want.physics
    for fr_t, fr_j in zip(got.images, want.images):
        for a, b in zip(fr_t, fr_j):
            np.testing.assert_array_equal(a, b)
    for ct, cj in zip(got.cameras, want.cameras):
        for f in ("view", "full_proj", "campos"):
            np.testing.assert_allclose(np.asarray(getattr(ct, f)),
                                       np.asarray(getattr(cj, f)),
                                       rtol=1e-6, atol=1e-6)


def _identify_args(tmp_path, **over):
    args = dict(scene="torus", output_path=str(tmp_path), data_path=None,
                synthetic=64, iters=1, frames=2, resolution=32, seed=0,
                no_appearance=False, tie_params=False, per_particle=False,
                E_true=3e3, nu_true=0.3, E_init=1e4, nu_init=0.4,
                device="cpu")
    args.update(over)
    return tidentify.build_parser().parse_args(
        [f"--{k}={v}" for k, v in args.items()
         if v is not None and not isinstance(v, bool)]
        + [f"--{k}" for k, v in args.items() if v is True])


def test_identify_end_to_end_cpu(tmp_path, capsys):
    """apps.identify on the CPU at a tiny size (tests/test_fitting.py's
    configuration): tied mode by default, appearance step, ground truth
    and a fit frame, metrics.csv; --per_particle keeps per-particle SGD;
    --data_path fits against a dataset on disk."""
    ident = tidentify.identify(_identify_args(tmp_path / "a"))
    out = capsys.readouterr().out
    assert ident.fit_cfg.tie_params and "tied-scalar" in out
    assert ident.sim_engine == "golden"  # the CPU default
    rows = open(tmp_path / "a" / "metrics.csv").read().splitlines()
    assert rows[0] == "iteration,frame,loss,optimized_E,optimized_nu"
    assert len(rows) == 3
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows[1:])
    assert ident.optimized_E != pytest.approx(1e4, rel=1e-9)

    ident2 = tidentify.identify(_identify_args(tmp_path / "b",
                                               per_particle=True))
    assert not ident2.fit_cfg.tie_params

    _write_dataset(str(tmp_path / "data"))
    ident3 = tidentify.identify(_identify_args(
        tmp_path / "c", data_path=str(tmp_path / "data")))
    out = capsys.readouterr().out
    assert "Loaded observations: 2 frames x 2 cameras" in out
    assert np.isfinite(ident3.optimized_E)
    # --mesh takes auto | none (the mesh itself: test_torch_parallel_fit.py)
    with pytest.raises(SystemExit):
        tidentify.main(["--mesh", "data=2"])
