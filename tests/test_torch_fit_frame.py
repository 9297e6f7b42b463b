"""The port's fit frame vs gsmpm_tpu's: ground truth, the drop-free cap
resize, one fit frame on each sim engine, the tiled engine's overflow
fallback and the frame-0 appearance step.

Inputs are made with numpy from seeds and handed to both packages.  The
JAX side takes its TPU route: the windowed render with
``impl="pallas"`` (interpret mode) and, for the tiled engine, the
Pallas transfer VJPs (``transfer_vjp.FORCE_PALLAS``); the port runs the
kernels' plain twins.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmpm_tpu.sim.transfer_vjp as jtv
from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.models.synthetic import synthetic_blob_scene
from gsmpm_tpu.render.camera import make_camera
from gsmpm_tpu.render.renderer import RasterConfig
from gsmpm_tpu.sim.fitting import FitConfig, SystemIdentifier

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.synthetic import (
    synthetic_blob_scene as t_blob_scene,
)
from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera
from gsmpm_tpu_torch.render.renderer import RasterConfig as TRasterConfig
from gsmpm_tpu_torch.sim import fitting as tf
from gsmpm_tpu_torch.sim import tiles as tt


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


N_FIT, RES = 192, 64


@contextlib.contextmanager
def _pallas_adjoint(on: bool):
    jtv.FORCE_PALLAS = on
    try:
        yield
    finally:
        jtv.FORCE_PALLAS = False


def _identifiers(k_tile=512):
    """The same falling blob, camera and caps on both packages."""
    kw = dict(material="jelly", E=1e4, nu=0.4, n_grid=24, grid_extent=2.0,
              gravity=[0.0, -9.81, 0.0], fitting=True)
    rkw = dict(block=32, chunk=32, k_tile=k_tile)
    args = (RES, RES, 0.7, 0.7, np.eye(3), np.array([0.0, 0.8, -3.0]))
    jid = SystemIdentifier(
        synthetic_blob_scene(n=N_FIT, seed=3, radius=0.4,
                             center=(0.0, 0.8, 0.0)),
        MPMConfig(**kw),
        init_velocity=jnp.tile(jnp.asarray([[0.0, -2.0, 0.0]]), (N_FIT, 1)),
        fit_cfg=FitConfig(substeps_per_frame=3),
        raster_cfg=RasterConfig(impl="pallas", **rkw), bg=jnp.ones(3))
    tid = tf.SystemIdentifier(
        t_blob_scene(n=N_FIT, seed=3, radius=0.4, center=(0.0, 0.8, 0.0)),
        TMPMConfig(**kw),
        init_velocity=torch.tensor([[0.0, -2.0, 0.0]]).repeat(N_FIT, 1),
        fit_cfg=tf.FitConfig(substeps_per_frame=3),
        raster_cfg=TRasterConfig(impl="pallas", **rkw), bg=torch.ones(3))
    return (jid, make_camera(*args)), (tid, t_make_camera(*args))


@pytest.mark.parametrize("engine,resize", [("golden", False),
                                           ("tiled_vjp", True)])
def test_fit_frame_matches_jax(engine, resize, capsys):
    """Ground truth, then one fit frame: loss, image, d(loss)/d(logE, y)
    and the SGD step vs gsmpm_tpu's fit_frame on the matching engine
    ("xla" is its golden planes engine).  With ``resize`` both start from a
    tier-1 cap that drops, so the drop-free cap resize and the re-run
    happen on both sides, in the ground truth and in the fit frame."""
    (jid, jcam), (tid, tcam) = _identifiers(k_tile=8 if resize else 512)
    gt_j = jid.generate_ground_truth(3e3, 0.3, [jcam], 2)
    gt_t = tid.generate_ground_truth(3e3, 0.3, [tcam], 2)
    assert tid.raster_cfg._asdict() == {
        k: v for k, v in jid.raster_cfg._asdict().items()
        if k in TRasterConfig._fields}
    for a, b in zip(gt_t, gt_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3)
    # both fit against the same observation
    gt = np.asarray(gt_j[1])
    # restart both at tier 1 only (with resize, the fit frame resizes again)
    small = dict(k_dense=0, n_dense=16)
    jid.raster_cfg = jid.raster_cfg._replace(**small)
    tid.raster_cfg = tid.raster_cfg._replace(**small)

    jid._sim_engine = "xla" if engine == "golden" else "tiled_vjp"
    tid._sim_engine = engine
    with _pallas_adjoint(engine == "tiled_vjp"):
        state = jid.reset_state()
        logE0, y0 = jid.model.logE, jid.model.y
        jid._frame_fn = None
        loss_j, _, _, img_j = jid.fit_frame(state, jnp.float32(0.0), jcam,
                                            jnp.asarray(gt))
        # the gradient fit_frame applied: its frame function (at the
        # resized caps) at the pre-step parameters
        _, (gE, gy) = jid._frame_fn(
            logE0, y0, state, jnp.float32(0.0), jcam, jnp.asarray(gt),
            jid.scaling, jid.pos_center, jid.scene.get_opacity().reshape(-1),
            jid.scene.get_features())
    capsys.readouterr()
    loss_t, _, _, img_t = tid.fit_frame(tid.reset_state(), 0.0, tcam, _t(gt))
    out = capsys.readouterr().out
    assert ("resizing rasterizer caps" in out) == resize
    assert tid.sim_engine == engine
    assert tid.n_dropped_last == 0 and jid.n_dropped_last == 0
    assert tid.raster_cfg.k_dense == jid.raster_cfg.k_dense
    assert (tid.raster_cfg.k_dense > 0) == resize
    # the loss is a small image difference: bound it by the image tolerance
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=2e-3)
    for name, g, w in (("g_logE", tid.last_grads[0], gE),
                       ("g_y", tid.last_grads[1], gy)):
        # per-particle gradients through 3 substeps and the reverse walk
        # (transmittance by division); the JAX kernels round their
        # products in 3 bf16 passes
        _close(g.numpy(), w, 1e-3, name)
    np.testing.assert_allclose(tid.model.logE.numpy(),
                               np.asarray(jid.model.logE), atol=2e-6)
    np.testing.assert_allclose(tid.model.y.numpy(), np.asarray(jid.model.y),
                               atol=2e-6)


def test_fit_frame_falls_back_to_golden_on_tile_overflow(monkeypatch,
                                                        capsys):
    """An occupied-tile cap overflow (ok=False) moves the run to the golden
    engine and re-runs the frame, gsmpm_tpu's semantics."""
    _, (tid, tcam) = _identifiers()
    gt = tid.generate_ground_truth(3e3, 0.3, [tcam], 2)[1]
    real = tt.default_tile_config
    monkeypatch.setattr(tt, "default_tile_config",
                        lambda g, n: real(g, n)._replace(n_occ_cap=1))
    tid._sim_engine = "tiled_vjp"
    loss, _, _, img = tid.fit_frame(tid.reset_state(), 0.0, tcam, gt)
    assert "falling back to the golden planes engine" in capsys.readouterr().out
    assert tid.sim_engine == "golden"
    assert np.isfinite(float(loss)) and bool(torch.isfinite(img).all())


def test_appearance_step_matches_jax():
    """One frame-0 Adam step (per-group learning rates, eps 1e-15) through
    the windowed render: loss and every updated parameter."""
    import optax  # noqa: F401  (the JAX step's optimizer)

    (jid, jcam), (tid, tcam) = _identifiers()
    rng = np.random.default_rng(6)
    gt = rng.uniform(size=(RES, RES, 3)).astype(np.float32)
    tx, params, opt_state = jid.make_appearance_optimizer()
    loss_j, params, _ = jid.appearance_step(tx, params, opt_state, jcam,
                                            jnp.asarray(gt))
    opt, tparams = tid.make_appearance_optimizer()
    loss_t = tid.appearance_step(opt, tparams, camera=tcam, gt_image=_t(gt))
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-6)
    for k in ("xyz", "features_dc", "features_rest", "opacity", "scaling"):
        # Adam's first step moves each entry by ~lr sign(g); a gradient
        # that is ~0 on one side may flip its sign on the other
        want = np.asarray(params[k])
        got = getattr(tid.scene, k).numpy()
        lr = {"xyz": 1.6e-6, "features_dc": 2.5e-3,
              "features_rest": 1.25e-4, "opacity": 5e-2,
              "scaling": 5e-3}[k]
        assert np.mean(np.abs(got - want) > 1e-3 * lr) < 0.02, k
        np.testing.assert_allclose(got, want, atol=2.0 * lr, err_msg=k)


