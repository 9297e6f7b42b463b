"""The port's differentiable stream render (the K7 twin
``stream_blend_bwd_ref`` behind ``_StreamCore``) vs gsmpm_tpu's.

The JAX side runs its Pallas stream kernels in interpret mode
(RasterConfig(impl="pallas", stream=True, chunk=32)), as
tests/test_stream_raster.py does; the port runs the plain twins.  Scenes
are made with numpy from seeds and handed to both packages: the blend's
reverse walk on the same sorted planes and cotangent, the gradients of an
image loss, directional finite differences, and one stream-rendered fit
frame with the tier-budget resize.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.models.synthetic import synthetic_blob_scene
from gsmpm_tpu.render.camera import make_camera
from gsmpm_tpu.render.renderer import (
    RasterConfig,
    _raw_planes_nosentinel,
    preprocess,
    render_with_aux,
)
from gsmpm_tpu.render.stream_raster import (
    _build_tables,
    _stream_core,
    stream_emission,
)
from gsmpm_tpu.sim.fitting import FitConfig, SystemIdentifier

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import SCENE_FIELDS, scene_from_numpy
from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.render import stream_raster as ts
from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera
from gsmpm_tpu_torch.sim import fitting as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n, seed, big_frac=0.0, giant_frac=0.0, w=128, h=128):
    """tests/test_stream_raster.py's scene: (means, cov6, opacity, colors,
    (w, h)) as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.5
    r = rng.random(n)
    scale = np.where(
        r < 1.0 - big_frac - giant_frac, 0.05,
        np.where(r < 1.0 - giant_frac, 0.6, 6.0),
    ).astype(np.float32)
    A = scale[:, None, None] * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = np.ascontiguousarray(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    opacity = rng.uniform(0.15, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return means, cov6, opacity, colors, (w, h)


def _jax_cfg(B, **kw):
    return RasterConfig(block=B, chunk=32, impl="pallas", stream=True, **kw)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def test_reverse_walk_matches_jax_vjp():
    """The VJP of the port's blend (stream_blend_ref forward, the K7 twin
    stream_blend_bwd_ref backward) against the VJP of gsmpm_tpu's
    _stream_core (K3 / K7 with their step tables) on the same sorted stream
    and seeded cotangent: 1e-4 of each row's largest entry.  Each backward
    takes its own forward's state: T is recovered by division from the
    final transmittance, which the two forwards round differently."""
    means, cov6, opacity, colors, (w, h) = _scene(300, 5, big_frac=0.1,
                                                  giant_frac=0.02, w=192)
    B, C, U = 64, 32, 2
    cfg = _jax_cfg(B, stream_unroll=U)
    cam = make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    pre = preprocess(jnp.asarray(means), jnp.asarray(cov6),
                     jnp.asarray(opacity), None, cam, 0, cfg,
                     colors_precomp=jnp.asarray(colors))
    keys, emis, _, lv = stream_emission(pre, cam, cfg,
                                        _raw_planes_nosentinel(pre)[:9])
    srt = jax.lax.sort((keys,) + tuple(emis[i] for i in range(9)), num_keys=1)
    splanes = jnp.stack(srt[1:])
    bounds = jnp.searchsorted(
        srt[0], jnp.arange(lv.nf + 1, dtype=jnp.int32) * lv.M
    ).astype(jnp.int32)
    L = splanes.shape[1]
    L_pad = -(-L // (U * C)) * (U * C)
    sp_pad = jnp.pad(splanes, ((0, 0), (0, L_pad - L)))
    nstep = L_pad // (U * C) + lv.nf
    tables = _build_tables(bounds, L_pad, U * C, lv.nf, nstep)
    meta = (C, U, B, B * B, float(cfg.t_min), float(cfg.alpha_min), nstep,
            lv.nbx, lv.nf)
    out, vjp = jax.vjp(lambda s: _stream_core(tables, s, meta), sp_pad)
    rng = np.random.default_rng(7)
    g = np.zeros(out.shape, np.float32)
    g[:, 0:4] = rng.normal(size=(lv.nf, 4, B * B))
    (d_j,) = vjp(jnp.asarray(g))

    sp_t = torch.from_numpy(np.array(splanes))
    b_t = torch.from_numpy(np.array(bounds))
    out_t = ts.stream_blend_ref(sp_t, b_t, lv.nbx, B, cfg.t_min, cfg.alpha_min)
    np.testing.assert_array_equal(out_t[:, 5].numpy(), np.asarray(out)[:, 5])
    d_t = ts.stream_blend_bwd_ref(sp_t, b_t, out_t, torch.from_numpy(g),
                                  lv.nbx, B, cfg.alpha_min)
    d_j = np.asarray(d_j)[:, :L]
    assert np.abs(d_j).max() > 0
    for r in range(9):
        assert _rel_err(d_t[r].numpy(), d_j[r]) <= 1e-4, r


def _port_loss_grads(means, cov6, opacity, colors, cam, bg, tgt, cfg):
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (means, cov6, opacity, colors)]
    img, nd = tr.render_with_aux(args[0], args[1], args[2], None, cam,
                                 torch.from_numpy(bg), cfg=cfg,
                                 colors_precomp=args[3])
    loss = torch.mean((img - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    return float(loss.detach()), int(nd), [a.grad.numpy() for a in args]


def test_stream_grads_match_jax():
    """d(MSE)/d(means, cov6, opacity, colors) through the port's stream
    render (emission, stable sort, K3 / K7 twins) against jax.grad of
    gsmpm_tpu's (tests/test_stream_raster.py::test_stream_grads_match_xla's
    scene at block 32, where its big splats span tier 2): 1e-4 of each
    gradient's largest entry."""
    means, cov6, opacity, colors, (w, h) = _scene(200, 3, big_frac=0.1)
    bg = np.zeros(3, np.float32)
    tgt = np.random.default_rng(11).random((h, w, 3)).astype(np.float32)
    jcam = make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    jcfg = _jax_cfg(32, stream_unroll=2)

    def loss(m, c6, op, col):
        img, _ = render_with_aux(m, c6, op, None, jcam, jnp.asarray(bg),
                                 cfg=jcfg, colors_precomp=col)
        return jnp.mean((img - jnp.asarray(tgt)) ** 2)

    g_j = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (means, cov6, opacity, colors)))
    tcam = t_make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    caps = ts.required_stream_caps(*(torch.from_numpy(a) for a in
                                     (means, cov6, opacity)), tcam,
                                   tr.RasterConfig(block=32, stream=True))
    assert caps["stream_g2"] > 0, caps  # tier-2 splats really exercised
    _, nd, g_t = _port_loss_grads(means, cov6, opacity, colors, tcam, bg,
                                  tgt, tr.RasterConfig(block=32, stream=True))
    assert nd == 0
    for name, a, b in zip(("means", "cov6", "opacity", "colors"), g_t, g_j):
        assert _rel_err(a, b) <= 1e-4, name


def test_stream_grads_finite_difference():
    """Directional central differences of the port's stream render along
    random unit vectors in opacity pin the backward against the forward
    (tests/test_stream_raster.py::test_stream_grads_finite_difference)."""
    means, cov6, opacity, colors, (w, h) = _scene(60, 21, big_frac=0.15,
                                                  w=64, h=64)
    bg = np.asarray([0.2, 0.2, 0.2], np.float32)
    cfg = tr.RasterConfig(block=32, stream=True)
    cam = t_make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    rng = np.random.default_rng(4)
    tgt = rng.random((h, w, 3)).astype(np.float32)
    _, _, grads = _port_loss_grads(means, cov6, opacity, colors, cam, bg, tgt,
                                   cfg)
    g = grads[2]

    def loss_np(op):
        with torch.no_grad():
            img, _ = tr.render_with_aux(
                torch.from_numpy(means), torch.from_numpy(cov6),
                torch.from_numpy(op.astype(np.float32)), None, cam,
                torch.from_numpy(bg), cfg=cfg,
                colors_precomp=torch.from_numpy(colors))
            return float(torch.mean((img - torch.from_numpy(tgt)) ** 2))

    # an f32 forward quantizes the loss at ~1e-8: directional derivatives
    # aggregate the whole gradient into one cleaner signal
    eps = 2e-3
    for k in range(3):
        d = rng.normal(size=opacity.shape).astype(np.float32)
        d /= np.linalg.norm(d)
        fd = (loss_np(opacity + eps * d) - loss_np(opacity - eps * d)) / (
            2 * eps)
        an = float(np.dot(g, d))
        assert abs(fd - an) < 3e-2 * max(abs(fd), abs(an)) + 3e-6, (k, fd, an)


def test_stream_fit_frame_matches_jax(capsys):
    """One fit frame with a stream render whose tier budgets are 1
    (tests/test_fitting.py::test_fitting_stream_budget_resize_converges_to_
    drop_free): the port resizes the budgets from the measured populations
    and re-runs the frame drop-free; gsmpm_tpu's resize policy gives the
    same budgets on the same geometry, and its fit frame at those budgets
    the same loss, image and d(loss)/d(logE, y) (its CPU engine against the
    port's golden engine)."""
    from gsmpm_tpu.render.renderer import bump_caps_for_dropfree

    scene = synthetic_blob_scene(n=96, seed=7, radius=0.4,
                                 center=(0.0, 0.8, 0.0))
    # a third of the splats inflated so their rects span > 2x2 fine tiles
    scal = np.array(scene.scaling)
    scal[::3] = np.log(0.25)
    scene = dataclasses.replace(scene, scaling=jnp.asarray(scal))
    kw = dict(material="jelly", E=3e4, nu=0.4, n_grid=32, grid_extent=2.0,
              gravity=[0.0, -9.81, 0.0], fitting=True)
    tiny = dict(block=32, stream=True, stream_g2=1, stream_g3=1,
                stream_g4=1)
    args = (128, 128, 0.7, 0.7, np.eye(3), np.array([0.0, 0.8, -3.0]))
    gt = np.zeros((128, 128, 3), np.float32)

    tid = tf.SystemIdentifier(
        scene_from_numpy({**{k: np.asarray(getattr(scene, k))
                             for k in SCENE_FIELDS},
                          "sh_degree": scene.sh_degree}),
        TMPMConfig(**kw), fit_cfg=tf.FitConfig(substeps_per_frame=2),
        raster_cfg=tr.RasterConfig(**tiny))
    capsys.readouterr()
    loss_t, state_t, _, img_t = tid.fit_frame(tid.reset_state(), 0.0,
                                              t_make_camera(*args),
                                              torch.from_numpy(gt))
    assert "resizing rasterizer tier budgets" in capsys.readouterr().out
    assert tid.sim_engine == "golden"
    assert tid.n_dropped_last == 0 and tid._k_bumps == 0
    assert not tid._drop_warned
    budgets = {k: getattr(tid.raster_cfg, k)
               for k in ("stream_g2", "stream_g3", "stream_g4")}
    assert min(budgets.values()) > 1

    # gsmpm_tpu's resize on the dropped frame's end-of-frame geometry (the
    # re-run simulates the same substeps, so it is the returned state's)
    jcfg = RasterConfig(chunk=32, impl="pallas", stream_unroll=1, **tiny)
    xyz_w, cov_w = (jnp.asarray(a.numpy())
                    for a in tid._world_geometry(state_t))
    bumped = bump_caps_for_dropfree(jcfg, xyz_w, cov_w,
                                    scene.get_opacity().reshape(-1),
                                    make_camera(*args))
    assert {k: getattr(bumped, k) for k in budgets} == budgets

    jid = SystemIdentifier(scene, MPMConfig(**kw),
                           fit_cfg=FitConfig(substeps_per_frame=2),
                           raster_cfg=bumped)
    state = jid.reset_state()
    logE0, y0 = jid.model.logE, jid.model.y
    loss_j, _, _, img_j = jid.fit_frame(state, jnp.float32(0.0),
                                        make_camera(*args), jnp.asarray(gt))
    assert jid.n_dropped_last == 0
    # the gradient fit_frame applied: its frame function at the pre-step
    # parameters
    _, (gE, gy) = jid._frame_fn(
        logE0, y0, state, jnp.float32(0.0), make_camera(*args),
        jnp.asarray(gt), jid.scaling, jid.pos_center,
        jid.scene.get_opacity().reshape(-1), jid.scene.get_features())
    # tolerances of tests/test_torch_fit_frame.py
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=2e-3)
    for name, g, want in (("g_logE", tid.last_grads[0], gE),
                          ("g_y", tid.last_grads[1], gy)):
        assert _rel_err(g.numpy(), want) <= 1e-3, name
