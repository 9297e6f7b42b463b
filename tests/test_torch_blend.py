"""The port's windowed renderer (dup-sort selection, two-tier windows and
the K4 / K5 tile blend) vs gsmpm_tpu on its TPU route.

Both packages get the same numpy-seeded scenes.  The JAX side runs
``RasterConfig(impl="pallas")`` (interpret mode on the CPU, as
tests/test_pallas_render.py does); the port runs the kernels' plain twins
(render/cuda_blend.py), which tests/test_torch_cuda.py and chip_smoke.py
hold against the CUDA kernels on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.render import pallas_blend
from gsmpm_tpu.render import renderer as jr
from gsmpm_tpu.render.camera import make_camera as j_make_camera

from gsmpm_tpu_torch.render import cuda_blend as cb
from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES = 64


def _scene(n=300, seed=0, spread=1.0):
    """tests/test_pallas_render.py's scene on a 64^2 camera."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    A = 0.05 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return means, np.ascontiguousarray(cov6), opacity, colors


def _cams():
    args = (RES, RES, 0.9, 0.9, np.eye(3), np.zeros(3))
    return j_make_camera(*args), t_make_camera(*args)


CAPS = dict(block=32, chunk=32)


def _cfgs(**kw):
    c = dict(CAPS, **kw)
    return (jr.RasterConfig(impl="pallas", **c),
            tr.RasterConfig(impl="pallas", **c))


def _t(a):
    return torch.from_numpy(np.array(a))


def _pre_both(scene, jcfg):
    """JAX preprocess, and the same planes as the port's Preprocessed."""
    means, cov6, opacity, colors = scene
    jcam, _ = _cams()
    pre = jr.preprocess(jnp.asarray(means), jnp.asarray(cov6),
                        jnp.asarray(opacity), None, jcam, 0, jcfg,
                        colors_precomp=jnp.asarray(colors))
    return pre, tr.Preprocessed(**{k: _t(v) for k, v in pre._asdict().items()})


@pytest.mark.parametrize("caps", [dict(), dict(k_tile=16, k_coarse=8,
                                               k_global=4)])
def test_dupsort_selection_identical(caps):
    """Integer work on the same planes: gidx, counts, origins, n_dropped
    and the segment table equal gsmpm_tpu's (the second case drops)."""
    jcfg, tcfg = _cfgs(**caps)
    jpre, tpre = _pre_both(_scene(), jcfg)
    jcam, tcam = _cams()
    want = jr._select_candidates_dupsort_v2(jpre, jcam, jcfg,
                                            return_internals=True)
    got = tr._select_candidates_dupsort_v2(tpre, tcam, tcfg,
                                           return_internals=True)
    for name, a, b in zip(("gidx", "counts", "origins", "n_dropped"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for k in ("bounds", "seg", "st"):
        np.testing.assert_array_equal(got[4][k].numpy(),
                                      np.asarray(want[4][k]), err_msg=k)
    assert (int(got[3]) > 0) == bool(caps)


def test_dense_tiles_break_ties_like_top_k():
    seg = np.array([5, 9, 9, 2, 9, 5, 0, 9, 5], np.int32)
    want_c, want_i = jax.lax.top_k(jnp.asarray(seg), 6)
    got_c, got_i = tr._dense_tiles(_t(seg), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_two_tier_selection_identical():
    """Dense tile ids, the tier-2 windows and the two-tier drop count equal
    gsmpm_tpu's _render_pallas_two_tier (its lines, replayed on its own
    internals)."""
    jcfg, tcfg = _cfgs(k_tile=32, k_dense=256, n_dense=3)
    jpre, tpre = _pre_both(_scene(n=400, spread=0.5), jcfg)
    jcam, tcam = _cams()
    _, _, _, _, itl = jr._select_candidates_dupsort_v2(
        jpre, jcam, jcfg, return_internals=True)
    nf, nd = itl["nf"], min(jcfg.n_dense, itl["nf"])
    kd = min(jcfg.k_dense, 400)
    dcnt, dtiles = jax.lax.top_k(itl["seg"][:nf], nd)
    dq_d, g_d = jr._stream_windows(itl, dtiles, kd)
    par = itl["parent"][dtiles]
    dq_all = jnp.concatenate([dq_d, itl["dq_c_all"][par], jnp.broadcast_to(
        itl["dq_g1"], (nd, itl["k2"]))], axis=1)
    g_all = jnp.concatenate([g_d, itl["g_c_all"][par], jnp.broadcast_to(
        itl["g_g1"], (nd, itl["k2"]))], axis=1)
    mdq, gidx_d = jax.lax.sort((dq_all, g_all), num_keys=1, dimension=1)
    counts_d = jnp.sum(mdq < itl["sent"], axis=1)
    dropped = (jnp.sum(jnp.maximum(itl["seg"][:nf] - itl["k0"], 0))
               - jnp.sum(jnp.maximum(dcnt - itl["k0"], 0))
               + jnp.sum(jnp.maximum(dcnt - kd, 0))
               + jnp.sum(jnp.maximum(itl["seg"][nf:nf + itl["nc"]]
                                     - itl["k1"], 0))
               + jnp.maximum(itl["seg"][-1] - itl["k2"], 0))

    _, _, _, _, titl = tr._select_candidates_dupsort_v2(
        tpre, tcam, tcfg, return_internals=True)
    got = tr._dense_selection(titl, 400, tcfg)
    for name, a, b in zip(("dtiles", "gidx", "counts", "dropped"), got,
                          (dtiles, gidx_d, counts_d, dropped)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(dcnt[0]) > jcfg.k_tile  # tier 2 is needed here


def _render_both(scene, jcfg, tcfg, bg=(0.1, 0.2, 0.3)):
    means, cov6, opacity, colors = scene
    jcam, tcam = _cams()
    img_j, nd_j = jr.render_with_aux(
        jnp.asarray(means), jnp.asarray(cov6), jnp.asarray(opacity), None,
        jcam, jnp.asarray(bg, jnp.float32), 0, jcfg,
        colors_precomp=jnp.asarray(colors))
    img_t, nd_t = tr.render_with_aux(
        _t(means), _t(cov6), _t(opacity), None, tcam,
        torch.tensor(bg, dtype=torch.float32), 0, tcfg,
        colors_precomp=_t(colors))
    assert int(nd_t) == int(nd_j)
    return img_t.numpy(), np.asarray(img_j)


@pytest.mark.parametrize("split", ["resident", "streamed"])
def test_blend_forward_matches_jax(split, monkeypatch):
    """The K4 twin vs the Pallas kernel (_blend_kernel, or
    _blend_kernel_streamed with _STREAM_K patched down); tolerances of
    tests/test_pallas_render.py: the twin sums the power term by term where
    the kernel contracts F.H, which can flip a threshold on a pixel."""
    if split == "streamed":
        monkeypatch.setattr(pallas_blend, "_STREAM_K", 64)
    jcfg, tcfg = _cfgs()
    a, b = _render_both(_scene(), jcfg, tcfg)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-3)
    assert np.mean(np.abs(a - b)) < 5e-6


def _grads_both(scene, jcfg, tcfg, seed=13):
    """d(sum(img * ct)) / d(cov6, opacity) on both packages."""
    means, cov6, opacity, colors = scene
    jcam, tcam = _cams()
    bg = np.zeros(3, np.float32)
    ct = np.random.default_rng(seed).normal(size=(RES, RES, 3)).astype(
        np.float32)

    def jloss(c6, op):
        img = jr.render(jnp.asarray(means), c6, op, None, jcam,
                        jnp.asarray(bg), 0, jcfg,
                        colors_precomp=jnp.asarray(colors))
        return jnp.sum(img * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cov6),
                                          jnp.asarray(opacity))
    c6 = _t(cov6).requires_grad_(True)
    op = _t(opacity).requires_grad_(True)
    img = tr.render(_t(means), c6, op, None, tcam, _t(bg), 0, tcfg,
                    colors_precomp=_t(colors))
    torch.sum(img * _t(ct)).backward()
    return (c6.grad.numpy(), op.grad.numpy()), [np.asarray(w) for w in want]


def _assert_grads_close(got, want, rel=5e-3):
    for a, b in zip(got, want):
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() / scale < rel, (np.abs(a - b).max(),
                                                   scale)


@pytest.mark.parametrize("split", ["resident", "streamed"])
def test_blend_grads_match_jax(split, monkeypatch):
    """The K5 twin vs the Pallas reverse walk (_blend_bwd_kernel, or the
    streamed variant): gradients w.r.t. cov and opacity to 5e-3 of their
    scale, tests/test_pallas_render.py's tolerance."""
    if split == "streamed":
        monkeypatch.setattr(pallas_blend, "_STREAM_K", 64)
    jcfg, tcfg = _cfgs()
    got, want = _grads_both(_scene(n=200, seed=3), jcfg, tcfg)
    _assert_grads_close(got, want)


def test_two_tier_render_and_grads_match_jax():
    """The two-tier path (tier 1 at k_tile, the densest tiles re-blended at
    k_dense): drop-free, and image and gradients as gsmpm_tpu's."""
    jcfg, tcfg = _cfgs(k_tile=32, k_dense=384, n_dense=3)
    scene = _scene(n=400, spread=0.5)
    a, b = _render_both(scene, jcfg, tcfg)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-3)
    assert np.mean(np.abs(a - b)) < 5e-6
    got, want = _grads_both(scene, jcfg, tcfg)
    _assert_grads_close(got, want)


def test_blend_pad_columns_contribute_zero():
    """K % C != 0: the chunk walk straddles K and the pad columns must
    carry log opacity -1e30 (tests/test_pallas_render.py's case)."""
    rng = np.random.default_rng(0)
    B, K = 32, 64
    cand = np.zeros((10, 1, K), np.float32)
    cand[0:2] = rng.uniform(4.0, B - 4.0, (2, 1, K))
    cand[2] = 0.5
    cand[4] = 0.5
    cand[5] = np.log(0.6)
    cand[6:9] = rng.uniform(0.2, 1.0, (3, 1, K))
    cand[9] = 6.0
    counts = torch.tensor([60], dtype=torch.int32)
    origins = torch.zeros((1, 2), dtype=torch.int32)
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = {C: cb.blend_blocks(_t(cand), counts, origins, bg,
                              tr.RasterConfig(block=B, chunk=C)).numpy()
           for C in (48, 32)}
    want = pallas_blend.blend_blocks_pallas(
        jnp.asarray(cand), jnp.asarray([60], jnp.int32),
        jnp.zeros((1, 2), jnp.int32), jnp.asarray([0.1, 0.2, 0.3]),
        jr.RasterConfig(block=B, chunk=48))
    assert np.isfinite(out[48]).all()
    np.testing.assert_allclose(out[48], out[32], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[48], np.asarray(want), rtol=1e-3,
                               atol=2e-3)


def test_required_caps_and_bump_identical():
    """Cap sizing is counting on the same geometry: required_raster_caps
    and the windowed bump_caps_for_dropfree give gsmpm_tpu's numbers."""
    means, cov6, opacity, _ = _scene(n=400, spread=0.5)
    jcam, tcam = _cams()
    jcfg, tcfg = _cfgs()
    want = jr.required_raster_caps(jnp.asarray(means), jnp.asarray(cov6),
                                   jnp.asarray(opacity), jcam, jcfg)
    got = tr.required_raster_caps(_t(means), _t(cov6), _t(opacity), tcam,
                                  tcfg)
    assert got == want
    for cfg_kw in (dict(), dict(k_dense=10 ** 4, n_dense=4, k_row=10 ** 4,
                                k_block=10 ** 4, k_coarse=10 ** 4,
                                k_global=10 ** 4)):
        jc, tc = _cfgs(**cfg_kw)
        jn = jr.bump_caps_for_dropfree(jc, jnp.asarray(means),
                                       jnp.asarray(cov6),
                                       jnp.asarray(opacity), jcam)
        tn = tr.bump_caps_for_dropfree(tc, _t(means), _t(cov6), _t(opacity),
                                       tcam)
        for f in tr.RasterConfig._fields:
            assert getattr(tn, f) == getattr(jn, f), f


def test_cpu_blend_wrappers_take_twins_and_count_nothing():
    rng = np.random.default_rng(4)
    F = torch.from_numpy(rng.normal(size=(2, 16, 64)).astype(np.float32))
    F[:, 6] = -1.0
    counts = torch.tensor([64, 30], dtype=torch.int32)
    meta = cb.BlendMeta(32, 32, 1e-4, 1.0 / 255.0, 2)
    before = (cb.blend_fwd.launches, cb.blend_bwd.launches)
    out = cb.blend_fwd(counts, F, meta)
    assert torch.equal(out, cb.blend_core_ref(counts, F, meta))
    g = torch.ones_like(out)
    assert torch.equal(cb.blend_bwd(F, out, g, meta),
                       cb.blend_core_bwd_ref(F, out, g, meta))
    assert (cb.blend_fwd.launches, cb.blend_bwd.launches) == before
