"""The port's stream renderer (gsmpm_tpu_torch/render/stream_raster.py) vs
gsmpm_tpu's, at the production block size of 64 (other block sizes change
the depth-key width and so the order of ties).

gsmpm_tpu renders with its Pallas stream kernel in interpret mode
(RasterConfig(block=64, chunk=32, impl="pallas", stream=True,
stream_unroll=2)); the port on the CPU runs the blend twin.  Scenes follow
tests/test_stream_raster.py: mixed sizes, a dense cluster, whole-screen
splats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.render.camera import make_camera
from gsmpm_tpu.render.renderer import (
    RasterConfig,
    _raw_planes_nosentinel,
    preprocess,
    render_with_aux,
)
from gsmpm_tpu.render.stream_raster import required_stream_caps, stream_emission

from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.render import stream_raster as ts
from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n=400, seed=0, big_frac=0.0, giant_frac=0.0, cluster=False,
           w=192, h=128):
    rng = np.random.default_rng(seed)
    if cluster:
        means = (0.08 * rng.normal(size=(n, 3))).astype(np.float32)
    else:
        means = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.5
    r = rng.random(n)
    scale = np.where(
        r < 1.0 - big_frac - giant_frac, 0.05,
        np.where(r < 1.0 - giant_frac, 0.6, 6.0),
    ).astype(np.float32)
    A = scale[:, None, None] * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = np.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
         cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], axis=-1,
    )
    opacity = rng.uniform(0.15, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return means, cov6, opacity, colors, (w, h)


def _jax_cfg(**kw):
    return RasterConfig(block=64, chunk=32, impl="pallas", stream=True,
                        stream_unroll=2, **kw)


def _port_cfg(**kw):
    return tr.RasterConfig(block=64, stream=True, **kw)


def _render_both(scene, bg, jcfg, tcfg):
    means, cov6, opacity, colors, (w, h) = scene
    jcam = make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    tcam = t_make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    J = jnp.asarray
    img_j, nd_j = render_with_aux(J(means), J(cov6), J(opacity), None, jcam,
                                  J(bg), cfg=jcfg, colors_precomp=J(colors))
    T = torch.from_numpy
    img_t, nd_t = tr.render_with_aux(T(means), T(cov6), T(opacity), None,
                                     tcam, T(bg), cfg=tcfg,
                                     colors_precomp=T(colors))
    caps_j = required_stream_caps(J(means), J(cov6), J(opacity), jcam, jcfg)
    caps_t = ts.required_stream_caps(T(means), T(cov6), T(opacity), tcam,
                                     tcfg)
    return (np.asarray(img_j), int(nd_j), caps_j), \
        (img_t.numpy(), int(nd_t), caps_t)


CASES = {
    "mixed_sizes": dict(n=300, seed=5, big_frac=0.1, giant_frac=0.02),
    "dense_cluster": dict(n=800, seed=9, cluster=True, w=128, h=128),
    # 640^2 at B=64 is 10x10 fine tiles, so rects over 64 tiles exist
    "tier4_whole_screen": dict(n=120, seed=11, giant_frac=0.15, w=640,
                               h=640),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_stream_matches_jax(case):
    scene = _scene(**CASES[case])
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    (img_j, nd_j, caps_j), (img_t, nd_t, caps_t) = _render_both(
        scene, bg, _jax_cfg(), _port_cfg())
    assert nd_j == nd_t == 0
    assert caps_t == caps_j
    if case == "tier4_whole_screen":
        assert caps_t["stream_g4"] > 0, caps_t  # tier 4 really exercised
    # same emission and stable sort; the blend sums its f32 terms in another
    # order (cumprod / elementwise power vs MXU-shaped dots): the JAX
    # package's own stream-vs-XLA tolerance
    np.testing.assert_allclose(img_t, img_j, rtol=1e-3, atol=2e-3)
    assert np.mean(np.abs(img_t - img_j)) < 5e-6


def test_budget_overflow_counted_like_jax_and_resized():
    scene = _scene(n=300, seed=5, big_frac=0.2)
    bg = np.zeros(3, np.float32)
    tiny = dict(stream_g2=1, stream_g3=1, stream_g4=1)
    (_, nd_j, _), (_, nd_t, _) = _render_both(
        scene, bg, _jax_cfg(**tiny), _port_cfg(**tiny))
    assert nd_t == nd_j > 0
    means, cov6, opacity, colors, (w, h) = scene
    T = torch.from_numpy
    tcam = t_make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    bumped = tr.bump_caps_for_dropfree(_port_cfg(**tiny), T(means), T(cov6),
                                       T(opacity), tcam)
    _, nd = tr.render_with_aux(T(means), T(cov6), T(opacity), None, tcam,
                               T(bg), cfg=bumped, colors_precomp=T(colors))
    assert int(nd) == 0


def test_emission_sort_and_bounds_equal_jax():
    """Given gsmpm_tpu's preprocessed planes, the port's emission keys
    (depth bit-cast + logical shift, int32), its stable sort and its segment
    bounds are identical to lax.sort's."""
    means, cov6, opacity, colors, (w, h) = _scene(
        n=300, seed=5, big_frac=0.1, giant_frac=0.02)
    jcfg = _jax_cfg()
    jcam = make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    pre = preprocess(jnp.asarray(means), jnp.asarray(cov6),
                     jnp.asarray(opacity), None, jcam, 0, jcfg,
                     colors_precomp=jnp.asarray(colors))
    planes = _raw_planes_nosentinel(pre)[:9]
    keys_j, emis_j, nd_j, lv = stream_emission(pre, jcam, jcfg, planes)
    sorted_j = jax.lax.sort((keys_j,) + tuple(emis_j[i] for i in range(9)),
                            num_keys=1)
    bounds_j = jnp.searchsorted(
        sorted_j[0], jnp.arange(lv.nf + 1, dtype=jnp.int32) * lv.M)

    t_pre = tr.Preprocessed(*[torch.from_numpy(np.array(f)) for f in pre])
    tcam = t_make_camera(w, h, 0.9, 0.9, np.eye(3), np.zeros(3))
    # the log-opacity row may differ by an ulp between runtimes' log
    np.testing.assert_allclose(tr._raw_planes_nosentinel(t_pre)[:9].numpy(),
                               np.asarray(planes), rtol=1e-6)
    t_planes = torch.from_numpy(np.array(planes))
    keys_t, emis_t, nd_t, tlv = ts.stream_emission(t_pre, tcam, _port_cfg(),
                                                   t_planes)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    assert (tlv.nf, tlv.M) == (lv.nf, lv.M) and int(nd_t) == int(nd_j)
    splanes, bounds = ts.sort_stream(keys_t, emis_t, tlv.nf, tlv.M)
    np.testing.assert_array_equal(
        splanes.numpy(), np.stack([np.asarray(p) for p in sorted_j[1:]]))
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(bounds_j))

