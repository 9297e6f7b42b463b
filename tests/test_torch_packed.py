"""The port's packed windowed render (RasterConfig(packed=True); kernels K8
/ K9, here their plain twins) vs gsmpm_tpu's packed render and vs the
port's own padded path.

The set-up is tests/test_pallas_render.py::test_packed_stream_matches_padded:
a 256-gaussian box scene on a 64^2 camera at block 16 and chunk 32.  The
JAX side runs ``impl="pallas"`` in interpret mode; the scene crosses over
with models/convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.models.synthetic import synthetic_box_scene
from gsmpm_tpu.render import renderer as jr
from gsmpm_tpu.render.camera import make_camera as j_make_camera

from gsmpm_tpu_torch.models.convert import SCENE_FIELDS, scene_from_numpy
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


CAM = (64, 64, 0.9, 0.9, np.eye(3), np.array([0.0, 0.0, -2.5]))
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
CAPS = dict(block=16, k_tile=128, k_coarse=64, k_global=64, chunk=32)


@pytest.fixture(scope="module")
def scenes():
    js = synthetic_box_scene(n=256, lo=(-0.4, -0.4, 0.2), hi=(0.4, 0.4, 1.0))
    ts = scene_from_numpy({**{k: np.asarray(getattr(js, k))
                              for k in SCENE_FIELDS},
                           "sh_degree": js.sh_degree})
    return js, ts


def _jax_render(js, loss_grad=True, **kw):
    cfg = jr.RasterConfig(impl="pallas", **dict(CAPS, **kw))
    cam = j_make_camera(*CAM)
    cov6, opac, feats = (js.get_covariance(), js.get_opacity().reshape(-1),
                         js.get_features())
    bg = jnp.asarray(BG)

    def f(xyz):
        return jr.render_with_aux(xyz, cov6, opac, feats, cam, bg,
                                  js.sh_degree, cfg)

    img, nd = f(js.xyz)
    g = None
    if loss_grad:
        g = jax.grad(lambda x: jnp.sum(f(x)[0] ** 2))(js.xyz)
    return np.asarray(img), int(nd), g


def _port_render(ts, **kw):
    cfg = tr.RasterConfig(**dict(CAPS, **kw))
    cam = t_make_camera(*CAM)
    xyz = ts.xyz.clone().requires_grad_(True)
    img, nd = tr.render_with_aux(xyz, ts.get_covariance(),
                                 ts.get_opacity().reshape(-1),
                                 ts.get_features(), cam, torch.from_numpy(BG),
                                 ts.sh_degree, cfg)
    torch.sum(img ** 2).backward()
    return img.detach().numpy(), int(nd), xyz.grad.numpy()


def _close(got, want, rel, what):
    scale = np.abs(want).max() + 1e-12
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("kw", [dict(), dict(chunk=64, k_tile=192)])
def test_packed_render_matches_jax_and_padded(scenes, kw):
    """Image, n_dropped and d(sum img^2)/d(means) of the packed render
    against gsmpm_tpu's packed render, and against the port's padded
    path, which the packed twins reproduce exactly (same windows, same
    chunked math)."""
    js, ts = scenes
    img_j, nd_j, g_j = _jax_render(js, packed=True, **kw)
    img_t, nd_t, g_t = _port_render(ts, packed=True, **kw)
    img_u, nd_u, g_u = _port_render(ts, packed=False, **kw)
    assert nd_t == nd_j == nd_u  # the caps drop some: the same count
    np.testing.assert_array_equal(img_t, img_u)
    # the gather backward sums each gaussian's candidates in another order
    _close(g_t, g_u, 1e-6, "packed vs padded grad")
    # the padded path's own JAX tolerance (tests/test_torch_blend.py):
    # elementwise power vs MXU-shaped dots, transmittance by division
    np.testing.assert_allclose(img_t, img_j, atol=2e-3)
    assert np.mean(np.abs(img_t - img_j)) < 5e-6
    _close(g_t, np.asarray(g_j), 1e-3, "packed grad vs JAX")


def test_packed_dF_zero_outside_walked_slots():
    """dF of the packed blend is zero on every slot no block walks (past a
    block's C-aligned count, past the last block), and equals the padded
    twin's dF on the walked ones."""
    rng = np.random.default_rng(3)
    B, C, n_chunks = 16, 32, 3
    counts = torch.tensor([70, 0, 5, 33], dtype=torch.int32)
    aligned = (counts + C - 1) // C * C
    offs = (torch.cumsum(aligned, 0) - aligned).to(torch.int32)
    T = int(aligned.sum()) + 2 * C  # tail slots no block owns
    cand = np.zeros((10, T), np.float32)
    cand[0:2] = rng.uniform(-4.0, B + 4.0, size=(2, T))
    s = rng.uniform(1.0, 4.0, size=T)
    cand[2] = cand[4] = 1.0 / (s * s)
    cand[5] = np.log(rng.uniform(0.05, 0.6, size=T))
    cand[6:9] = rng.uniform(0.0, 1.0, size=(3, T))
    cand[9] = np.ceil(3.0 * s)
    slot = np.arange(T)
    b = np.clip(np.searchsorted(offs.numpy(), slot, side="right") - 1, 0, 3)
    j = slot - offs.numpy()[b]
    cand[5] = np.where((j >= 0) & (j < counts.numpy()[b]), cand[5], -1e30)
    zeros = torch.zeros(T)
    F = cb._build_F(torch.from_numpy(cand), zeros, zeros, B).contiguous()
    meta = cb.BlendMeta(C, B, 1e-4, 1.0 / 255.0, n_chunks)
    out = cb.blend_packed_fwd(counts, offs, F, meta)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(4, 4, B * B))
                                 .astype(np.float32))
    dF = cb.blend_packed_bwd(counts, offs, F, out, g, meta)
    # gsmpm_tpu's mask (_blend_core_packed_bwd): searchsorted over offs
    walked = (j >= 0) & (j < aligned.numpy()[b])
    assert walked.sum() == int(aligned.sum()) and not walked[-2 * C:].any()
    assert float(dF[:, ~torch.from_numpy(walked)].abs().max()) == 0.0
    assert float(dF[:, torch.from_numpy(walked)].abs().max()) > 0.0
    # block 0's window against the padded twin on the same columns
    Fw = F[None, :, 0:n_chunks * C].contiguous()
    dFw = cb.blend_core_bwd_ref(Fw, out[0:1], g[0:1], meta)
    np.testing.assert_array_equal(dF[:, 0:96].numpy(), dFw[0].numpy())


@pytest.mark.parametrize("block,shift,bad", [(0, -32, True), (3, 64, True),
                                             (1, -999, False)])
def test_packed_window_outside_array_raises(block, shift, bad):
    """A walked window that leaves the packed array raises in the twins (the
    kernels' device-side assert); a block that walks nothing may carry any
    offset."""
    B, C = 16, 32
    counts = torch.tensor([70, 0, 5, 33], dtype=torch.int32)
    offs = torch.tensor([0, 96, 96, 128], dtype=torch.int32)
    F = torch.zeros((16, 192))
    meta = cb.BlendMeta(C, B, 1e-4, 1.0 / 255.0, 3)
    offs[block] += shift
    if bad:
        with pytest.raises(ValueError):
            cb.blend_packed_fwd(counts, offs, F, meta)
    else:
        out = cb.blend_packed_fwd(counts, offs, F, meta)
        assert float(out[1, 3].min()) == 1.0  # nothing blended


def test_t_cap_overflow_drops_like_jax(scenes):
    """A t_cap below the C-aligned total drops whole tail blocks: the same
    n_dropped and the same image as gsmpm_tpu's packed render."""
    js, ts = scenes
    kw = dict(packed=True, t_cap=256)
    img_j, nd_j, _ = _jax_render(js, loss_grad=False, **kw)
    img_t, nd_t, _ = _port_render(ts, **kw)
    _, nd_caps, _ = _port_render(ts, packed=True)  # the caps' own drops
    assert nd_t == nd_j > nd_caps
    np.testing.assert_allclose(img_t, img_j, atol=2e-3)
