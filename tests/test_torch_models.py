"""The port's host tier (scenes, PLY, cameras, coupling, volumes, SH
preprocess) vs gsmpm_tpu, same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.io.ply import read_gaussian_ply, write_gaussian_ply
from gsmpm_tpu.models.synthetic import synthetic_blob_scene, synthetic_box_scene
from gsmpm_tpu.render.camera import make_camera, orbit_camera
from gsmpm_tpu.render.renderer import RasterConfig, preprocess
from gsmpm_tpu.sim import coupling as jc
from gsmpm_tpu.sim.volume import particle_volume

from gsmpm_tpu_torch.io import ply as tply
from gsmpm_tpu_torch.models import synthetic as tsyn
from gsmpm_tpu_torch.models.convert import SCENE_FIELDS, scene_from_numpy
from gsmpm_tpu_torch.models.gaussians import GaussianScene
from gsmpm_tpu_torch.render import camera as tcam
from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.sim import coupling as tc
from gsmpm_tpu_torch.sim.volume import particle_volume as t_particle_volume


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_scene(scene):
    return {k: np.asarray(getattr(scene, k)) for k in SCENE_FIELDS}


@pytest.mark.parametrize("kind", ["box", "blob"])
def test_synthetic_scenes_bit_identical(kind):
    """Same numpy generator and call order: the port builds the JAX
    package's scene bit for bit."""
    if kind == "box":
        want = synthetic_box_scene(n=777, seed=3, lo=(-0.5, -0.5, 0.2),
                                   hi=(0.5, 0.5, 1.2))
        got = tsyn.synthetic_box_scene(n=777, seed=3, lo=(-0.5, -0.5, 0.2),
                                       hi=(0.5, 0.5, 1.2))
    else:
        want = synthetic_blob_scene(n=333, seed=4)
        got = tsyn.synthetic_blob_scene(n=333, seed=4)
    for k, v in _np_scene(want).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    assert got.sh_degree == want.sh_degree


def test_scene_activations_match_jax():
    want = synthetic_box_scene(n=500, seed=1)
    got = scene_from_numpy(_np_scene(want))
    # sigmoid / exp / quaternion normalization in two runtimes: f32 ulps
    np.testing.assert_allclose(got.get_opacity().numpy(),
                               np.asarray(want.get_opacity()), rtol=1e-6)
    cov_w = np.asarray(want.get_covariance())
    scale = np.abs(cov_w).max()  # off-diagonal terms cancel: scale-relative
    np.testing.assert_allclose(got.get_covariance().numpy() / scale,
                               cov_w / scale, atol=1e-6)
    np.testing.assert_array_equal(got.get_features().numpy(),
                                  np.asarray(want.get_features()))


def test_ply_roundtrip_across_packages(tmp_path):
    scene = synthetic_box_scene(n=64, seed=2)
    write_gaussian_ply(str(tmp_path / "jax.ply"), _np_scene(scene))
    got = GaussianScene.from_ply(str(tmp_path / "jax.ply"))
    for k, v in _np_scene(scene).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    got.save_ply(str(tmp_path / "port.ply"))
    back = read_gaussian_ply(str(tmp_path / "port.ply"))
    for k, v in _np_scene(scene).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    pos = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    tply.write_particle_ply(str(tmp_path / "p.ply"), pos)
    np.testing.assert_array_equal(tply.read_particle_ply(str(tmp_path / "p.ply")),
                                  pos)


def test_cameras_and_orbit_match_jax():
    center = np.array([0.1, -0.2, 0.7], np.float32)
    obs = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    want = orbit_camera(make_camera(800, 600, 0.8, 0.7, np.eye(3),
                                    np.zeros(3)), 130.0, 10.0, 5.75,
                        center, obs)
    got = tcam.orbit_camera(tcam.make_camera(800, 600, 0.8, 0.7, np.eye(3),
                                             np.zeros(3)), 130.0, 10.0, 5.75,
                            center, obs)
    np.testing.assert_array_equal(got.view, np.asarray(want.view))
    np.testing.assert_array_equal(got.full_proj, np.asarray(want.full_proj))
    np.testing.assert_array_equal(got.campos, np.asarray(want.campos))
    assert (got.focal_x, got.focal_y) == (want.focal_x, want.focal_y)


def test_coupling_transforms_and_volume_match_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(400, 3)).astype(np.float32)
    A = rng.normal(size=(400, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    mats_j = jc.rotation_matrices([30.0, -45.0], [0, 2])
    mats_t = tc.rotation_matrices([30.0, -45.0], [0, 2])
    T = torch.from_numpy
    rx_j = jc.apply_rotations(jnp.asarray(xyz), mats_j)
    rx_t = tc.apply_rotations(T(xyz), mats_t)
    np.testing.assert_allclose(rx_t.numpy(), np.asarray(rx_j), atol=1e-6)
    np.testing.assert_allclose(
        tc.apply_cov_rotations(T(cov6), mats_t).numpy(),
        np.asarray(jc.apply_cov_rotations(jnp.asarray(cov6), mats_j)),
        rtol=1e-5, atol=1e-5)
    g_j, c_j, s_j = jc.world2grid(rx_j, 2.0)
    g_t, c_t, s_t = tc.world2grid(rx_t, 2.0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6)
    w_j, wc_j = jc.grid2world(g_j, jnp.asarray(cov6), s_j, c_j, 2.0)
    w_t, wc_t = tc.grid2world(g_t, T(cov6), s_t, c_t, 2.0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_allclose(wc_t.numpy(), np.asarray(wc_j), rtol=1e-5)
    cw_j, obs_j = jc.get_center_view_worldspace_and_observant_coordinate(
        np.array([0.5, 0.5, 0.5], np.float32), np.array([0, 0, 1], np.float32),
        mats_j, s_j, c_j, 2.0)
    cw_t, obs_t = tc.get_center_view_worldspace_and_observant_coordinate(
        np.array([0.5, 0.5, 0.5], np.float32), np.array([0, 0, 1], np.float32),
        mats_t, s_t, c_t, 2.0)
    np.testing.assert_allclose(cw_t, cw_j, atol=1e-5)
    np.testing.assert_allclose(obs_t, obs_j, atol=1e-5)
    # identical cell histogram on identical positions
    g = np.array(g_j)
    np.testing.assert_array_equal(
        t_particle_volume(T(g), 16, 2.0).numpy(),
        np.asarray(particle_volume(jnp.asarray(g), 16, 2.0)))


def test_preprocess_with_sh_matches_jax():
    """EWA projection + degree-3 SH colors on the bench-like scene."""
    scene = synthetic_box_scene(n=2000, seed=7, lo=(-0.5, -0.5, 0.2),
                                hi=(0.5, 0.5, 1.2))
    cam_j = make_camera(256, 192, 0.8, 0.8, np.eye(3),
                        np.array([0.0, 0.0, -3.0]))
    cam_t = tcam.make_camera(256, 192, 0.8, 0.8, np.eye(3),
                             np.array([0.0, 0.0, -3.0]))
    want = preprocess(scene.xyz, scene.get_covariance(),
                      scene.get_opacity(), scene.get_features(), cam_j, 3,
                      RasterConfig())
    ts = scene_from_numpy(_np_scene(scene))
    got = tr.preprocess(ts.xyz, ts.get_covariance(), ts.get_opacity(),
                        ts.get_features(), cam_t, 3, tr.RasterConfig())
    assert bool(np.asarray(want.valid).any())
    for name in tr.Preprocessed._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            # f32 projection math; conics scale like 1/pixel^2
            scale = max(np.abs(w).max(), 1e-12)
            np.testing.assert_allclose(g / scale, w / scale, atol=2e-6,
                                       err_msg=name)
