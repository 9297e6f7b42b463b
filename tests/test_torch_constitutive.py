"""The port's constitutive laws and 3x3 SVD vs gsmpm_tpu, same inputs.

Both sides run the same elementwise f32 formulas in the same order, so the
tolerances are a few ulps of the quantities' scale, not physics tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmpm_tpu.ops.m33 as jm33
from gsmpm_tpu.ops.constitutive import compute_stress_soa
from gsmpm_tpu.ops.svd3 import polar_rotation, svd3x3

import gsmpm_tpu_torch.ops.m33 as tm33
from gsmpm_tpu_torch.ops.constitutive import compute_stress_soa as t_stress
from gsmpm_tpu_torch.ops.svd3 import polar_rotation as t_polar
from gsmpm_tpu_torch.ops.svd3 import svd3x3 as t_svd3x3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_F(n, seed=0, scale=0.12):
    rng = np.random.default_rng(seed)
    return (np.eye(3) + scale * rng.normal(size=(n, 3, 3))).astype(np.float32)


def _planes(F):
    return tuple(torch.from_numpy(np.ascontiguousarray(F[:, i, j]))
                 for i in range(3) for j in range(3))


@pytest.mark.parametrize(
    "mats", [(0,), (1,), (2,), (3,), (4,), (5,), (0, 1, 2, 3, 4, 5)],
    ids=["jelly", "metal", "sand", "foam", "fluid", "plasticine", "mixed"],
)

def test_compute_stress_soa_matches_jax(mats):
    n = 256
    rng = np.random.default_rng(1)
    F = _rand_F(n, seed=2)
    material = rng.choice(list(mats), size=n).astype(np.int32)
    mu = rng.uniform(1e3, 1e5, n).astype(np.float32)
    lam = rng.uniform(1e3, 1e5, n).astype(np.float32)
    ys = rng.uniform(1e2, 1e4, n).astype(np.float32)
    # scalars as the models hold them: f32 values
    alpha, xi, pv, soft, dt = 0.3, 0.01, 10.0, 0.1, 1e-4

    Fj, sj, yj = compute_stress_soa(
        jm33.from_aos(jnp.asarray(F)), jnp.asarray(material), jnp.asarray(mu),
        jnp.asarray(lam), jnp.asarray(ys), jnp.float32(alpha), 1,
        jnp.float32(xi), jnp.float32(pv), jnp.float32(soft), dt,
        active_materials=tuple(mats),
    )
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    T = torch.from_numpy
    Ft, st, yt = t_stress(
        _planes(F), T(material), T(mu), T(lam), T(ys), f32(alpha), 1,
        f32(xi), f32(pv), f32(soft), dt, active_materials=tuple(mats),
    )
    Fj = np.stack([np.asarray(p) for p in Fj])
    sj = np.stack([np.asarray(p) for p in sj])
    # same formulas in f32; transcendental ulps differ between the two
    # runtimes, amplified by the Jacobi iteration and the return map
    np.testing.assert_allclose(torch.stack(Ft).numpy(), Fj, atol=2e-5)
    scale = max(np.abs(sj).max(), 1.0)
    np.testing.assert_allclose(torch.stack(st).numpy() / scale, sj / scale,
                               atol=2e-5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5)


def _well_separated(n, seed, flip):
    """R1 diag(s) R2^T with singular values >= 0.3 apart (so U and V are
    well conditioned), det < 0 for every other matrix when ``flip``."""
    rng = np.random.default_rng(seed)
    R1 = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    R2 = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    s = 0.5 + 0.4 * np.arange(3)[None, :] + 0.1 * rng.random((n, 3))
    if flip:
        s[::2, 0] *= -1.0
    return np.einsum("nij,nj,nkj->nik", R1, s, R2).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True], ids=["det+", "det-"])
def test_svd3x3_matches_jax(flip):
    """AoS Jacobi SVD: identical sweeps and sort network, so U, sigma and V
    (signs and order included) agree, not only the reconstruction."""
    A = _well_separated(256, seed=4, flip=flip)
    Uj, sj, Vj = svd3x3(jnp.asarray(A))
    Ut, st, Vt = t_svd3x3(torch.from_numpy(A))
    # ulps of sqrt/divide differ between the runtimes; 5 Jacobi sweeps
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=2e-4)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=2e-4)
    np.testing.assert_allclose(t_polar(torch.from_numpy(A)).numpy(),
                               np.asarray(polar_rotation(jnp.asarray(A))),
                               atol=2e-4)


def test_planes_svd3_matches_jax():
    A = _well_separated(256, seed=6, flip=True)
    Uj, sj, Vj = jm33.svd3(jm33.from_aos(jnp.asarray(A)))
    Ut, st, Vt = tm33.svd3(_planes(A))
    for got, want in ((Ut, Uj), (st, sj), (Vt, Vj)):
        np.testing.assert_allclose(torch.stack(got).numpy(),
                                   np.stack([np.asarray(p) for p in want]),
                                   atol=2e-4)
    np.testing.assert_allclose(
        torch.stack(tm33.polar_rotation(_planes(A))).numpy(),
        np.stack([np.asarray(p)
                  for p in jm33.polar_rotation(jm33.from_aos(jnp.asarray(A)))]),
        atol=2e-4,
    )
