"""Synthetic Gaussian scenes for tests, benchmarks and the smoke run.

Port of gsmpm_tpu/models/synthetic.py.  The random numbers come from numpy
with the same seed and call order, so the port and the JAX package build
bit-identical scenes.
"""

from __future__ import annotations

import numpy as np
import torch

from gsmpm_tpu_torch.models.gaussians import GaussianScene


def _scene_from_numpy(xyz, colors_dc, scale_log, seed_rng, sh_degree, device,
                      opacity_logit=2.0):
    n = xyz.shape[0]
    k_rest = (sh_degree + 1) ** 2 - 1
    quat = seed_rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    rest = 0.01 * seed_rng.normal(size=(n, k_rest, 3)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return GaussianScene(
        xyz=t(xyz),
        features_dc=t(colors_dc.astype(np.float32)[:, None, :]),
        features_rest=t(rest),
        opacity=torch.full((n, 1), opacity_logit, dtype=torch.float32,
                           device=device),
        scaling=t(scale_log),
        rotation=t(quat),
        sh_degree=sh_degree,
    )


def synthetic_blob_scene(
    n: int = 4096, seed: int = 0, sh_degree: int = 3, radius: float = 0.5,
    center=(0.0, 0.0, 1.0), device="cpu",
) -> GaussianScene:
    """Gaussian-distributed blob of splats around `center`."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * radius / 2.0 + np.asarray(center)
    dc = rng.uniform(-1.0, 2.0, size=(n, 3))
    scale_log = np.log(rng.uniform(0.005, 0.03, size=(n, 3)) * radius)
    return _scene_from_numpy(xyz, dc, scale_log, rng, sh_degree, device)


def synthetic_box_scene(
    n: int = 4096,
    seed: int = 0,
    sh_degree: int = 3,
    lo=(-0.5, -0.5, 0.5),
    hi=(0.5, 0.5, 1.5),
    device="cpu",
) -> GaussianScene:
    """Uniform box of splats: a lego-like solid block for MPM runs."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    xyz = rng.uniform(size=(n, 3)) * (hi - lo) + lo
    dc = rng.uniform(-1.0, 2.0, size=(n, 3))
    # particle spacing ~ (volume/n)^(1/3); splat scale a fraction of it
    spacing = (np.prod(hi - lo) / max(n, 1)) ** (1.0 / 3.0)
    scale_log = np.log(rng.uniform(0.5, 1.5, size=(n, 3)) * spacing + 1e-9)
    return _scene_from_numpy(xyz, dc, scale_log, rng, sh_degree, device)
