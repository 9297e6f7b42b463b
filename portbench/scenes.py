"""Seeded synthetic 3DGS scenes, made on the device in a few large calls.

The raw (pre-activation) parameters of the repository's synthetic scenes
(a uniform box of splats, or a gaussian blob), drawn from ``--seed`` with a
``torch.Generator`` on the run's device: positions, DC colours in [-1, 2],
log-scales, unit quaternions, degree-3 SH rest coefficients (0.01 sigma)
and an opacity logit of 2.  The program and the reference are given the
same tensors.
"""

from __future__ import annotations

from typing import Dict

import torch


def make(spec: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """spec: {"kind": "box", "gaussians", "lo", "hi"} or {"kind": "blob",
    "gaussians", "radius", "centre"}; "sh_degree" (3)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    n = int(spec["gaussians"])
    deg = int(spec.get("sh_degree", 3))
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **f32) * (hi - lo) + lo

    if spec["kind"] == "box":
        lo = torch.tensor(spec["lo"], dtype=torch.float32, device=dev)
        hi = torch.tensor(spec["hi"], dtype=torch.float32, device=dev)
        xyz = torch.rand((n, 3), **f32) * (hi - lo) + lo
        spacing = float(torch.prod(hi - lo) / n) ** (1.0 / 3.0)
        log_scale = torch.log(uniform((n, 3), 0.5, 1.5) * spacing + 1e-9)
    elif spec["kind"] == "blob":
        r = float(spec["radius"])
        centre = torch.tensor(spec["centre"], dtype=torch.float32, device=dev)
        xyz = torch.randn((n, 3), **f32) * (r / 2.0) + centre
        log_scale = torch.log(uniform((n, 3), 0.005, 0.03) * r)
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    quat = torch.randn((n, 4), **f32)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    return dict(
        xyz=xyz,
        features_dc=uniform((n, 1, 3), -1.0, 2.0),
        features_rest=0.01 * torch.randn((n, (deg + 1) ** 2 - 1, 3), **f32),
        opacity=torch.full((n, 1), 2.0, dtype=torch.float32, device=dev),
        scaling=log_scale,
        rotation=quat,
    )
