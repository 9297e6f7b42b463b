"""3D Gaussian scene container with 3DGS activations and PLY I/O.

Port of gsmpm_tpu/models/gaussians.py: a dataclass of torch tensors holding
the raw (pre-activation) parameters; activations are plain functions.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, replace
from typing import Sequence

import torch

from gsmpm_tpu_torch.io.ply import read_gaussian_ply, write_gaussian_ply
from gsmpm_tpu_torch.sim.coupling import upper_from_mat

SCENE_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
                "rotation")

@dataclass
class GaussianScene:
    """Raw (pre-activation) 3DGS parameters, one tensor per property."""

    xyz: torch.Tensor  # (N, 3)
    features_dc: torch.Tensor  # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    opacity: torch.Tensor  # (N, 1) raw logits
    scaling: torch.Tensor  # (N, 3) log-scales
    rotation: torch.Tensor  # (N, 4) unnormalized quaternions (w, x, y, z)
    sh_degree: int = 3

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def active_sh_degree(self) -> int:
        return self.sh_degree

    # --- activations (3DGS conventions) ---

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        q = self.rotation
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """Sigma = R S S^T R^T as 6-packed upper triangle (N, 6)."""
        S = self.get_scaling() * scaling_modifier
        R = quat_to_rotmat(self.get_rotation())
        L = R * S[:, None, :]  # R @ diag(S)
        return upper_from_mat(L @ L.transpose(-1, -2))

    def with_xyz_at(self, mask_idx: torch.Tensor, new_xyz: torch.Tensor):
        """Copy with a subset of gaussian positions replaced."""
        xyz = self.xyz.clone()
        xyz[mask_idx] = new_xyz
        return replace(self, xyz=xyz)

    def select(self, keep: torch.Tensor) -> "GaussianScene":
        """Copy keeping a boolean mask or an index tensor of gaussians."""
        return replace(self, **{f: getattr(self, f)[keep]
                                for f in SCENE_FIELDS})

    def drop_low_opacity(self, threshold: float = 0.02) -> "GaussianScene":
        """Prune gaussians whose activated opacity is below threshold."""
        return self.select(self.get_opacity().reshape(-1) >= threshold)

    def drop_empty_gaussians(self, mask: torch.Tensor) -> "GaussianScene":
        """Prune gaussians outside a boolean keep-mask (e.g. the sim-area
        mask)."""
        return self.select(torch.as_tensor(mask, dtype=torch.bool,
                                           device=self.xyz.device))

    # --- I/O ---

    @classmethod
    def from_ply(cls, path: str, sh_degree: int = 3,
                 device="cpu") -> "GaussianScene":
        p = read_gaussian_ply(path, sh_degree)
        return cls(**{k: torch.from_numpy(v).to(device) for k, v in p.items()},
                   sh_degree=sh_degree)

    @classmethod
    def from_plys(cls, paths: Sequence[str], sh_degree: int = 3,
                  device="cpu") -> "GaussianScene":
        """Concatenate several checkpoints, skipping missing files."""
        parts = [cls.from_ply(p, sh_degree, device)
                 for p in paths if os.path.exists(p)]
        if not parts:
            raise FileNotFoundError(f"No PLYs found among {list(paths)}")
        return cls(**{n: torch.cat([getattr(p, n) for p in parts])
                      for n in SCENE_FIELDS}, sh_degree=sh_degree)

    def save_ply(self, path: str) -> None:
        write_gaussian_ply(path, {
            n: getattr(self, n).detach().cpu().numpy() for n in SCENE_FIELDS
        })


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Batched unit quaternion (w,x,y,z) -> rotation matrix (N,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def search_for_max_iteration(folder: str) -> int:
    iters = []
    for name in os.listdir(folder):
        m = re.search(r"iteration_(\d+)", name)
        if m:
            iters.append(int(m.group(1)))
    if not iters:
        raise FileNotFoundError(f"No iteration_* checkpoints in {folder}")
    return max(iters)


def load_gaussians(model_path: str, loaded_iter: int = -1, sh_degree: int = 3,
                   device="cpu") -> GaussianScene:
    """Resolve the checkpoint iteration and load point_cloud.ply (+ the
    optional point_cloud2.ply), as the reference's load_model."""
    if loaded_iter == -1:
        loaded_iter = search_for_max_iteration(
            os.path.join(model_path, "point_cloud"))
    base = os.path.join(model_path, "point_cloud", f"iteration_{loaded_iter}")
    return GaussianScene.from_plys(
        [os.path.join(base, "point_cloud.ply"),
         os.path.join(base, "point_cloud2.ply")],
        sh_degree, device,
    )
