"""World <-> MPM-grid coupling transforms and covariance packing.

Port of gsmpm_tpu/sim/coupling.py (the reference's utils/transform_utils.py).
Covariances are 6-packed [xx, xy, xz, yy, yz, zz].  The camera-orbit helpers
are host-side numpy, as there.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# world <-> grid normalization
# ---------------------------------------------------------------------------

def world2grid(means3d: torch.Tensor, grid_extent: float, pad: float = 0.0):
    """Fit the scene AABB into the grid cube [0, grid_extent]^3 (centered).

    Returns (transformed_means3d, pos_center (3,), scaling_modifier ()).
    """
    pos_min = means3d.min(dim=0).values - pad
    pos_max = means3d.max(dim=0).values + pad
    pos_center = (pos_min + pos_max) / 2.0
    scaling_modifier = grid_extent / 2.0 / (pos_max - pos_min).max()
    transformed = (means3d - pos_center) * scaling_modifier + grid_extent / 2.0
    return transformed, pos_center, scaling_modifier


def grid2world(
    means3d: torch.Tensor,
    covs6: torch.Tensor,
    scaling_modifier,
    pos_center,
    grid_extent: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of world2grid for positions; covariances scale by 1/s^2."""
    out_means = (means3d - grid_extent / 2.0) / scaling_modifier + pos_center
    out_covs = covs6 / (scaling_modifier * scaling_modifier)
    return out_means, out_covs.reshape(-1, 6)


# ---------------------------------------------------------------------------
# 6-packed symmetric covariance <-> full 3x3
# ---------------------------------------------------------------------------

def mat_from_upper(upper6: torch.Tensor) -> torch.Tensor:
    """(N,6) [xx,xy,xz,yy,yz,zz] -> (N,3,3) symmetric."""
    u = upper6.reshape(-1, 6)
    xx, xy, xz, yy, yz, zz = [u[:, i] for i in range(6)]
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def upper_from_mat(mat: torch.Tensor) -> torch.Tensor:
    """(N,3,3) -> (N,6) upper-triangle packing."""
    m = mat.reshape(-1, 3, 3)
    return torch.stack(
        [m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# rotation pre-transforms
# ---------------------------------------------------------------------------

def rotation_matrix(degree: float, axis: int, device="cpu") -> torch.Tensor:
    """Axis-aligned rotation matrix (degrees)."""
    theta = degree / 180.0 * math.pi
    c, s = math.cos(theta), math.sin(theta)
    if axis == 0:
        m = [[1, 0, 0], [0, c, -s], [0, s, c]]
    elif axis == 1:
        m = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    elif axis == 2:
        m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    else:
        raise ValueError("Invalid axis selection")
    return torch.tensor(m, dtype=torch.float32, device=device)


def rotation_matrices(
    degrees: Sequence[float], axes: Sequence[int], device="cpu"
) -> List[torch.Tensor]:
    if len(degrees) != len(axes):
        raise ValueError("rotation_degree and rotation_axis differ in length")
    return [rotation_matrix(d, a, device) for d, a in zip(degrees, axes)]


def apply_rotations(points: torch.Tensor, mats: Sequence[torch.Tensor]):
    """points (N,3) @ R^T for each R in order."""
    for r in mats:
        points = points @ r.T
    return points


def apply_inverse_rotations(points: torch.Tensor, mats: Sequence[torch.Tensor]):
    for r in reversed(mats):
        points = points @ r
    return points


def apply_cov_rotations(upper6: torch.Tensor, mats: Sequence[torch.Tensor]):
    """R Sigma R^T on 6-packed covariances."""
    cov = mat_from_upper(upper6)
    for r in mats:
        cov = r @ cov @ r.T
    return upper_from_mat(cov)


def apply_inverse_cov_rotations(upper6: torch.Tensor,
                                mats: Sequence[torch.Tensor]):
    cov = mat_from_upper(upper6)
    for r in reversed(mats):
        cov = r.T @ cov @ r
    return upper_from_mat(cov)


def undo_all_transforms(points, mats, scaling_modifier, pos_center,
                        grid_extent: float = 2.0):
    """Map grid-space points back to the original world space."""
    shifted = points - grid_extent / 2.0
    unscaled = pos_center + shifted / scaling_modifier
    return apply_inverse_rotations(unscaled, mats)


# ---------------------------------------------------------------------------
# camera orbit math (numpy, host-side, once per scene)
# ---------------------------------------------------------------------------

def generate_local_coord(vertical: np.ndarray):
    vertical = vertical / np.linalg.norm(vertical)
    h1 = np.array([1.0, 1.0, 1.0])
    if np.abs(np.dot(h1, vertical)) < 0.01:
        h1 = np.array([0.72, 0.37, -0.67])
    h1 = h1 - np.dot(h1, vertical) * vertical
    h1 = h1 / np.linalg.norm(h1)
    h2 = np.cross(h1, vertical)
    return vertical, h1, h2


def get_center_view_worldspace_and_observant_coordinate(
    mpm_space_center: np.ndarray,
    mpm_space_up_axis: np.ndarray,
    mats: Sequence[torch.Tensor],
    scaling_modifier,
    pos_center,
    grid_extent: float = 2.0,
):
    """World-space view center and the orbit frame (h1, h2, vertical)."""
    dev = pos_center.device

    def undo(p):
        t = torch.tensor(np.asarray(p, np.float32).reshape(1, 3), device=dev)
        return undo_all_transforms(
            t, mats, scaling_modifier, pos_center, grid_extent
        ).cpu().numpy()

    center = undo(mpm_space_center)
    up_pt = undo(mpm_space_up_axis + mpm_space_center)
    world_up = (up_pt - center)[0]
    vertical, h1, h2 = generate_local_coord(world_up)
    observant_coordinates = np.column_stack((h1, h2, vertical))
    return center[0], observant_coordinates


def get_point_on_sphere(azimuth, elevation, radius, center, observant_coordinates):
    az, el = np.deg2rad(azimuth), np.deg2rad(elevation)
    canonical = (
        np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
        * radius
    )
    return center + observant_coordinates @ canonical


def generate_camera_rotation_matrix(camera_to_object, object_vertical_downward):
    z = camera_to_object / np.linalg.norm(camera_to_object)
    y = object_vertical_downward - np.dot(object_vertical_downward, z) * z
    y = y / np.linalg.norm(y)
    x = np.cross(y, z)
    return np.column_stack((x, y, z))


def get_camera_position_and_rotation(
    azimuth, elevation, radius, view_center, observant_coordinates
):
    position = get_point_on_sphere(
        azimuth, elevation, radius, view_center, observant_coordinates
    )
    R = generate_camera_rotation_matrix(
        view_center - position, -observant_coordinates[:, 2]
    )
    return position, R
