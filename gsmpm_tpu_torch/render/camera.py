"""Camera model and projection math.

Port of gsmpm_tpu/render/camera.py.  Column-vector matrices
(x_clip = full_proj @ x_world_h).  The matrices are host-side float32 numpy
arrays: preprocess reads their entries as scalars, so a camera needs no
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov * 0.5))


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective with z mapped to [0, zfar/(zfar-znear)]."""
    tan_half_y = math.tan(fovy / 2.0)
    tan_half_x = math.tan(fovx / 2.0)
    top = tan_half_y * znear
    bottom = -top
    right = tan_half_x * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def world_to_view(R_c2w: np.ndarray, position: np.ndarray) -> np.ndarray:
    """W2C 4x4 from a camera-to-world rotation and camera position."""
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, :3] = R_c2w
    c2w[:3, 3] = position
    return np.linalg.inv(c2w).astype(np.float32)


@dataclass
class Camera:
    view: np.ndarray  # (4,4) W2C, column-vector convention, float32
    full_proj: np.ndarray  # (4,4) proj @ view, float32
    campos: np.ndarray  # (3,) float32
    width: int = 800
    height: int = 800
    fovx: float = 0.8
    fovy: float = 0.8

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tanfovy)


def make_camera(width: int, height: int, fovx: float, fovy: float,
                R_c2w: np.ndarray, position: np.ndarray, znear: float = 0.01,
                zfar: float = 100.0) -> Camera:
    view = world_to_view(np.asarray(R_c2w, np.float64),
                         np.asarray(position, np.float64))
    proj = projection_matrix(znear, zfar, fovx, fovy)
    return Camera(
        view=view,
        full_proj=(proj @ view).astype(np.float32),
        campos=np.asarray(position, np.float32),
        width=int(width),
        height=int(height),
        fovx=float(fovx),
        fovy=float(fovy),
    )


def orbit_camera(template: Camera, azimuth: float, elevation: float,
                 radius: float, center: np.ndarray,
                 observant_coordinates: np.ndarray) -> Camera:
    """Re-aim a camera onto an orbit point around the scene center (the
    reference's modify_cam)."""
    from gsmpm_tpu_torch.sim.coupling import get_camera_position_and_rotation

    position, R = get_camera_position_and_rotation(
        azimuth, elevation, radius, center, observant_coordinates
    )
    return make_camera(template.width, template.height, template.fovx,
                       template.fovy, R, position)
