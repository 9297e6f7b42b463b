"""cameras.json loading (port of gsmpm_tpu/io/cameras.py).

Reads the 3DGS-format cameras.json (id, img_name, width, height, position,
rotation, fx, fy) next to a trained model.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from gsmpm_tpu_torch.render.camera import Camera, focal2fov, make_camera


def load_cameras(model_path: str, znear: float = 0.01,
                 zfar: float = 100.0) -> List[Camera]:
    with open(os.path.join(model_path, "cameras.json")) as f:
        cam_infos = json.load(f)
    cameras = []
    for info in cam_infos:
        width, height = info["width"], info["height"]
        fovx = focal2fov(info["fx"], width)
        fovy = focal2fov(info["fy"], height)
        position = np.array(info["position"], dtype=np.float64)
        R_c2w = np.array(info["rotation"], dtype=np.float64)
        cameras.append(
            make_camera(width, height, fovx, fovy, R_c2w, position, znear, zfar)
        )
    return cameras
