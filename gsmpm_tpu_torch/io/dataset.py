"""Observed multi-camera video for system identification.

Port of gsmpm_tpu/io/dataset.py.  Layout of a dataset directory:

    data_path/
      camera.json      # [{"camera": name, "K": 3x3, "c2w": 4x4}, ...]
      frame.json       # [{"000": t0}, {"001": t1}, ...] capture times
      physical.json    # physics metadata (E/nu ground truth etc.)
      <cam_name>/
        000.png ... NNN.png   # RGBA frames, composited onto the bg color

The c2w matrices use the OpenGL/Blender convention (columns 1:3 flip before
inverting); K gives the focal lengths.  PNGs are decoded with the standard
library (``read_png``, 8-bit non-interlaced), the counterpart of the
writer in io/video.py, so no image package is needed.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from gsmpm_tpu_torch.render.camera import Camera, focal2fov, make_camera

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (none, sub, up, average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    c = prev[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                else:
                    raise ValueError(f"PNG filter type {ftype}")
                cur[i] = (cur[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA "
                         f"PNGs are read (depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


@dataclass
class ObservedDataset:
    """Multi-camera video observations: images[fid][cam] is (H, W, 3) f32."""

    cameras: List[Camera]
    images: List[List[np.ndarray]]  # [n_frames][n_cameras]
    frame_dts: List[float]  # len n_frames - 1, from frame.json capture times
    physics: Dict  # physical.json contents ({} if absent)

    @property
    def n_frames(self) -> int:
        return len(self.images)

    @property
    def n_cameras(self) -> int:
        return len(self.cameras)


def _load_image_rgb(path: str, bg: np.ndarray) -> np.ndarray:
    """PNG -> (H, W, 3) float32 in [0, 1], alpha composited onto bg."""
    im = read_png(path).astype(np.float32) / 255.0
    if im.shape[-1] in (1, 2):  # gray (+ alpha)
        im = np.concatenate([np.repeat(im[..., :1], 3, axis=-1),
                             im[..., 1:]], axis=-1)
    if im.shape[-1] == 4:
        rgb, a = im[..., :3], im[..., 3:4]
        im = rgb * a + bg[None, None, :] * (1.0 - a)
    return im[..., :3]


def camera_from_K_c2w(K, c2w, width: int, height: int, znear: float = 0.01,
                      zfar: float = 100.0) -> Camera:
    """Camera from an intrinsic matrix and an OpenGL-convention c2w."""
    c2w = np.array(c2w, dtype=np.float64)
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP/3DGS convention
    fovx = focal2fov(float(K[0][0]), width)
    fovy = focal2fov(float(K[1][1]), height)
    return make_camera(width, height, fovx, fovy, c2w[:3, :3], c2w[:3, 3],
                       znear, zfar)


def load_observed_dataset(
    data_path: str,
    width: int = 512,
    height: int = 512,
    bg: Sequence[float] = (1.0, 1.0, 1.0),
    n_frames: Optional[int] = None,
) -> ObservedDataset:
    """Load an observation directory (see the module docstring)."""
    bg = np.asarray(bg, np.float32)
    with open(os.path.join(data_path, "camera.json")) as f:
        cam_defs = json.load(f)
    cameras = [camera_from_K_c2w(cd["K"], cd["c2w"], width, height)
               for cd in cam_defs]
    names = [cd["camera"] for cd in cam_defs]

    # frame count: explicit, from frame.json, or from the first camera dir
    frame_times = None
    frame_json = os.path.join(data_path, "frame.json")
    if os.path.exists(frame_json):
        with open(frame_json) as f:
            frame_times = [float(list(e.values())[0]) for e in json.load(f)]
    if n_frames is None:
        if frame_times is not None:
            n_frames = len(frame_times)
        else:
            cam_dir = os.path.join(data_path, names[0])
            n_frames = len([p for p in os.listdir(cam_dir)
                            if p.endswith(".png")])
    images = [[_load_image_rgb(os.path.join(data_path, name,
                                             f"{fid:03d}.png"), bg)
               for name in names] for fid in range(n_frames)]
    if frame_times is not None and len(frame_times) >= 2:
        dts = [frame_times[i + 1] - frame_times[i]
               for i in range(min(n_frames, len(frame_times)) - 1)]
    else:
        dts = [1.0 / 25.0] * max(n_frames - 1, 0)
    physics: Dict = {}
    phys_json = os.path.join(data_path, "physical.json")
    if os.path.exists(phys_json):
        with open(phys_json) as f:
            physics = json.load(f)
    return ObservedDataset(cameras=cameras, images=images, frame_dts=dts,
                           physics=physics)
