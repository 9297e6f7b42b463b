"""Observed multi-camera video for system identification.

Port of gsmpm_tpu/io/dataset.py.  Layout of a dataset directory:

    data_path/
      camera.json      # [{"camera": name, "K": 3x3, "c2w": 4x4}, ...]
      frame.json       # [{"000": t0}, {"001": t1}, ...] capture times
      physical.json    # physics metadata (E/nu ground truth etc.)
      <cam_name>/
        000.png ... NNN.png   # RGBA frames, composited onto the bg color

The c2w matrices use the OpenGL/Blender convention (columns 1:3 flip before
inverting); K gives the focal lengths.  PNGs are decoded here
(``read_png``: 8-bit non-interlaced gray, gray+alpha, RGB, RGBA), the
counterpart of the writer in io/video.py, so no image package is needed:
zlib inflates, and the row filters are undone by the native IO tier's C++
(io/_native.py) or, where it is not loaded, by the numpy twin.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from gsmpm_tpu_torch.io import _native
from gsmpm_tpu_torch.render.camera import Camera, focal2fov, make_camera

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels


def _unfilter_numpy(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of h rows of a filter byte and ``stride`` bytes, ``bpp`` bytes a
    pixel: the numpy twin of the native tier's ``png_unfilter``, and its
    fallback."""
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, -1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, f = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = f
        elif ftype == 1:  # sub: a running sum along each channel, mod 256
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (f + prior) & 0xFF
        elif ftype in (3, 4):  # each pixel needs its left one: a loop
            cur = np.empty_like(f)
            left = upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                left = (f[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The native unfilter where the tier is loaded, else the twin."""
    out = _native.png_unfilter(raw, h, stride, bpp)
    return _unfilter_numpy(raw, h, stride, bpp) if out is None else out


def _decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8; C = 1, 2, 3 or 4 (gray, gray+alpha,
    RGB, RGBA), 8-bit, non-interlaced, any row filters."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{what}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{what}: only 8-bit non-interlaced gray, gray+alpha,"
                         f" RGB and RGBA PNGs are read (depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * ch + 1):
        raise ValueError(f"{what}: {len(raw)} image bytes for {h} rows of "
                         f"{w * ch} + 1")
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        return _decode_png(f.read(), path)


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
