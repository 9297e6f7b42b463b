"""Frame saving (PNG) and video encoding.

Port of gsmpm_tpu/io/video.py.  PNGs are written with the standard library
(zlib + struct), so no image package is needed.  ``encode_video`` uses
ffmpeg when it is on PATH and returns None otherwise (the native MJPEG-AVI
tier of the JAX package is not ported yet).
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import zlib
from typing import Optional

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    """The reference's to8b: [0, 1] floats -> uint8."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG bytes (8-bit, filter 0)."""
    h, w, c = rgb8.shape
    if c not in (3, 4) or rgb8.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3|4) uint8, got {rgb8.shape} "
                         f"{rgb8.dtype}")
    color_type = 2 if c == 3 else 6
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(rgb8).reshape(h, -1)],
        axis=1,
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def save_frame(frame: np.ndarray, save_dir: str, fid: int) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{fid:04d}.png")
    with open(path, "wb") as f:
        f.write(encode_png(to8b(np.asarray(frame))))
    return path


def encode_video(images_dir: str, out_base: str, fps: int = 25) -> Optional[str]:
    """H.264 mp4 from the numbered PNGs (even dims padded, as the
    reference's ffmpeg call) when ffmpeg exists; else None."""
    if shutil.which("ffmpeg") is None:
        return None
    mp4 = out_base + ".mp4"
    cmd = [
        "ffmpeg", "-framerate", str(fps),
        "-i", os.path.join(images_dir, "%04d.png"),
        "-c:v", "libx264", "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
        "-y", "-pix_fmt", "yuv420p", mp4,
    ]
    done = subprocess.run(cmd, stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL, check=False)
    return mp4 if done.returncode == 0 else None
