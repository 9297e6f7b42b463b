"""Frame saving (PNG) and video encoding.

Port of gsmpm_tpu/io/video.py.  PNGs are written with the standard
library (zlib + struct: ``encode_png``) and read by io/dataset.read_png's
decoder (``decode_png``), so no image package is needed.
``encode_video`` writes an H.264 mp4 through ffmpeg when it is on PATH,
else an MJPEG-in-AVI through the native encoder (io/_native.py,
csrc/gsmpm_video.cpp), else nothing.
"""

from __future__ import annotations

import os
import struct
import subprocess
import zlib
from typing import Optional

import numpy as np

from gsmpm_tpu_torch.io.dataset import _decode_png


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8: io/dataset.read_png's decoder (8-bit,
    non-interlaced, any row filters); the inverse of ``encode_png``."""
    return _decode_png(data)


def save_frame(frame: np.ndarray, save_dir: str, fid: int) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{fid:04d}.png")
    with open(path, "wb") as f:
        f.write(encode_png(to8b(np.asarray(frame))))
    return path


def _frame_names(images_dir: str):
    return sorted(
        f for f in os.listdir(images_dir) if f.endswith(".png")
    ) if os.path.isdir(images_dir) else []


def encode_mp4(images_dir: str, out_path: str, fps: int = 25) -> bool:
    """H.264 mp4 from numbered PNGs; pads to even dims like the reference.

    Returns False (and leaves the PNG sequence) if ffmpeg is unavailable.
    """
    cmd = [
        "ffmpeg", "-framerate", str(fps),
        "-i", os.path.join(images_dir, "%04d.png"),
        "-c:v", "libx264", "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
        "-y", "-pix_fmt", "yuv420p", out_path,
    ]
    try:
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
        return True
    except (FileNotFoundError, subprocess.CalledProcessError):
        return False


def encode_avi(images_dir: str, out_path: str, fps: int = 25,
               quality: int = 90) -> bool:
    """MJPEG-in-AVI from numbered PNGs via the native encoder
    (csrc/gsmpm_video.cpp) -- no ffmpeg required.  Returns False if the
    native tier or the frames are unavailable (``_native.status()`` says
    why for the tier).
    """
    from gsmpm_tpu_torch.io import _native

    if not _native.avi_available():
        return False
    names = _frame_names(images_dir)
    if not names:
        return False

    def read(name):
        with open(os.path.join(images_dir, name), "rb") as f:
            return decode_png(f.read())

    first = read(names[0])
    h, w = first.shape[:2]
    try:
        with _native.AviWriter(out_path, w, h, fps, quality) as vw:
            for name in names:
                vw.add_frame(read(name)[..., :3])
        return True
    except (RuntimeError, ValueError, OSError):
        return False


def encode_video(images_dir: str, out_base: str, fps: int = 25) -> Optional[str]:
    """Encode the PNG sequence to a video beside the reference's mp4
    output: H.264 mp4 when ffmpeg exists, else the native MJPEG AVI.
    Returns the written path or None.
    """
    mp4 = out_base + ".mp4"
    if encode_mp4(images_dir, mp4, fps):
        return mp4
    avi = out_base + ".avi"
    if encode_avi(images_dir, avi, fps):
        return avi
    return None
