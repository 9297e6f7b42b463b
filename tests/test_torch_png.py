"""The port's one PNG decoder (io/dataset.read_png): the native tier's row
unfilter (csrc/gsmpm_png.cpp) against its numpy twin and against a
per-byte decoder written here from the PNG specification, and the
observed-dataset loader against gsmpm_tpu's imageio-based one.

Images are made with numpy from seeds; each file is written with a filter
chosen per row by the encoder below, so every one of the five filters
occurs.  The native tests skip where g++ is missing, as
tests/test_torch_native.py's do.  Every comparison is exact.
"""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from gsmpm_tpu_torch.io import _native
from gsmpm_tpu_torch.io import dataset as tds
from gsmpm_tpu_torch.io.video import decode_png

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG color type


@pytest.fixture
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native IO tier cannot be built "
                    "here (status() reports it; read_png uses the twin)")
    assert _native.status() == "loaded", _native.status()


def _predict(t, left, up, upleft):
    if t == 0:
        return 0
    if t == 1:
        return left
    if t == 2:
        return up
    if t == 3:
        return (left + up) // 2
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    return left if pa <= pb and pa <= pc else (up if pb <= pc else upleft)


def _filtered_rows(img, ftypes):
    """The image's scanlines, row y filtered with ftypes[y] (the PNG
    specification's predictors, one byte at a time)."""
    h, w, c = img.shape
    px = img.reshape(h, w * c).tolist()
    out = bytearray()
    for y in range(h):
        out.append(ftypes[y])
        for i in range(w * c):
            left = px[y][i - c] if i >= c else 0
            up = px[y - 1][i] if y else 0
            upleft = px[y - 1][i - c] if y and i >= c else 0
            out.append((px[y][i] - _predict(ftypes[y], left, up, upleft))
                       & 0xFF)
    return bytes(out)


def _unfilter_reference(raw, h, stride, bpp):
    """A per-byte decoder written from the specification, independent of
    the port's twin."""
    out = [[0] * stride for _ in range(h)]
    pos = 0
    for y in range(h):
        t = raw[pos]
        for i in range(stride):
            left = out[y][i - bpp] if i >= bpp else 0
            up = out[y - 1][i] if y else 0
            upleft = out[y - 1][i - bpp] if y and i >= bpp else 0
            out[y][i] = (raw[pos + 1 + i]
                         + _predict(t, left, up, upleft)) & 0xFF
        pos += 1 + stride
    return np.array(out, np.uint8).reshape(h, stride)


def _png(img, ftypes):
    h, w, c = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(_filtered_rows(img, ftypes)))
            + chunk(b"IEND", b""))


FILTERS = ["0", "1", "2", "3", "4", "mixed"]


def _image(h, w, c, seed):
    """Half smooth, half noise, so the predictors see both."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 3 + yy, yy * 5, (xx + yy) * 2, 255 - xx], -1)
    img = smooth[..., :c] + rng.integers(0, 256, (h, w, c)) * (yy >= h // 2
                                                               )[..., None]
    return (img % 256).astype(np.uint8)


def _ftypes(which, h, seed):
    if which == "mixed":
        return list(np.random.default_rng(seed).permutation(
            np.arange(h) % 5))
    return [int(which)] * h


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 3, 513])
def test_native_unfilter_matches_twin_and_reference(native, channels, width):
    """All five filters alone and mixed per row, one row and seven, gray,
    gray+alpha, RGB and RGBA: the C++ rows equal the numpy twin's, the
    reference decoder's and the image."""
    for h in (1, 7):
        img = _image(h, width, channels, seed=channels * 1000 + width + h)
        stride = width * channels
        for which in FILTERS:
            raw = _filtered_rows(img, _ftypes(which, h, seed=width + h))
            got = _native.png_unfilter(raw, h, stride, channels)
            assert got is not None, which
            want = _unfilter_reference(raw, h, stride, channels)
            np.testing.assert_array_equal(want.reshape(img.shape), img)
            np.testing.assert_array_equal(got, want, err_msg=which)
            np.testing.assert_array_equal(
                tds._unfilter_numpy(raw, h, stride, channels), want,
                err_msg=which)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_native_and_twin(native, channels, tmp_path, monkeypatch):
    """read_png / decode_png of a file with every filter, by the native
    rows and with the tier off (the twin), give the image."""
    img = _image(9, 37, channels, seed=channels)
    path = str(tmp_path / "im.png")
    with open(path, "wb") as f:
        f.write(_png(img, _ftypes("mixed", 9, seed=channels)))
    np.testing.assert_array_equal(tds.read_png(path), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img)
    monkeypatch.setattr(_native, "png_unfilter", lambda *a: None)
    np.testing.assert_array_equal(tds.read_png(path), img)


def test_bad_filter_byte_and_short_data_raise(native):
    raw = bytearray(_filtered_rows(_image(3, 4, 3, seed=0), [0, 1, 2]))
    raw[1 + 12] = 5  # row 1's filter byte
    assert _native.png_unfilter(bytes(raw), 3, 12, 3) is None
    with pytest.raises(ValueError, match="row 1: unknown filter type 5"):
        tds._unfilter(bytes(raw), 3, 12, 3)
    with pytest.raises(ValueError):
        _native.png_unfilter(bytes(raw[:-1]), 3, 12, 3)


def _write_pillow_dataset(root, n_frames=3, res=40):
    """Two RGBA cameras whose frames Pillow writes (its adaptive per-row
    filters), with camera.json, frame.json and physical.json."""
    from PIL import Image

    rng = np.random.default_rng(9)
    cams = []
    for i, name in enumerate(("left", "right")):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.4 * i - 0.2, 0.5, 3.0]
        cams.append({"camera": name, "K": [[45.0, 0, 20], [0, 45.0, 20],
                                           [0, 0, 1]],
                     "c2w": c2w.tolist()})
        os.makedirs(os.path.join(root, name))
        for fid in range(n_frames):
            img = _image(res, res, 4, seed=10 * i + fid)
            img[..., 3] = rng.integers(0, 256, (res, res))
            Image.fromarray(img, "RGBA").save(
                os.path.join(root, name, f"{fid:03d}.png"))
    with open(os.path.join(root, "camera.json"), "w") as f:
        json.dump(cams, f)
    with open(os.path.join(root, "frame.json"), "w") as f:
        json.dump([{f"{i:03d}": 0.033 * i + 0.001 * i * i}
                   for i in range(n_frames)], f)
    with open(os.path.join(root, "physical.json"), "w") as f:
        json.dump({"E": 3e3, "nu": 0.3}, f)


def test_load_observed_dataset_of_pillow_pngs_matches_gsmpm_tpu(tmp_path):
    """load_observed_dataset of Pillow-written PNGs against gsmpm_tpu's
    imageio-based loader on the same files: images bit-equal, cameras and
    frame dts within 1e-6."""
    pytest.importorskip("imageio")
    pytest.importorskip("PIL")
    from gsmpm_tpu.io import dataset as jds

    _write_pillow_dataset(str(tmp_path))
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    want = jds.load_observed_dataset(str(tmp_path), 40, 40, bg)
    got = tds.load_observed_dataset(str(tmp_path), 40, 40, bg)
    assert (got.n_frames, got.n_cameras) == (want.n_frames, want.n_cameras)
    np.testing.assert_allclose(got.frame_dts, want.frame_dts, rtol=1e-6,
                               atol=1e-6)
    for fr_t, fr_j in zip(got.images, want.images):
        for a, b in zip(fr_t, fr_j):
            np.testing.assert_array_equal(a, b)
    for ct, cj in zip(got.cameras, want.cameras):
        for f in ("view", "full_proj", "campos"):
            np.testing.assert_allclose(np.asarray(getattr(ct, f)),
                                       np.asarray(getattr(cj, f)),
                                       rtol=1e-6, atol=1e-6)
