"""The port's native IO tier (io/_native.py over csrc/gsmpm_native.cpp and
gsmpm_video.cpp), its PNG decoder and video encoders vs gsmpm_tpu.

The native library is built with g++ into build/ on first use; the tests
that need it skip where g++ is missing (the tier is then reported by
``status()`` and the callers take the pure-Python codec).  gsmpm_tpu's own
library is never built here: its AVI writer runs on the port's loaded
library, handed to gsmpm_tpu/io/_native.py for the test's duration (both
come from the same C++ code), so this file races no other test's build.
Every comparison is exact: the codecs move float32 bits and the AVI
writer is deterministic.
"""

import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from gsmpm_tpu.io import _native as jnative
from gsmpm_tpu.io.video import encode_avi as j_encode_avi

from gsmpm_tpu_torch.io import _native
from gsmpm_tpu_torch.io.ply import (
    read_gaussian_ply,
    read_ply_vertices,
    write_gaussian_ply,
)
from gsmpm_tpu_torch.io.video import (
    decode_png,
    encode_avi,
    encode_png,
    encode_video,
    save_frame,
)


@pytest.fixture
def native():
    """The port's loaded native library."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native IO tier cannot be built "
                    "here (status() reports it; callers use numpy)")
    assert _native.status() == "loaded", _native.status()
    return _native._load()


def _python_codec(monkeypatch):
    """Make the port's _native report 'not loaded' until the test ends."""
    monkeypatch.setattr(_native, "_TRIED", True)
    monkeypatch.setattr(_native, "_LIB", None)


def _gaussian_params(n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa: E731
    return dict(xyz=f(3), features_dc=f(1, 3), features_rest=f(15, 3),
                opacity=f(1), scaling=f(3), rotation=f(4))


def test_native_ply_roundtrip_bit_equal_to_python(native, tmp_path,
                                                  monkeypatch):
    """A 62-property 3DGS file written by the numpy writer: the native
    columns equal the numpy reader's bit for bit, and the native writer
    reproduces the file's bytes from those columns."""
    path = str(tmp_path / "g.ply")
    params = _gaussian_params(3000)
    write_gaussian_ply(path, params)
    cols_native = _native.read_ply_f32_columns(path)
    assert cols_native is not None and len(cols_native) == 62
    assert read_ply_vertices(path).keys() == cols_native.keys()
    scene_native = read_gaussian_ply(path)
    with monkeypatch.context() as m:
        _python_codec(m)
        assert _native.read_ply_f32_columns(path) is None
        cols_py = read_ply_vertices(path)
        scene_py = read_gaussian_ply(path)
    assert list(cols_py) == list(cols_native)
    for k, v in cols_py.items():
        assert v.dtype == cols_native[k].dtype == np.float32
        np.testing.assert_array_equal(v.view(np.uint32),
                                      cols_native[k].view(np.uint32))
    for k in params:
        np.testing.assert_array_equal(scene_native[k], scene_py[k])
        np.testing.assert_array_equal(scene_py[k],
                                      params[k].reshape(scene_py[k].shape))

    with open(path, "rb") as f:
        raw = f.read()
    header = raw[:raw.index(b"end_header\n") + len(b"end_header\n")]
    planar = np.stack(list(cols_py.values()))
    out = str(tmp_path / "native.ply")
    assert _native.write_ply_f32_planar(out, header.decode(), planar)
    with open(out, "rb") as f:
        assert f.read() == raw


def test_lfs_stub_rejected_with_native_loaded(native, tmp_path):
    """An LFS stub's header fails the native parse (None), and the stub
    check of the numpy path still raises."""
    stub = tmp_path / "point_cloud.ply"
    stub.write_text("version https://git-lfs.github.com/spec/v1\n"
                    "oid sha256:" + "0" * 64 + "\nsize 61440000\n")
    assert _native.read_ply_f32_columns(str(stub)) is None
    with pytest.raises(FileNotFoundError, match="git-lfs stub"):
        read_ply_vertices(str(stub))


def test_no_native_env_gives_python_path(tmp_path, monkeypatch):
    """GSMPM_NO_NATIVE: no library, status() names the variable, and the
    numpy codec reads the file."""
    path = str(tmp_path / "g.ply")
    params = _gaussian_params(50, seed=1)
    write_gaussian_ply(path, params)
    monkeypatch.setenv("GSMPM_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_STATUS", "not tried")
    assert _native.read_ply_f32_columns(path) is None
    assert _native.status() == "disabled by GSMPM_NO_NATIVE"
    assert not _native.avi_available()
    np.testing.assert_array_equal(read_gaussian_ply(path)["xyz"],
                                  params["xyz"])


def _png_filtered(img: np.ndarray, ftypes) -> bytes:
    """8-bit RGB(A) PNG with row y filtered by ftypes[y % len(ftypes)]."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        t = ftypes[y % len(ftypes)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8)
                    .tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_png(channels, tmp_path):
    """decode_png against imageio on imageio's PNGs (its adaptive filters),
    on PNGs using each of the five filter types, and as encode_png's
    inverse."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(channels)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 5, (xx + yy) * 2, 255 - xx], -1)
    noisy = (smooth + rng.integers(0, 40, smooth.shape)) % 256
    for img in (smooth, noisy):
        img = img[..., :channels].astype(np.uint8)
        path = str(tmp_path / "im.png")
        imageio.imwrite(path, img)
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(decode_png(data), imageio.imread(path))
        np.testing.assert_array_equal(decode_png(data), img)
        for ftypes in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
            np.testing.assert_array_equal(
                decode_png(_png_filtered(img, ftypes)), img)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def _frames(images_dir, n=3, h=48, w=40):
    rng = np.random.default_rng(7)
    for fid in range(n):
        save_frame(rng.uniform(size=(h, w, 3)).astype(np.float32),
                   str(images_dir), fid)


def _avi_chunks(data: bytes):
    """The '00dc' chunk payloads of the 'movi' list, and the idx1 count."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    movi = data.index(b"movi")
    idx1 = data.index(b"idx1")
    pos, payloads = movi + 4, []
    while pos < idx1 - 8:
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        assert tag == b"00dc", tag
        payloads.append(data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    n_idx = struct.unpack("<I", data[idx1 + 4:idx1 + 8])[0] // 16
    return payloads, n_idx


def test_encode_avi_byte_identical_to_gsmpm_tpu(native, tmp_path):
    """The port's encode_avi (decode_png + the native writer) and
    gsmpm_tpu's (imageio + the same writer, handed the port's library) on
    one frame folder: the same bytes, one JPEG chunk a frame."""
    images = tmp_path / "images"
    _frames(images)
    ours, theirs = str(tmp_path / "port.avi"), str(tmp_path / "jax.avi")
    assert encode_avi(str(images), ours)
    saved = (jnative._TRIED, jnative._LIB)
    jnative._TRIED, jnative._LIB = True, native
    try:
        assert j_encode_avi(str(images), theirs)
    finally:
        jnative._TRIED, jnative._LIB = saved
    with open(ours, "rb") as f:
        data = f.read()
    with open(theirs, "rb") as f:
        assert f.read() == data
    payloads, n_idx = _avi_chunks(data)
    assert len(payloads) == n_idx == 3
    assert all(p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9"
               for p in payloads)


def test_encode_video_writes_avi_without_ffmpeg(native, tmp_path,
                                                monkeypatch):
    images = tmp_path / "images"
    _frames(images, n=2)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    base = str(tmp_path / "simulated")
    assert encode_video(str(images), base) == base + ".avi"
    assert os.path.getsize(base + ".avi") > 0
    assert not os.path.exists(base + ".mp4")
