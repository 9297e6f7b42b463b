"""Binary PLY I/O for 3DGS checkpoints and particle dumps.

Port of gsmpm_tpu/io/ply.py.  All-float32 binary files (the 3DGS
checkpoint layout) are read by the native C++ column reader
(io/_native.py) when it is built, everything else by the numpy codec
below, which is also the fallback when the native tier is not loaded.

- 3DGS checkpoint layout: 62 float32 properties per vertex
  (x y z, nx ny nz, f_dc_0..2, f_rest_0..44, opacity, scale_0..2, rot_0..3),
  as the gaussian-splatting GaussianModel.load_ply/save_ply use it.
- Particle position dump: the reference's particle_position_tensor_to_ply.

A self-contained little-endian binary PLY codec on numpy; no plyfile
dependency.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "int8": np.int8,
    "short": np.int16,
    "int16": np.int16,
    "ushort": np.uint16,
    "uint16": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
}


def _parse_header(f) -> Tuple[int, List[Tuple[str, np.dtype]], str]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file")
    fmt = None
    n_vertex = 0
    props: List[Tuple[str, np.dtype]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                n_vertex = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY missing format line")
    return n_vertex, props, fmt


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a binary or ascii PLY into a dict of columns.

    All-float32 binary files go through the native C++ codec first
    (io/_native.py -> csrc/gsmpm_native.cpp), as in gsmpm_tpu; it returns
    None for anything else (an LFS stub's header too), and binary
    little-endian and ascii files are then read with numpy.
    """
    from gsmpm_tpu_torch.io import _native

    cols = _native.read_ply_f32_columns(path)
    if cols is not None:
        return cols
    with open(path, "rb") as f:
        head = f.read(200)
        if head.startswith(b"version https://git-lfs.github.com"):
            raise FileNotFoundError(
                f"{path} is a git-lfs stub, not real PLY data; "
                "use a synthetic scene (gsmpm_tpu_torch.models.synthetic) instead"
            )
        f.seek(0)
        n, props, fmt = _parse_header(f)
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = data.reshape(n, len(props))
            return {
                name: data[:, i].astype(dt) for i, (name, dt) in enumerate(props)
            }
        if fmt != "binary_little_endian":
            raise ValueError(f"Unsupported PLY format {fmt}")
        rec = np.dtype([(name, np.dtype(dt).newbyteorder("<")) for name, dt in props])
        raw = np.fromfile(f, dtype=rec, count=n)
    return {name: np.ascontiguousarray(raw[name]) for name, _ in props}


def read_gaussian_ply(path: str, sh_degree: int = 3) -> Dict[str, np.ndarray]:
    """Read a 3DGS checkpoint PLY into the raw-parameter dict.

    Returns dict with keys xyz (N,3), features_dc (N,1,3), features_rest
    (N,(deg+1)^2-1,3), opacity (N,1), scaling (N,3), rotation (N,4) — the raw
    (pre-activation) parameters, matching GaussianModel's internal layout.
    """
    cols = read_ply_vertices(path)
    n = cols["x"].shape[0]
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    f_dc = np.stack(
        [cols[f"f_dc_{i}"] for i in range(3)], axis=-1
    ).astype(np.float32)[:, None, :]
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    rest_names = [f"f_rest_{i}" for i in range(n_rest)]
    if rest_names and rest_names[0] in cols:
        # on-disk layout is (3, coeffs) flattened channel-major, matching the
        # 3DGS save convention: f_rest_{c*K + k} = channel c, coeff k
        rest = np.stack([cols[nm] for nm in rest_names], axis=-1).astype(np.float32)
        k = n_rest // 3
        f_rest = rest.reshape(n, 3, k).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, (sh_degree + 1) ** 2 - 1, 3), np.float32)
    opacity = cols["opacity"].astype(np.float32)[:, None]
    scaling = np.stack(
        [cols[f"scale_{i}"] for i in range(3)], axis=-1
    ).astype(np.float32)
    rotation = np.stack(
        [cols[f"rot_{i}"] for i in range(4)], axis=-1
    ).astype(np.float32)
    return dict(
        xyz=xyz,
        features_dc=f_dc,
        features_rest=f_rest,
        opacity=opacity,
        scaling=scaling,
        rotation=rotation,
    )


def write_gaussian_ply(path: str, params: Dict[str, np.ndarray]) -> None:
    """Write a 3DGS checkpoint PLY (62-float layout; inverse of read_gaussian_ply)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xyz = np.asarray(params["xyz"], np.float32)
    n = xyz.shape[0]
    f_dc = np.asarray(params["features_dc"], np.float32).reshape(n, -1)
    f_rest_nk3 = np.asarray(params["features_rest"], np.float32)
    # back to channel-major flattening (3, K) -> f_rest_{c*K+k}
    f_rest = f_rest_nk3.transpose(0, 2, 1).reshape(n, -1)
    opacity = np.asarray(params["opacity"], np.float32).reshape(n, 1)
    scaling = np.asarray(params["scaling"], np.float32).reshape(n, 3)
    rotation = np.asarray(params["rotation"], np.float32).reshape(n, 4)
    normals = np.zeros((n, 3), np.float32)

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    data = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scaling, rotation], axis=1
    ).astype("<f4")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {nm}\n" for nm in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(data).tobytes())


def write_particle_ply(path: str, positions: np.ndarray) -> None:
    """Binary xyz-only particle dump."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    pos = np.asarray(positions, np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {pos.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(pos.astype("<f4")).tobytes())


def read_particle_ply(path: str) -> np.ndarray:
    cols = read_ply_vertices(path)
    return np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
