"""Build the port's native sources at first use and load them.

Each CUDA source under gsmpm_tpu_torch/csrc/ exposes a plain C interface
and is compiled on its own into ``build/lib<name>-<hash>.so`` at the
repository root (``-gencode arch=compute_90a,code=sm_90a``), then loaded
with ctypes.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds.
The host C++ IO tier (``NATIVE``: ``csrc/gsmpm_native.cpp``,
``gsmpm_video.cpp`` and ``gsmpm_png.cpp``, the PLY codec, the MJPEG-AVI
writer and the PNG row unfilter) is built the same way with g++ into
``build/libgsmpm_native-<hash>.so``; io/_native.py loads it.  Every library is compiled to a per-process temporary file and
moved into place with ``os.replace``, so processes that build the same
library at once never load a half-written one.
``build_all`` starts one compiler per library at once and waits for all of
them.  Nothing here runs at import time; a machine without nvcc only fails
when a kernel is actually launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# every source of the port, with its extra flags: the two rasterizers keep
# IEEE mul/add order (no FMA contraction) so their power terms round
# exactly as the plain twins'
EXTRA_FLAGS: Dict[str, List[str]] = {
    "mpm_transfer": [],
    "mpm_sored": [],
    "stream_raster": ["--fmad=false"],
    "tile_blend": ["--fmad=false"],
}
SOURCES = tuple(EXTRA_FLAGS)
# the host C++ IO tier: one library of three sources, built with g++ and
# scripts/build_native.sh's flags
NATIVE = "gsmpm_native"
NATIVE_SOURCES = ("gsmpm_native.cpp", "gsmpm_video.cpp", "gsmpm_png.cpp")
NATIVE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "gsmpm_tpu_torch are built on the machine with the GPU"
    )


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native IO tier "
                           "(csrc/gsmpm_native.cpp, gsmpm_video.cpp, "
                           "gsmpm_png.cpp) is host C++")
    return found


def _flags(name: str) -> List[str]:
    if name == NATIVE:
        return NATIVE_FLAGS
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def _inputs(name: str) -> List[Path]:
    """The files on the compiler's command line."""
    if name == NATIVE:
        return [CSRC / s for s in NATIVE_SOURCES]
    return [CSRC / f"{name}.cu"]


def library_path(name: str) -> Path:
    files = _inputs(name)
    if name != NATIVE:
        files += sorted(CSRC.glob("*.cuh"))
    src = b"".join(f.read_bytes() for f in files)
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _tmp_path(name: str) -> Path:
    return library_path(name).with_suffix(f".{os.getpid()}.tmp")


def _start(name: str) -> subprocess.Popen:
    compiler = gxx_path() if name == NATIVE else nvcc_path()
    cmd = [compiler, *_flags(name), "-o", str(_tmp_path(name)),
           *map(str, _inputs(name))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named library that is not current, all compiler
    processes started together.  Returns {name: compiler output}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = {n: _start(n) for n in todo}
    logs = {}
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
            continue
        os.replace(_tmp_path(n), library_path(n))
        (BUILD_DIR / f"{n}.log").write_text(out)
    if failed:
        raise RuntimeError(
            "compiler failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.gsmpm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gsmpm_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.gsmpm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
