"""Build the port's CUDA sources with nvcc at first use and load them.

Each source under gsmpm_tpu_torch/csrc/ exposes a plain C interface and is
compiled on its own into ``build/lib<name>-<hash>.so`` at the repository
root (``-gencode arch=compute_90a,code=sm_90a``), then loaded with ctypes.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.
``build_all`` starts one nvcc per source at once and waits for all of them.
Nothing here runs at import time; a machine without nvcc only fails when a
kernel is actually launched.
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


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _tmp_path(name: str) -> Path:
    return library_path(name).with_suffix(f".{os.getpid()}.tmp")


def _start(name: str) -> subprocess.Popen:
    cmd = [nvcc_path(), *_flags(name), "-o", str(_tmp_path(name)),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
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
            "nvcc failed for " + ", ".join(failed) + ":\n"
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
