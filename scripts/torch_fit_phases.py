"""Run chip_smoke.py's fit phases of the PyTorch port alone on one GPU.

    python3 scripts/torch_fit_phases.py

Builds the kernels, then calls chip_smoke's ``identify_path`` (apps.identify
at the bench fit: 245,760 gaussians, 512^2, 30 substeps), ``steady_fit``
(steady fit frames with exact launches), ``fit_profile`` (one profiled fit
frame) and ``fit_graph_phase`` (the fit window's graphs against the
checkpointed window in turns, the four-range split of a frame), with the
same gates, and prints the fit_graph phase's numbers as one JSON line.
About three minutes of the card where the whole chip_smoke.py takes seven.
Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gsmpm_tpu_torch.utils import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fit_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    build.build_all(build.SOURCES + (build.NATIVE,))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    from gsmpm_tpu_torch.render import cuda_blend, stream_raster
    from gsmpm_tpu_torch.sim import cuda_mpm

    wrappers = [cuda_mpm.p2g_tiled, cuda_mpm.g2p_tiled,
                stream_raster.stream_blend, cuda_mpm.sored_tiled,
                cuda_blend.blend_fwd, cuda_blend.blend_bwd,
                stream_raster.stream_blend_bwd, cuda_blend.blend_packed_fwd,
                cuda_blend.blend_packed_bwd]
    ident, _, _ = cs.identify_path(dev, wrappers)
    steady, first, gt, cams = cs.steady_fit(dev, ident, wrappers)
    cs.fit_profile(dev, ident, first, steady)
    _, fit_graph = cs.fit_graph_phase(dev, ident, gt, cams, wrappers)
    print(json.dumps(fit_graph))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
