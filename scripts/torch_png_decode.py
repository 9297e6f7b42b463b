"""Time the port's PNG decoder (io/dataset.read_png's) on one seeded
512x512 RGBA frame per row filter: the native tier's C++ rows against the
numpy twin, inflate included, and check that both give the image.

    python3 scripts/torch_png_decode.py [--res 512] [--reps 5]

Prints one line per filter (0 none .. 4 Paeth, and one filter a row) with
the best of --reps decodes each way; host CPU only, no GPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from chip_smoke import png_with_row_filters
    from gsmpm_tpu_torch.io import _native
    from gsmpm_tpu_torch.io.dataset import _decode_png

    print(f"native IO tier: {_native.status()}")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (args.res, args.res, 4), dtype=np.uint8)
    cases = [(str(t), [t] * args.res) for t in range(5)]
    cases.append(("one a row", rng.permutation(np.arange(args.res) % 5)))

    def best(data, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = _decode_png(data)
            times.append(time.perf_counter() - t0)
        assert np.array_equal(out, img)
        return min(times)

    for name, ftypes in cases:
        data = png_with_row_filters(img, ftypes)
        native = best(data, args.reps)
        lib, _native._LIB = _native._LIB, None  # the numpy twin
        try:
            twin = best(data, 1)
        finally:
            _native._LIB = lib
        print(f"filter {name}: {args.res}^2 RGBA decode native "
              f"{native:.4f} s, numpy twin {twin:.4f} s")


if __name__ == "__main__":
    main()
