"""gsmpm_tpu_torch: the PyTorch/CUDA port of gsmpm_tpu.

Same layout and names as the JAX package, so each module's counterpart is
easy to find.  Plain tensor code is PyTorch; each TPU (Pallas) kernel on the
ported path is a CUDA C++ kernel for Hopper under ``csrc/``, built with nvcc
at first use (utils/build.py).  Entry points run on CUDA unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch twins run.

Ported so far, on one device: ``apps/simulate`` (tiled MPM engine with
kernels K1 P2G and K2 G2P, drop-free stream render with kernel K3) and
``apps/identify`` (tiled fitting substeps whose transfer VJPs reuse K1/K2
with the second-order kernel K6, the golden engine, the windowed two-tier
render with the tile-blend kernels K4 forward and K5 backward).
This package imports nothing of JAX or of gsmpm_tpu.
"""

__version__ = "0.1.0"
