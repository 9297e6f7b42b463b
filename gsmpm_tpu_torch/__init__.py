"""gsmpm_tpu_torch: the PyTorch/CUDA port of gsmpm_tpu.

Same layout and names as the JAX package, so each module's counterpart is
easy to find.  Plain tensor code is PyTorch; each TPU (Pallas) kernel on the
ported path is a CUDA C++ kernel for Hopper under ``csrc/``, built with nvcc
at first use (utils/build.py).  Entry points run on CUDA unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch twins run.

Ported so far: the single-device ``apps/simulate`` path (tiled MPM engine
with kernels K1 P2G and K2 G2P, drop-free stream render with kernel K3).
This package imports nothing of JAX or of gsmpm_tpu.
"""

__version__ = "0.1.0"
