"""gsmpm_tpu_torch: the PyTorch/CUDA port of gsmpm_tpu.

Same layout and names as the JAX package, so each module's counterpart is
easy to find.  Plain tensor code is PyTorch; each TPU (Pallas) kernel on the
ported path is a CUDA C++ kernel for Hopper under ``csrc/``, built with nvcc
at first use (utils/build.py).  Entry points run on CUDA unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch twins run.

It does what gsmpm_tpu does, under gsmpm_tpu's names and parameter
order (tests/test_torch_api.py holds the two interfaces together; what
the port stands in for, or lacks, is listed there with its reason):
``apps/simulate`` (the tiled MPM engine with kernels K1 P2G and K2 G2P,
the golden route, checkpoints, the drop-free stream render with kernel
K3), ``apps/identify`` (the tiled fitting substeps whose transfer VJPs
reuse K1 / K2 with the second-order kernel K6, the windowed render with
the tile-blend kernels K4 / K5, or the stream render with K3 / K7, the
packed layout with K8 / K9, observed datasets from ``--data_path``),
``sim.MPMSolver``, multi-GPU runs over ``torch.distributed``
(``parallel/``) and a native C++ IO tier (PLY codec, PNG row unfilter,
MJPEG-AVI writer; ``io/_native.py``).
This package imports nothing of JAX or of gsmpm_tpu.
"""

__version__ = "0.1.0"
