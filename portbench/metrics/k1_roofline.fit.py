"""k1_roofline.fit: K1 (P2G, csrc/mpm_transfer.cu p2g_kernel): its bound
(rooflines/k1.py) over its profiled device time, one unit a launch, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "p2g_kernel", "k1")
