"""k2_roofline.sim: K2 (G2P, csrc/mpm_transfer.cu g2p_kernel): its bound
(rooflines/k2.py) over its profiled device time, one unit a launch, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "g2p_kernel", "k2")
