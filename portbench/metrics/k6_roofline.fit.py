"""k6_roofline.fit: K6 (the transfer VJPs' second-order reductions,
csrc/mpm_sored.cu sored_kernel): its bound (rooflines/k6.py) over its
profiled device time, one unit a launch, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "sored_kernel", "k6")
