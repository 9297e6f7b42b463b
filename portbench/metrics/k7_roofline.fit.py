"""k7_roofline.fit: K7 (the stream reverse walk, csrc/stream_raster.cu
stream_bwd_kernel): one image's bound (rooflines/k7.py) a launch over its
profiled device time, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "stream_bwd_kernel", "k7")
