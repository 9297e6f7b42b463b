"""k3_roofline.fit: K3 (the stream blend, csrc/stream_raster.cu
stream_fwd_kernel): one image's bound (rooflines/k3.py) a launch over its
profiled device time, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "stream_fwd_kernel", "k3")
