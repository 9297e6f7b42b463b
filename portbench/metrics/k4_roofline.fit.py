"""k4_roofline.fit: K4 (the windowed blend, csrc/tile_blend.cu
blend_fwd_kernel, both tiers): one image's bound (rooflines/k4.py) a fit
frame over its profiled device time, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "blend_fwd_kernel", "k4", per="step")
