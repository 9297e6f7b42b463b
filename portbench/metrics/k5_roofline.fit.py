"""k5_roofline.fit: K5 (the windowed reverse walk, csrc/tile_blend.cu
blend_bwd_kernel, both tiers): one image's bound (rooflines/k5.py) a fit
frame over its profiled device time, in %."""

from portbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "blend_bwd_kernel", "k5", per="step")
