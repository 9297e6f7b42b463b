"""K5, the backward blend of one image (the windowed route, both tiers;
K7 is the same work on the stream route): every splat's 9
planes and the image's cotangent (3 floats a pixel) and blend state (4)
read once, the splats' 9 plane gradients written once.  The operations
depend on the overlap and are not counted, so the bound is the bytes'.
"""


def count(shape):
    n, px = shape["splats"], shape["width"] * shape["height"]
    return 4.0 * (9 * n + 7 * px + 9 * n), 0.0
