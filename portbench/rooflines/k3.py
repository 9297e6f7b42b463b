"""K3, the forward blend of one image (the stream route; K4 is the same
work on the windowed route): every splat's 9
screen-space planes read once (centre, conic, log opacity, colour), the
image's colour and transmittance (4 floats a pixel) written once.  The
operations depend on the splats' overlap and are not counted, so the bound
is the bytes'.
"""


def count(shape):
    px = shape["width"] * shape["height"]
    return 4.0 * (9 * shape["splats"] + 4 * px), 0.0
