"""K6, the transfer VJPs' second-order reductions: every particle's
position and cotangent rows read once, its 64 output rows written once.

Reads x (3) and 9 cotangent floats a particle; writes 64 floats a particle;
297 multiply-adds a particle for each of the 3 components.
"""


def count(shape):
    n = shape["particles"]
    return 4.0 * (12 + 64) * n, 2.0 * 297 * 3 * n
