"""One MPM substep, whatever kernels do it: the particle planes and the
grid read and written once.

Particles: x, v, C, F, mass, volume read (26 floats), x, v, C, F written
(24); the grid: P2G's 4 planes written, read by the grid update, which
writes 3 velocity planes that G2P reads (14 floats a node).  Operations:
K1's and K2's (1260 + 1900 a particle); the stress is not counted.
"""


def count(shape):
    n, g = shape["particles"], shape["n_grid"]
    return 4.0 * (50 * n + 14 * g ** 3), 3160.0 * n
