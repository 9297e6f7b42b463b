"""K2, G2P: the grid velocity and every particle's position and F read
once, the new x, v, APIC C and F_trial written once.

Reads x (3), F (9) and 3 floats of every grid node; writes x (3), v (3),
C (9), F_trial (9); ~1900 fp32 operations a particle (27 gathers with the
weights, C's and grad v's outer products, F_trial).
"""


def count(shape):
    n, g = shape["particles"], shape["n_grid"]
    return 4.0 * (12 * n + 3 * g ** 3 + 24 * n), 1900.0 * n
