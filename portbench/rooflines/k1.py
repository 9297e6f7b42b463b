"""K1, P2G: every particle's rows read once, the grid written once.

Reads x (3), v (3), APIC C (9), mass, volume and the stress (9): 26 floats
a particle; writes mass and momentum (4 floats) of every grid node; ~1260
fp32 operations a particle (27 nodes: weights, the APIC and stress terms,
the 4 sums).
"""


def count(shape):
    n, g = shape["particles"], shape["n_grid"]
    return 4.0 * (26 * n + 4 * g ** 3), 1260.0 * n
