"""Each roofline count against a hand count at a small shape."""

import pytest

from portbench import readers

SHAPE = dict(particles=10, n_grid=2, width=4, height=2, splats=10,
             substeps=3)
# (bytes, fp32 operations) counted by hand: 10 particles, 8 grid nodes,
# 8 pixels, 10 splats
HAND = {
    "k1": (4 * (26 * 10 + 4 * 8), 1260 * 10),
    "k2": (4 * (3 * 10 + 9 * 10 + 3 * 8 + 24 * 10), 1900 * 10),
    "k3": (4 * (9 * 10 + 4 * 8), 0),
    "k4": (4 * (9 * 10 + 4 * 8), 0),
    "k5": (4 * (9 * 10 + 3 * 8 + 4 * 8 + 9 * 10), 0),
    "k6": (4 * (3 + 9 + 64) * 10, 2 * 297 * 3 * 10),
    "k7": (4 * (9 * 10 + 3 * 8 + 4 * 8 + 9 * 10), 0),
    "substep": (4 * ((26 + 24) * 10 + (4 + 4 + 3 + 3) * 8),
                (1260 + 1900) * 10),
}


def _count(layer):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"rl_{layer}", readers.HERE / "rooflines" / f"{layer}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count(SHAPE)


@pytest.mark.parametrize("layer", sorted(HAND))
def test_count(layer):
    nbytes, flops = _count(layer)
    assert nbytes == HAND[layer][0]
    assert flops == HAND[layer][1]


@pytest.mark.parametrize("layer", sorted(HAND))
def test_bound_is_the_larger_of_bytes_and_operations(layer):
    nbytes, flops = HAND[layer]
    p = readers.peaks()
    want = max(nbytes / p["hbm_bytes_per_s"], flops / p["fp32_flops_per_s"])
    assert readers.bound_s(layer, SHAPE) == pytest.approx(want, rel=1e-12)


def test_every_roofline_file_is_counted_here():
    files = {p.stem for p in (readers.HERE / "rooflines").glob("*.py")}
    assert files == set(HAND)
