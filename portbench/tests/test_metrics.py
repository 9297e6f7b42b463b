"""Each per-layer metric reader on a recorded (hand-written) trace."""

import importlib.util

import pytest

from portbench import readers, trace

SHAPE = dict(particles=1000, n_grid=10, width=64, height=64, splats=1000,
             substeps=4)
# device operations [name, start_us, end_us]: one counted step whose "sim"
# span runs from 0 to 40 us and whose "render" span from 40 to 100 us
OPS = [
    ["p2g_kernel(float const*, float const*)", 0.0, 10.0],
    ["p2g_kernel(float const*, float const*)", 12.0, 22.0],
    ["g2p_kernel(float const*, float const*)", 22.0, 26.0],
    ["sored_kernel(float const*)", 26.0, 30.0],
    ["void at::native::indexFuncLargeIndex<float>(...)", 30.0, 38.0],
    ["stream_fwd_kernel(float const*, int)", 45.0, 60.0],
    ["stream_bwd_kernel(float const*, int)", 60.0, 70.0],
    ["void blend_fwd_kernel<64>(int const*)", 72.0, 75.0],
    ["void blend_fwd_kernel<64>(int const*)", 75.0, 78.0],
    ["void blend_bwd_kernel<64>(int const*)", 80.0, 86.0],
]
REC = dict(
    ops=OPS,
    spans=[["sim", 0.0, 40.0], ["render", 40.0, 100.0]],
    host=[["aten::copy_", 41.0, 45.0], ["cudaDeviceSynchronize", 86.0, 100.0]],
    steps=[dict(fit=True)],
    window_steps=[dict(fit=True, sim_s=0.2, render_s=0.05, replays=60,
                       s=100e-6),
                  dict(fit=False, replays=0, s=100e-6),
                  dict(fit=True, sim_s=0.4, render_s=0.07, replays=90,
                       s=100e-6)],
    shape=SHAPE, counters={}, window_s=100e-6)
REC["busy_s"] = trace.union_us([(s, e) for _, s, e in OPS]) * 1e-6


def read(name, rec=REC):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        readers.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def b(layer):
    return readers.bound_s(layer, SHAPE)


# busy: 0-10, 12-38, 45-70, 72-78, 80-86 = 10 + 26 + 25 + 6 + 6 = 73 us
EXPECT = {
    "sim_ms.sim": 1e3 * (0.2 + 0.4) / 2,
    "render_ms.sim": 1e3 * (0.05 + 0.07) / 2,
    "substep_roofline.sim": 100 * 4 * b("substep") / 36e-6,
    "k1_roofline.sim": 100 * 2 * b("k1") / 20e-6,
    "k1_roofline.fit": 100 * 2 * b("k1") / 20e-6,
    "k2_roofline.sim": 100 * 1 * b("k2") / 4e-6,
    "k2_roofline.fit": 100 * 1 * b("k2") / 4e-6,
    "k6_roofline.fit": 100 * 1 * b("k6") / 4e-6,
    "k3_roofline.sim": 100 * 1 * b("k3") / 15e-6,
    "k3_roofline.fit": 100 * 1 * b("k3") / 15e-6,
    "k7_roofline.fit": 100 * 1 * b("k7") / 10e-6,
    "k4_roofline.fit": 100 * 1 * b("k4") / 6e-6,
    "k5_roofline.fit": 100 * 1 * b("k5") / 6e-6,
    "gather_bwd_ms.fit": 8e-3,
    "rerun_share.fit": 1 - 60 * 2 / 150,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    assert read(name) == pytest.approx(EXPECT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(n for n in EXPECT
                                        if "roofline" in n or "bwd" in n))
def test_reader_finds_nothing(name):
    empty = dict(REC, ops=[], busy_s=0.0)
    assert read(name, empty) is None


def test_pace_is_the_stretch_over_the_windows_own_steps():
    # the traced step took 1.5x the window's own (the profiler's cost)
    assert readers.pace(REC) == pytest.approx(1.0)
    assert readers.pace(dict(REC, window_s=150e-6)) == pytest.approx(1.5)
    assert readers.pace(dict(REC, steps=[dict(fit=True, frame=3)])) is None


def test_every_metric_file_is_read_here():
    files = {p.name[:-3] for p in (readers.HERE / "metrics").glob("*.py")}
    assert files == set(EXPECT)


def test_breakdown_names_the_host_op_of_each_gap():
    bd = trace.breakdown(OPS, REC["host"], REC["spans"])
    gaps = dict(bd["idle_gaps"])
    # 38-45 under aten::copy_ (its middle in the copy), 70-72 and 78-80
    # inside the "render" span, 10-12 inside "sim"
    assert gaps["aten::copy_"] == pytest.approx(7e-6)
    assert gaps["render"] == pytest.approx(4e-6)
    assert gaps["sim"] == pytest.approx(2e-6)
    assert bd["device_ops"][0][0].startswith("p2g_kernel")
