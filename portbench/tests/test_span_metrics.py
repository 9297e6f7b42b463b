"""Each per-layer metric reader of the program's own spans
(portbench/program_spans.py) on hand-written span records."""

import importlib.util

import pytest

from portbench import readers


def _span(rid, name, parent, request, start_us, end_us):
    """A program span record (gsmpm_tpu_torch/utils/spans.py) with its host
    and device times the same."""
    t0, t1 = start_us * 1e-6, end_us * 1e-6
    return dict(id=rid, name=name, parent=parent, request=request, thread=1,
                host_start=t0, host_end=t1, dev_start=t0, dev_end=t1,
                dropped=0)


def _fit_frame(request, rid, t0, adjoint_us):
    """A fit frame's spans from t0 (us): forward 48 us with 4 us of gaps
    between its leaves, 9 us of gaps between the frame's leaves."""
    a = adjoint_us
    rows = [("fit.frame", None, 0, 200 + a - 80),
            ("fit.params", 0, 0, 2),
            ("fit.forward", 0, 2, 50),
            ("fit.load", 2, 2, 4), ("fit.substep", 2, 5, 20),
            ("fit.prepare", 2, 22, 25), ("fit.substep", 2, 26, 45),
            ("fit.unpack", 2, 45, 50),
            ("render", 0, 52, 70),
            ("fit.backward", 0, 71, 190 + a - 80),
            ("fit.backward.glue", 9, 71, 80), ("render.backward", 9, 80, 100),
            ("fit.backward.glue", 9, 100, 105),
            ("fit.adjoint", 9, 105, 105 + a),
            ("fit.backward.glue", 9, 105 + a, 110 + a),
            ("fit.update", 0, 112 + a, 120 + a)]
    return [_span(rid + i, n, None if p is None else rid + p, request,
                  t0 + s, t0 + e)
            for i, (n, p, s, e) in enumerate(rows)]


# a set-up capture (request 0), the window's last three steps (a simulate
# frame, two fit frames) and the traced step (request 4)
PROGRAM_SPANS = (
    [_span(1, "graph.capture", None, 0, -50, -10)]
    + [_span(2 + i, n, None if p is None else 2 + p, 1, s, e)
       for i, (n, p, s, e) in enumerate([
           ("sim.frame", None, 0, 59), ("sim.load", 0, 0, 5),
           ("sim.substep", 0, 7, 27), ("sim.substep", 0, 30, 54),
           ("sim.unpack", 0, 54, 59), ("sim.postprocess", None, 60, 70),
           ("render", None, 71, 90)])]
    + _fit_frame(2, 20, 100, 80) + _fit_frame(3, 40, 400, 90)
    + _fit_frame(4, 60, 700, 1000))
REC = dict(program_spans=PROGRAM_SPANS, steps=[dict(fit=True)],
           window_steps=[dict(fit=True), dict(fit=False), dict(fit=True)])

EXPECT = {
    # the sim frame's leaves under sim.frame 0-5, 7-27, 30-54, 54-59 us;
    # with postprocess 60-70 and render 71-90
    "substep_gap_ms.sim": (2 + 3) * 1e-3,
    "replay_ms.sim": (20 + 24) / 2 * 1e-3,
    "device_gap_share.sim": (2 + 3 + 1 + 1) / 90,
    # two fit frames (adjoint 80 and 90 us); the traced one is not read
    "device_gap_share.fit": (9 / 200 + 9 / 210) / 2,
    "forward_ms.fit": 48e-3,
    "forward_gap_ms.fit": 4e-3,
    "adjoint_ms.fit": 85e-3,
    "backward_ms.fit": (119 + 129) / 2 * 1e-3,
}


def read(name, rec=REC):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        readers.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def test_every_span_reader_is_read_here():
    files = {p.name[:-3] for p in (readers.HERE / "metrics").glob("*.py")
             if "program_spans" in p.read_text()}
    assert files == set(EXPECT)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader(name):
    assert read(name) == pytest.approx(EXPECT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader_finds_nothing(name):
    # a program without spans, and spans without device times (the CPU)
    assert read(name, dict(REC, program_spans=[])) is None
    host_only = [dict(r, dev_start=None, dev_end=None) for r in PROGRAM_SPANS]
    assert read(name, dict(REC, program_spans=host_only)) is None
