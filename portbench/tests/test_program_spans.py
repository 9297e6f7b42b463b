"""portbench/program_spans.py: which of the program's span records a
traced run's readers take, and the helpers they share."""

import pytest

from portbench import program_spans as ps


def _rec(request, name="fit.frame", rid=None, parent=None, dev=(0.0, 1.0),
         dropped=0):
    return dict(id=rid if rid is not None else request * 10, name=name,
                parent=parent, request=request, thread=1,
                host_start=dev[0], host_end=dev[1], dev_start=dev[0],
                dev_end=dev[1], dropped=dropped)


def _run(n_requests, n_window, n_trace, **extra):
    """A run's record: one frame span a request, 1..n_requests."""
    spans = [_rec(q) for q in range(1, n_requests + 1)]
    return dict(program_spans=spans, window_steps=[{}] * n_window,
                steps=[{}] * n_trace, **extra)


def _requests(got):
    return [s[0]["request"] for s in got]


def test_the_window_steps_before_the_traced_stretch():
    # requests 9-10 are the traced stretch; of 1-8 the last five
    assert _requests(ps.steps(_run(10, 5, 2))) == [4, 5, 6, 7, 8]
    # set-up records (request 0) are never a step
    rec = _run(10, 5, 2)
    rec["program_spans"].insert(0, _rec(0, "graph.capture", rid=1))
    assert _requests(ps.steps(rec)) == [4, 5, 6, 7, 8]
    # a window longer than what came before: what there is
    assert _requests(ps.steps(_run(6, 5, 2))) == [1, 2, 3, 4]


def test_a_step_with_a_capture_is_left_out():
    rec = _run(10, 4, 2)
    rec["program_spans"].append(_rec(6, "graph.capture", rid=99, parent=60))
    assert _requests(ps.steps(rec)) == [5, 7, 8]
    # fewer than half of the window's steps left: nothing
    for q in (5, 7):
        rec["program_spans"].append(_rec(q, "graph.capture", rid=q + 90,
                                         parent=q * 10))
    assert ps.steps(rec) is None


def test_records_lost_in_the_range_give_nothing():
    rec = _run(10, 4, 2)
    for r in rec["program_spans"][6:]:   # lost from request 7's record on
        r["dropped"] = 1
    assert ps.steps(rec) is None
    rec = _run(10, 4, 2)
    for r in rec["program_spans"][3:]:   # before the range (requests 5-8)
        r["dropped"] = 1
    assert _requests(ps.steps(rec)) == [5, 6, 7, 8]


def test_no_spans_give_nothing():
    assert ps.steps(_run(0, 4, 2)) is None
    assert ps.steps(_run(2, 4, 2)) is None   # only the traced stretch


def test_of_kind_picks_the_frames_of_one_name():
    rec = _run(6, 4, 1)
    rec["program_spans"][2]["name"] = "fit.appearance"
    assert _requests(ps.of_kind(rec, "fit.frame")) == [2, 4, 5]
    assert _requests(ps.of_kind(rec, "fit.appearance")) == [3]
    assert ps.of_kind(rec, "sim.frame") is None


def test_leaves_gaps_and_device_time():
    step = [_rec(1, "fit.frame", 1, None, (0.0, 10.0)),
            _rec(1, "fit.forward", 2, 1, (0.0, 6.0)),
            _rec(1, "fit.substep", 3, 2, (0.0, 2.0)),
            _rec(1, "fit.substep", 4, 2, (3.0, 6.0)),
            _rec(1, "fit.loss", 5, 1, (5.5, 7.0)),    # overlaps the last
            _rec(1, "fit.update", 6, 1, (9.0, 10.0))]
    names = [r["name"] for r in ps.leaves(step)]
    assert names == ["fit.substep", "fit.substep", "fit.loss", "fit.update"]
    assert [r["id"] for r in ps.leaves(step, "fit.forward")] == [3, 4]
    # the gaps of the leaves' union: 2-3 and 7-9
    assert ps.gap_s(ps.leaves(step)) == pytest.approx(3.0)
    assert ps.gap_share([step]) == pytest.approx(0.3)
    assert ps.gap_ms([step], "fit.forward") == pytest.approx(1e3)
    assert ps.device_s(step, "fit.substep") == pytest.approx(5.0)
    assert ps.device_s(step, "fit.adjoint") is None
    step[2]["dev_end"] = None   # a leaf without device times
    assert ps.leaves(step) is None
    assert ps.gap_share([step]) is None
    assert ps.device_s(step, "fit.substep") is None


def test_the_programs_own_records_by_default():
    from gsmpm_tpu_torch.utils import spans

    spans.clear()
    try:
        for _ in range(5):
            with spans.span("sim.frame", request=True):
                with spans.span("sim.substep"):
                    pass
        rec = dict(window_steps=[{}] * 3, steps=[{}] * 1)
        got = ps.records(rec)
        assert got == spans.records()
        assert ps.records(rec) is got   # read once a record
        # on the CPU the spans have host times only: listed, not timed
        assert _requests(ps.steps(rec)) == [2, 3, 4]
        assert ps.leaves(ps.steps(rec)[0]) is None
    finally:
        spans.clear()
