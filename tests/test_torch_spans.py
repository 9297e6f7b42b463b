"""The span recorder (gsmpm_tpu_torch/utils/spans.py) and the span trees
of the simulate and fit frames.

The recorder's own behaviour runs on the CPU (host times only): nesting,
parents and request ids, a span on a second thread, the glue pieces, the
ring bound and ``spans.dropped``, and the off path.  The tiny CPU frames
check which spans a frame opens and which request they take.  Tests
marked ``cuda`` need a card and skip without one; this file imports no
JAX, so on the machine with the GPU they run with

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""

import collections
import math
import threading

import numpy as np
import pytest
import torch

from gsmpm_tpu_torch.config import MPMConfig
from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
from gsmpm_tpu_torch.render.camera import make_camera
from gsmpm_tpu_torch.render.renderer import RasterConfig, render_with_aux
from gsmpm_tpu_torch.sim import MPMSolver
from gsmpm_tpu_torch.sim import fitting as tf
from gsmpm_tpu_torch.utils import spans
from gsmpm_tpu_torch.utils.spans import span


@pytest.fixture(autouse=True)
def _fresh():
    """Each test reads only its own records, with the recorder on."""
    spans.enable(True)
    spans.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    spans.enable(True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events have no CPU mode")
    return torch.device("cuda")


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r["name"]].append(r)
    return out


def _children(recs, parent):
    return collections.Counter(r["name"] for r in recs
                               if r["parent"] == parent["id"])


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_nesting_parents_and_request_ids():
    with span("setup"):
        pass
    with span("sim.frame", request=True):
        with span("sim.substep"):
            pass
        with span("sim.unpack"):
            with span("inner"):
                pass
    with span("render"):
        pass
    with span("fit.appearance", request=True):
        with span("fit.frame", request=True):   # nested: no new request
            pass
    with span("fit.frame"):   # not marked: no new request
        pass
    recs = spans.records()
    got = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == [
        "setup", "sim.substep", "inner", "sim.unpack", "sim.frame", "render",
        "fit.frame", "fit.appearance", "fit.frame"]
    assert got["setup"]["request"] == 0 and got["setup"]["parent"] is None
    assert got["sim.substep"]["parent"] == got["sim.frame"]["id"]
    assert got["inner"]["parent"] == got["sim.unpack"]["id"]
    # the render after the frame takes the frame's request
    assert {got[n]["request"] for n in ("sim.frame", "sim.substep", "inner",
                                        "render")} == {1}
    assert got["render"]["parent"] is None
    assert got["fit.appearance"]["request"] == 2
    assert [r["request"] for r in recs if r["name"] == "fit.frame"] == [2, 2]
    for r in recs:
        assert r["host_start"] <= r["host_end"]
        assert r["dev_start"] is None and r["dev_end"] is None  # the CPU
        assert r["thread"] == threading.get_ident()
        assert r["dropped"] == 0
    outer, inner = got["sim.frame"], got["sim.substep"]
    assert outer["host_start"] <= inner["host_start"] <= inner["host_end"] \
        <= outer["host_end"]


def test_span_on_a_second_thread_takes_the_open_span_as_parent():
    seen = {}

    def work(key):
        with span(key) as sp:
            seen[key] = sp.seconds   # still open: NaN

    with span("fit.frame", request=True):
        with span("fit.backward"):
            t = threading.Thread(target=work, args=("fit.adjoint",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    # no span open anywhere: no parent, the last request
    t = threading.Thread(target=work, args=("alone",))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    got = {r["name"]: r for r in spans.records()}
    assert got["fit.adjoint"]["parent"] == got["fit.backward"]["id"]
    assert got["fit.adjoint"]["thread"] != got["fit.backward"]["thread"]
    assert got["fit.adjoint"]["request"] == got["fit.frame"]["request"] == 1
    assert got["alone"]["parent"] is None and got["alone"]["request"] == 1
    assert math.isnan(seen["fit.adjoint"])


def test_glue_pieces_cover_the_stretches_no_child_covers():
    with span("fit.backward", glue=True) as bw:
        with span("render.backward"):
            pass
        with span("fit.adjoint"):
            pass
    recs = spans.records()
    parent = next(r for r in recs if r["name"] == "fit.backward")
    assert _children(recs, parent) == {"fit.backward.glue": 3,
                                       "render.backward": 1, "fit.adjoint": 1}
    kids = sorted((r for r in recs if r["parent"] == parent["id"]),
                  key=lambda r: r["host_start"])
    assert [r["name"] for r in kids] == [
        "fit.backward.glue", "render.backward", "fit.backward.glue",
        "fit.adjoint", "fit.backward.glue"]
    # the pieces and the children tile the parent on the host's clock
    assert kids[0]["host_start"] == parent["host_start"]
    assert kids[-1]["host_end"] == parent["host_end"]
    for a, b in zip(kids, kids[1:]):
        assert a["host_end"] == b["host_start"]
    assert bw.seconds == pytest.approx(parent["host_end"]
                                       - parent["host_start"])


def test_ring_bound_and_dropped():
    rec = spans.Recorder(max_records=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    got = rec.records()
    assert [r["name"] for r in got] == [f"s{i}" for i in range(12, 20)]
    assert rec.dropped == 12
    assert [r["dropped"] for r in got] == list(range(5, 13))
    assert spans.dropped == 0   # the process's recorder lost nothing
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def test_off_records_nothing():
    spans.enable(False)
    a, b = span("sim.frame"), span("fit.frame", glue=True)
    assert a is b   # the shared no-op
    with a as sp:
        pass
    assert math.isnan(sp.seconds)
    with span("app.frame", clock=True) as clock:
        sum(range(1000))
    assert clock.seconds > 0
    assert spans.records() == [] and spans.RECORDER.request == 0
    spans.enable(True)
    with span("sim.frame"):
        pass
    assert [r["name"] for r in spans.records()] == ["sim.frame"]


# ---------------------------------------------------------------------------
# the device path on a simulated stream (the CPU)
# ---------------------------------------------------------------------------


class _Device:
    """One simulated CUDA stream on a simulated clock (ns): work runs in
    order, an event runs when the stream reaches it, ``latency`` ns after
    the host records it at the soonest."""

    def __init__(self):
        self.now = 0          # the host's clock
        self.free = 0         # when the stream's queued work ends
        self.latency = 2_000

    def launch(self, ns):
        start = max(self.free, self.now + self.latency)
        self.free = start + ns
        return start, self.free

    def drain(self):          # a host read: wait for the stream, then 10 us
        self.now = max(self.now, self.free) + 10_000


@pytest.fixture
def device(monkeypatch):
    dev = _Device()

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            self.t = max(dev.free, dev.now + dev.latency)
            dev.free = self.t

        def query(self):
            return self.t is not None and dev.now >= self.t

        def elapsed_time(self, other):
            assert self.query() and other.query()
            return (other.t - self.t) * 1e-6

    class Clock:
        @staticmethod
        def perf_counter_ns():
            return dev.now

    def synchronize():
        dev.now = max(dev.now, dev.free)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(spans, "time", Clock)
    return dev


def _substeps(rec, dev, n):
    """A frame's substep loop: a drain, then a span around a 2 ms launch;
    the true device intervals of the launches."""
    truth = []
    with rec.span("sim.frame", request=True):
        for _ in range(n):
            dev.drain()
            with rec.span("sim.substep"):
                dev.now += 3_000
                truth.append(dev.launch(2_000_000))
                dev.now += 1_000
    return truth


def test_device_times_on_the_host_clock(device, monkeypatch):
    """Each event is timed from its request's origin and each origin from
    the one before, so every device time is the true one less the first
    origin's; a long request takes new origins; the pool's events come
    back, and nothing is lost."""
    monkeypatch.setattr(spans, "_ORIGIN_NS", 30_000_000)
    rec = spans.Recorder(max_events=16)
    first = device.now + device.latency   # when the first event runs
    with rec.span("setup"):   # before any request: the first origin
        device.now += 5_000
    truth = []
    for _ in range(3):
        truth += _substeps(rec, device, 40)   # ~85 ms a frame
        device.now += 50_000_000   # the host elsewhere
    got = [r for r in rec.records() if r["name"] == "sim.substep"]
    assert rec.dropped == 0 and len(got) == len(truth) == 120
    for r, (start, end) in zip(got, truth):
        # the start event ran 3 us (the host's launch) before the work, the
        # end one as the work ended
        assert r["dev_start"] == pytest.approx((start - 3_000 - first) * 1e-9,
                                               abs=1e-12)
        assert r["dev_end"] == pytest.approx((end - first) * 1e-9, abs=1e-12)
    frames = [r for r in rec.records() if r["name"] == "sim.frame"]
    assert [r["request"] for r in frames] == [1, 2, 3]
    # the origin in use is the last request's, never the first event's
    assert rec._origin.t >= frames[-1]["dev_start"] > 0
    # 240 events through a pool of 16: each back in it but the origin's
    assert rec._made <= 16
    assert len(rec._pool) == rec._made - 1


def test_a_full_pool_drops_device_times_not_records(device):
    """The host far ahead of the stream: the pool runs out, the records
    past it keep their host times and ``dropped`` counts them."""
    rec = spans.Recorder(max_events=8)
    with rec.span("fit.frame", request=True):
        for _ in range(10):
            with rec.span("fit.substep"):
                device.launch(5_000_000)   # no drain: nothing finishes
    got = rec.records()
    timed = [r for r in got if r["dev_start"] is not None]
    # the frame's and three substeps' start events, then three substeps'
    # end events: 7 of 8; the fourth substep and the frame lose their end
    assert len(got) == 11 and len(timed) == 3
    assert rec.dropped == 8 and got[-1]["dropped"] == 8
    assert all(r["dev_end"] is None for r in got if r["dev_start"] is None)


# ---------------------------------------------------------------------------
# the frames' spans (tiny CPU frames)
# ---------------------------------------------------------------------------


def _solver(n=256, n_grid=16, substeps=3):
    rng = np.random.default_rng(5)
    x = rng.uniform(0.7, 1.3, (n, 3)).astype(np.float32)
    cov6 = np.tile(np.float32([1e-4, 0, 0, 1e-4, 0, 1e-4]), (n, 1))
    s = MPMSolver(x, cov6, np.full(n, 1e-4, np.float32),
                  MPMConfig(n_grid=n_grid, E=2e4, substep_dt=1e-3,
                            frame_dt=substeps * 1e-3),
                  device="cpu")
    s.set_bc_ground_only()
    s.use_tiled = True   # the tiled engine on its CPU twins
    return s


@pytest.mark.parametrize("stream", [True, False])
def test_simulate_frame_spans(stream):
    """MPMSolver.step_frame, postprocess and render_with_aux, twice: one
    request a frame, the frame's substeps under ``sim.frame``."""
    s = _solver()
    cam = make_camera(32, 32, 0.8, 0.8, np.eye(3),
                      np.array([1.0, 1.0, -2.0]))
    n = s.state.n_particles
    for _ in range(2):
        s.step_frame()
        cov6, _ = s.postprocess()
        render_with_aux(s.state.x, cov6, torch.full((n,), 0.5),
                        torch.full((n, 1, 3), 0.4), cam, torch.ones(3), 0,
                        RasterConfig(block=16, stream=stream))
    recs = spans.records()
    assert sorted({r["request"] for r in recs}) == [1, 2]
    for q in (1, 2):
        mine = [r for r in recs if r["request"] == q]
        roots = collections.Counter(r["name"] for r in mine
                                    if r["parent"] is None)
        assert roots == {"sim.frame": 1, "sim.postprocess": 1, "render": 1}
        frame = next(r for r in mine if r["name"] == "sim.frame")
        kids = _children(mine, frame)
        assert kids["sim.substep"] == 3 and kids["sim.unpack"] == 2
        # the first frame bootstraps the tiled state
        assert set(kids) - {"sim.substep", "sim.unpack", "sim.rebucket"} \
            == ({"sim.load"} if q == 1 else set())


def _identifier(n=160, res=48, substeps=3):
    tid = tf.SystemIdentifier(
        synthetic_blob_scene(n=n, seed=3, radius=0.4, center=(0.0, 0.8, 0.0)),
        MPMConfig(material="jelly", E=1e4, nu=0.4, n_grid=16,
                  grid_extent=2.0, gravity=[0.0, -9.81, 0.0], fitting=True),
        init_velocity=torch.tensor([[0.0, -2.0, 0.0]]).repeat(n, 1),
        fit_cfg=tf.FitConfig(substeps_per_frame=substeps),
        raster_cfg=RasterConfig(block=16, chunk=16), bg=torch.ones(3))
    tid._sim_engine = "tiled_vjp"   # the CUDA default, on its CPU twins
    cam = make_camera(res, res, 0.7, 0.7, np.eye(3),
                      np.array([0.0, 0.8, -3.0]))
    return tid, cam


def test_fit_frame_and_appearance_spans():
    """appearance_step, then two fit frames: one request each, the
    window's substeps under ``fit.forward`` and autograd's work under
    ``fit.backward`` (glue pieces and the render's backward)."""
    tid, cam = _identifier()
    gt = torch.rand((48, 48, 3), generator=torch.Generator().manual_seed(1))
    opt, params = tid.make_appearance_optimizer()
    tid.appearance_step(opt, params, camera=cam, gt_image=gt)
    state, t = tid.reset_state(), 0.0
    for _ in range(2):
        _, state, t, _ = tid.fit_frame(state, t, cam, gt)
    recs = spans.records()
    assert sorted({r["request"] for r in recs if r["request"]}) == [1, 2, 3]
    app = [r for r in recs if r["request"] == 1]
    top = next(r for r in app if r["name"] == "fit.appearance")
    assert top["parent"] is None
    kids = _children(app, top)
    assert set(kids) == {"fit.geometry", "render", "fit.loss",
                         "fit.backward", "fit.update"}
    assert kids["fit.backward"] == kids["fit.update"] == 1
    bw = next(r for r in app if r["name"] == "fit.backward")
    assert set(_children(app, bw)) == {"fit.backward.glue", "render.backward"}
    for q in (2, 3):
        mine = [r for r in recs if r["request"] == q]
        names = _by_name(mine)
        (frame,) = names["fit.frame"]
        assert frame["parent"] is None
        assert [r for r in mine if r["parent"] is None] == [frame]
        kids = _children(mine, frame)
        assert set(kids) == {"fit.params", "fit.load", "fit.forward",
                             "fit.unpack", "fit.geometry", "render",
                             "fit.loss", "fit.backward", "fit.update"}
        tries = kids["fit.forward"]   # a drop-free re-run repeats the frame
        assert kids["fit.unpack"] == 2 * tries
        assert kids["fit.backward"] == kids["fit.update"] == 1
        fwd = names["fit.forward"]
        assert sum(_children(mine, f)["fit.substep"] for f in fwd) \
            == 3 * tries
        (bw,) = names["fit.backward"]
        assert set(_children(mine, bw)) == {"fit.backward.glue",
                                            "render.backward"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_no_event_recorded_during_capture(cuda):
    x = torch.zeros(1024, device=cuda)
    x.add_(1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with span("outside"):
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                queued = len(spans.RECORDER._slots)
                made = spans.RECORDER._made
                with span("inside"):
                    x.add_(1)
                # no event recorded, made or queried (resolving queries)
                after = len(spans.RECORDER._slots), spans.RECORDER._made
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    assert after == (queued, made)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert float(x[0]) == 3.0   # the warm-up add, then two replays
    got = {r["name"]: r for r in spans.records()}
    assert got["inside"]["dev_start"] is None
    assert got["inside"]["dev_end"] is None
    assert got["outside"]["dev_start"] is not None
    assert spans.dropped == 0


class _Twice(torch.autograd.Function):
    """y = 2x, its backward inside a span on autograd's device thread."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        with span("render.backward"):
            torch.cuda._sleep(200_000)
            return 2.0 * g


@pytest.mark.cuda
def test_device_intervals_of_one_stream_are_ordered(cuda):
    """Leaf spans of one stream, with and without host reads between them
    and with autograd's device thread, have ordered, non-overlapping
    device intervals; a parent's encloses its children's."""
    a = torch.randn(1024, 1024, device=cuda, requires_grad=True)
    # first calls (cuBLAS's handle, autograd's device thread) stall the host
    # with the device idle inside a span: warm them up outside the frames
    torch.autograd.grad(_Twice.apply(a @ a).square().mean(), (a,))
    torch.cuda.synchronize()
    spans.clear()
    for i in range(3):
        with span("fit.frame", request=True):
            with span("fit.forward"):
                for k in range(4):
                    with span("fit.substep"):
                        torch.cuda._sleep(100_000 * (k + 1))
                        y = a @ a
                    if k % 2:
                        float(y[0, 0].detach())   # a read between leaves
            with span("fit.loss"):
                loss = _Twice.apply(y).square().mean()
            with span("fit.backward", glue=True):
                (g,) = torch.autograd.grad(loss, (a,))
            with span("fit.update"):
                a.data.add_(g, alpha=-1e-3)
    recs = spans.records()
    assert spans.dropped == 0
    assert all(r["dev_start"] is not None for r in recs)
    parents = {r["parent"] for r in recs}
    by_id = {r["id"]: r for r in recs}
    leaves = sorted((r for r in recs if r["id"] not in parents),
                    key=lambda r: r["dev_start"])
    names = collections.Counter(r["name"] for r in leaves)
    assert names["render.backward"] == 3 and names["fit.backward.glue"] >= 6
    assert {r["thread"] for r in leaves if r["name"] == "render.backward"} \
        != {threading.get_ident()}
    tol = 1e-6   # s: elapsed_time's float32 milliseconds
    for a_, b_ in zip(leaves, leaves[1:]):
        assert a_["dev_start"] <= a_["dev_end"] + tol
        assert a_["dev_end"] <= b_["dev_start"] + tol, (a_["name"],
                                                         b_["name"])
    for r in recs:
        p = by_id.get(r["parent"])
        if p is not None:
            assert p["dev_start"] <= r["dev_start"] + tol
            assert r["dev_end"] <= p["dev_end"] + tol
    # a substep that sleeps longer lasts longer on the device
    sub = [r["dev_end"] - r["dev_start"] for r in recs
           if r["name"] == "fit.substep"]
    assert all(sub[i + 3] > sub[i] for i in range(0, len(sub), 4)), sub
