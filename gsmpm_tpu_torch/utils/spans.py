"""Spans: named intervals of the program's own work, timed on the host and,
on CUDA, on the device by CUDA events at the program's own pace.

``span(name)`` is a context manager.  Each span records its name, its
host start and end (``time.perf_counter_ns``), its parent span and a
request id; the records stay in memory (a ring of ``MAX_RECORDS``) until
``records()`` returns them:

- **Request.** ``span(name, request=True)`` marks a caller's unit of
  work (a simulated frame, a fit frame): the outermost such span starts
  a new request id, and every span opened after it takes that id, so the
  postprocess and render a caller runs after ``MPMSolver.step_frame``
  belong to that frame.
- **Threads.** The stack of open spans is per thread (autograd runs
  backward Functions on its device thread).  A span opened on a thread
  with no open span takes as parent the latest opened span still open on
  another thread: a backward Function's span is a child of the span
  around ``torch.autograd.grad``.  The request id is process-wide.
- **Device.** Where CUDA is initialised, each span records a CUDA event
  (timing on, from a reused pool) on the current stream at its start and
  at its end.  The recorder never waits on the hot path: it resolves
  finished events with ``Event.query()`` when spans close; ``records()``
  resolves the rest after one synchronize.  Device times are differences
  of events on the device's own clock: an event is timed by
  ``elapsed_time`` from an origin, the first event of its request, and
  each origin from the origin before it, so every device time is in
  seconds from the first origin since ``clear()``.  A request that lasts
  over ``_ORIGIN_NS`` on the host takes a new origin, which keeps each
  ``elapsed_time`` short and its float32 milliseconds fine.  Host and
  device times are on different clocks.
- **Glue.** ``span(name, glue=True)`` marks a span whose own code
  launches device work between its children (``fit.backward``: autograd's
  glue between the backward Functions' spans).  Each stretch of it that
  no child covers is recorded as a child ``<name>.glue``, so that leaf
  spans cover its work; the stretches share the children's events.
- Inside CUDA graph capture, and on the CPU, a span records host times
  only (device times ``None``).
- The spans open no profiler range and no NVTX range.

``dropped`` counts records lost because the ring or the event pool was
full (a record that lost its events keeps its host times).
``enable(False)`` turns the recorder off: ``span`` then returns a shared
no-op whose ``seconds`` is NaN, or with ``clock=True`` a host clock that
records nothing.
"""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 65536
MAX_EVENTS = 4096
# host ns a request's origin serves before a span takes a new one
_ORIGIN_NS = 1_000_000_000
KEYS = ("id", "name", "parent", "request", "thread", "host_start",
        "host_end", "dev_start", "dev_end", "dropped")

_ON = True


class _Slot:
    """One recorded CUDA event.  ``base``: the origin it is timed from (an
    origin's: the origin before it; None for the first); ``origin``: it is
    one; ``t``: its device time (s) once resolved.  Its event goes back to
    the pool once it is timed; an origin's once the next origin is timed
    (events are timed in record order, so nothing is timed from it then)."""

    __slots__ = ("ev", "base", "origin", "t")

    def __init__(self, ev, base, origin):
        self.ev, self.base, self.origin, self.t = ev, base, origin, None


class _Span:
    __slots__ = ("rec", "name", "glue", "request", "req", "id", "parent",
                 "t0", "t1", "s0", "s1", "cursor", "cursor_t")

    def __init__(self, rec: "Recorder", name: str, glue: bool,
                 request: bool):
        self.rec, self.name, self.glue, self.request = (
            rec, name, glue, request)
        self.t1 = None

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec._close(self)
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from the span's start to its end."""
        if self.t1 is None:
            return math.nan
        return (self.t1 - self.t0) * 1e-9


class _NoSpan:
    """The shared span of a recorder that is off."""

    seconds = math.nan

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Clock:
    """A span of a recorder that is off, for a caller that reads its host
    ``seconds``: times the host, records nothing."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t1, self.t0 = None, time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        return False

    seconds = _Span.seconds


class Recorder:
    """The process's spans (one instance, ``RECORDER``, serves ``span``)."""

    def __init__(self, max_records: int = MAX_RECORDS,
                 max_events: int = MAX_EVENTS):
        self.max_records, self.max_events = max_records, max_events
        self._lock = threading.Lock()
        self._local = threading.local()
        self._stacks: Dict[int, list] = {}
        self.clear()

    def clear(self) -> None:
        """Forget every record (open spans stay open)."""
        with self._lock:
            self._ring = collections.deque()
            self._pending = collections.deque()  # records awaiting events
            self._slots = collections.deque()    # events in record order
            self._pool: List = []
            self._made = 0
            self._origin: Optional[_Slot] = None
            self._origin_ns = 0
            self._streams: Dict[int, object] = {}
            self._ids = itertools.count(1)
            self.request = 0
            self._requests_open = 0
            self.dropped = 0

    # ------------------------------------------------------------ the spans
    def span(self, name: str, glue: bool = False, clock: bool = False,
             request: bool = False):
        """A span of ``name`` around a ``with`` block (see the module's
        doc); ``request``: it starts a request; ``clock``: the caller reads
        its ``seconds``, also with the recorder off."""
        if not _ON:
            return _Clock() if clock else _NOOP
        return _Span(self, name, glue, request)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            with self._lock:
                self._stacks[threading.get_ident()] = stack
            return stack

    def _foreign_parent(self, own: list) -> Optional[_Span]:
        """The latest opened span still open on another thread."""
        best = None
        for stack in self._stacks.values():
            if stack is not own and stack and (best is None
                                               or stack[-1].t0 > best.t0):
                best = stack[-1]
        return best

    @staticmethod
    def _device() -> bool:
        return (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())

    def _record(self, origin: bool) -> Optional[_Slot]:
        """A CUDA event recorded now on the current stream, timed from the
        origin, or the new origin if ``origin`` (or if there is none);
        None (the record then loses its device times) when the pool is
        spent."""
        if self._pool:
            ev = self._pool.pop()
        elif self._made < self.max_events:
            ev = torch.cuda.Event(enable_timing=True)
            self._made += 1
        else:
            return None
        # the current stream, its Python object made once a stream
        # (``torch.cuda.current_stream()`` costs microseconds a call)
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        stream = self._streams.get(raw)
        if stream is None:
            stream = self._streams[raw] = torch.cuda.current_stream()
        ev.record(stream)
        base = self._origin
        slot = _Slot(ev, base, origin or base is None)
        self._slots.append(slot)
        if slot.origin:
            self._origin = slot
        return slot

    def _open(self, sp: _Span) -> None:
        # the calls of _stack and _device inlined: this runs on the path
        # from a host read to the next launch, where the device waits
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._stack()
        live = (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())
        with self._lock:
            parent = stack[-1] if stack else self._foreign_parent(stack)
            sp.id = next(self._ids)
            sp.parent = parent
            starts = sp.request and self._requests_open == 0
            if sp.request:
                self.request += starts
                self._requests_open += 1
            sp.req = self.request
            sp.cursor = sp.cursor_t = sp.s0 = sp.s1 = None
            sp.t0 = t0 = time.perf_counter_ns()
            if live:
                sp.s0 = self._record(starts
                                     or t0 - self._origin_ns > _ORIGIN_NS)
                if sp.s0 is None:   # the pool is spent: host times only
                    self.dropped += 1
                elif sp.s0 is self._origin:
                    self._origin_ns = t0
            if parent is not None and parent.glue:
                self._glue_piece(parent, sp.s0, t0)
            if sp.glue:
                sp.cursor, sp.cursor_t = sp.s0, t0
            stack.append(sp)

    def _close(self, sp: _Span) -> None:
        stack = self._stack()
        live = self._device()   # no CUDA call at all while capturing
        with self._lock:
            stack.pop()
            if live and sp.s0 is not None:
                sp.s1 = self._record(False)
            sp.t1 = time.perf_counter_ns()
            if sp.request:
                self._requests_open -= 1
            if sp.glue:
                self._glue_piece(sp, sp.s1, sp.t1)
            parent = sp.parent
            if parent is not None and parent.glue:
                parent.cursor, parent.cursor_t = sp.s1, sp.t1
            self._add(sp.id, sp.name, parent, sp.req, sp.t0, sp.t1,
                      sp.s0, sp.s1)
            if live and self._slots:
                self._resolve()

    def _glue_piece(self, owner: _Span, end: Optional[_Slot],
                    t_end: int) -> None:
        """Record the stretch of glue span ``owner`` from its cursor to
        ``end``."""
        start, t_start = owner.cursor, owner.cursor_t
        owner.cursor = owner.cursor_t = None
        if t_start is None:
            return
        self._add(next(self._ids), owner.name + ".glue", owner,
                  owner.req, t_start, t_end, start, end)

    def _add(self, rid, name, parent, request, t0, t1, s0, s1) -> None:
        if (s0 is None) != (s1 is None):  # an event missing: host times only
            s0 = s1 = None
            self.dropped += 1
        if len(self._ring) >= self.max_records:
            self._ring.popleft()
            self.dropped += 1
        rec = [rid, name, None if parent is None else parent.id, request,
               threading.get_ident(), t0 * 1e-9, t1 * 1e-9, s0, s1,
               self.dropped]
        self._ring.append(rec)
        if s0 is not None:
            self._pending.append(rec)

    # ------------------------------------------------------------ resolving
    def _resolve(self) -> None:
        """Time every finished event in record order (an event's base was
        recorded before it, so it is timed first), then turn each record
        whose two events are timed into plain floats."""
        slots = self._slots
        while slots:
            s = slots[0]
            if not s.ev.query():
                break
            b = s.base
            s.t = 0.0 if b is None else b.t + b.ev.elapsed_time(s.ev) * 1e-3
            s.base = None
            slots.popleft()
            if not s.origin:
                self._pool.append(s.ev)
            elif b is not None:
                self._pool.append(b.ev)
        pend = self._pending
        while pend:
            rec = pend[0]
            s0, s1 = rec[7], rec[8]
            if s0.t is None or s1.t is None:
                break
            rec[7], rec[8] = s0.t, s1.t
            pend.popleft()

    def records(self) -> List[Dict]:
        """Every record in the ring, oldest first, as plain dicts (``KEYS``;
        host times in seconds on the host's clock, device times in seconds
        on the device's, from the first origin).  Synchronizes once: never
        on the hot path."""
        with self._lock:
            if self._slots:
                torch.cuda.synchronize()
                self._resolve()
            return [dict(zip(KEYS, rec)) for rec in self._ring
                    if not isinstance(rec[7], _Slot)]


RECORDER = Recorder()


span = RECORDER.span


def records() -> List[Dict]:
    return RECORDER.records()


def clear() -> None:
    RECORDER.clear()


def enable(on: bool = True) -> None:
    """Turn the recorder on or off (on by default)."""
    global _ON
    _ON = bool(on)


def __getattr__(name):
    # ``spans.dropped``: the recorder's counter of lost records
    if name == "dropped":
        return RECORDER.dropped
    raise AttributeError(name)
