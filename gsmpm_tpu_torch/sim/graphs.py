"""CUDA-graph machinery shared by the engines' one-program paths.

gsmpm_tpu compiles a frame's substep scan, and a fitting window's
``value_and_grad``, into one XLA program.  The port's counterpart is a
body that works in place on static buffers, captured once in a
``torch.cuda.CUDAGraph`` and replayed every substep (``_Captured``).  The
tiled engine (sim/tiles.py) and the golden engine (sim/solver.py) keep
their captured bodies in least-recently-used caches keyed by what the
graphs bake in: tensors and process groups by identity (``_identity``),
or, where a body owns copies of them (``_owned``), by value
(``_values``).  Each cache registers itself here (``_register``), so that
``_drop_group_graphs`` frees every graph captured on a process group
before the group is destroyed.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed


class _Captured:
    """A body that works in place on static buffers, run as a CUDA graph.

    On CUDA the first call runs the body eagerly on the current stream (its
    warm-up: the kernels' build, cached grid coordinates, the allocator,
    autograd's device thread) and then captures it once on a side stream;
    every later call replays the graph and adds the K1 / K2 / K6 launches
    it holds to their wrappers' counters.  On the CPU every call runs the
    body.  The graph bakes in every address the body reads.  ``counters``
    (a function with ``captures`` and ``replays``) counts the work.  The
    body is passed at each call, so the owner of the buffers holds this
    object without a reference cycle.
    """

    def __init__(self, device: torch.device, counters):
        self.device, self.counters = device, counters
        self.graph = None
        self.launches = {}  # wrapper -> launches one replay holds

    def __call__(self, body) -> None:
        from gsmpm_tpu_torch.sim import cuda_mpm

        if self.graph is not None:
            self.graph.replay()
            self.counters.replays += 1
            for wrapper, n in self.launches.items():
                wrapper.launches += n
            return
        if self.device.type != "cuda":
            body()
            return
        wrappers = (cuda_mpm.p2g_tiled, cuda_mpm.g2p_tiled,
                    cuda_mpm.sored_tiled)
        # the warm-up stays on the current stream: run on the capture
        # stream, it left every later replay loop of simulate's bench frame
        # ~0.46 ms a substep slower on an H100 (0.289 against 0.245 s a
        # frame), the cause not found
        body()
        # torch.cuda.graph() would also empty the allocator's cache, and
        # the next frame's render would allocate its buffers anew
        torch.cuda.synchronize(self.device)
        before = [w.captured for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            # thread_local: the rest of the process (a NCCL watchdog) may
            # go on querying the device while this thread captures
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        current.wait_stream(stream)
        self.launches = {w: w.captured - b for w, b in zip(wrappers, before)}
        self.graph = graph
        self.counters.captures += 1

    def release(self) -> None:
        """Free the graph now, whoever else still holds this object."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _identity(obj, refs: list):
    """What a captured substep closes over in obj: each tensor and process
    group by its identity (kept alive in refs, so no other object takes
    its id), the rest by value."""
    if isinstance(obj, (torch.Tensor, torch.distributed.ProcessGroup)):
        refs.append(obj)
        return id(obj)
    if dataclasses.is_dataclass(obj):
        return (type(obj),) + tuple(_identity(getattr(obj, f.name), refs)
                                    for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_identity(o, refs) for o in obj)
    return obj


def _owned(obj):
    """obj with each tensor in it cloned (dataclasses and tuples rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _owned(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_owned(o) for o in obj)
    return obj


def _values(obj):
    """obj by value: each tensor's dtype, shape and elements (a host read
    of a few floats here: gravity, BC boxes), the rest as it is."""
    if isinstance(obj, torch.Tensor):
        return (obj.dtype, tuple(obj.shape), tuple(obj.flatten().tolist()))
    if dataclasses.is_dataclass(obj):
        return (type(obj),) + tuple(_values(getattr(obj, f.name))
                                    for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_values(o) for o in obj)
    return obj


# every cache of captured bodies (each entry has .group and .release())
_CACHES: list = []


def _register(kept: int) -> "collections.OrderedDict":
    """A new cache of captured bodies, least recently used first, that
    holds at most ``kept`` entries and that ``_drop_group_graphs`` sees."""
    cache = collections.OrderedDict()
    cache.kept = kept
    _CACHES.append(cache)
    return cache


def _cached(cache, key, build):
    """cache[key], built by ``build()`` when missing (the least recently
    used entry evicted first when the cache is full), now the most
    recently used."""
    entry = cache.pop(key, None)
    if entry is None:
        while len(cache) >= cache.kept:
            cache.popitem(last=False)
        entry = build()
    cache[key] = entry
    return entry


def _drop_group_graphs(group=None) -> int:
    """Drop every cached graph of every engine (sim/tiles.py's ``_GRAPHS``
    and ``_FIT_GRAPHS``, sim/solver.py's golden caches) captured on
    ``group``, or with None on any process group, and free its CUDA graphs;
    returns how many entries.  Call it before ``destroy_process_group``: a
    graph must never replay, nor be freed, after the communicator it
    captured is gone."""
    dropped = 0
    for cache in _CACHES:
        for key in [k for k, g in cache.items() if g.group is not None
                    and (group is None or g.group is group)]:
            cache.pop(key).release()
            dropped += 1
    return dropped
