"""Device mesh over processes and the particle-shard helpers.

Port of gsmpm_tpu/parallel/mesh.py.  The JAX mesh is single-controller
SPMD over the devices of one program; the port's is multi-process
``torch.distributed``: one process per GPU (``torchrun --nproc_per_node N``),
each holding a contiguous block of the particles.  ``make_mesh`` joins the
default process group (NCCL on CUDA, gloo on the CPU) and gives every mesh
axis its own process group (the ranks that differ only in that axis's
index, row-major as the JAX mesh lays its devices); ``shard`` slices this
rank's block of every per-particle tensor and ``gather`` is the all-gather
along the particle axis; they replace the JAX package's ``particle_pspec``
and ``_gather_particles``.

The fit steps (parallel/sharded.py) differentiate through collectives.
``all_reduce_sum`` and ``all_gather_grad`` are autograd Functions with the
adjoints that give the single-device gradient of a loss that every rank
computes alike: the adjoint of an all-reduce is the all-reduce of the
cotangents (each rank's cotangent carries only its own reads of the sum),
the adjoint of an all-gather is this rank's slice of the cotangent (every
rank holds the whole, equal cotangent).  Summing the gathered cotangents
instead, as ``torch.distributed.nn.functional.all_gather`` and the
transpose of JAX's ``all_gather`` do, multiplies the gradient by the
axis size.

Padding to a multiple of the mesh size uses physically inert fillers:
mass = vol = 0 contributes nothing to P2G and opacity = 0 nothing to the
blend, so a padded run is the physics of the unpadded one.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gsmpm_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: axis names and sizes (row-major
    over the ranks), rank, world size, device and process group (the
    world's), and per axis this rank's index and the group of the ranks
    that share every other index."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    world_size: int
    device: torch.device
    group: object
    coords: Tuple[int, ...]
    axis_groups: Tuple[object, ...]

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: Optional[str] = None) -> int:
        """Ranks along axis (None: the world)."""
        if axis is None:
            return self.world_size
        return self.sizes[self._axis(axis)]

    def axis_index(self, axis: Optional[str] = None) -> int:
        """This rank's index along axis (None: its rank)."""
        return self.rank if axis is None else self.coords[self._axis(axis)]

    def axis_group(self, axis: Optional[str] = None):
        """The process group along axis (None: the world's)."""
        return self.group if axis is None else \
            self.axis_groups[self._axis(axis)]

    def axis_stride(self, axis: Optional[str] = None) -> int:
        """Global-rank distance between neighbours along axis (None: 1)."""
        return 1 if axis is None else \
            math.prod(self.sizes[self._axis(axis) + 1:])


def _axis_groups(sizes: Tuple[int, ...], rank: int, world: int):
    """(this rank's index along each axis, its group along each axis).
    Every rank creates every group, in the same order, as
    ``dist.new_group`` requires; an axis that spans the world takes the
    world's group."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = tuple((rank // st) % n for st, n in zip(strides, sizes))
    groups = []
    for n, st in zip(sizes, strides):
        if n == world:
            groups.append(dist.group.WORLD)
            continue
        mine = None
        for base in range(world):
            if (base // st) % n:
                continue
            ranks = [base + k * st for k in range(n)]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups.append(mine)
    return coords, tuple(groups)


def make_mesh(axes: Tuple[Tuple[str, int], ...] = (("data", -1),),
              device: Optional[str] = None) -> Mesh:
    """Join (or build from the ``torchrun`` environment) the default process
    group and lay (name, size) axes over its ranks; one size may be -1
    (inferred).  The backend is NCCL for CUDA (the default device) and gloo
    for the CPU; a CUDA device never runs on gloo.  Each rank takes
    ``cuda:LOCAL_RANK``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch "
                               "build lacks")
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no process group: launch with torchrun --nproc_per_node N, "
                "or call torch.distributed.init_process_group first")
        dist.init_process_group(backend)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, a "
                           f"{dev.type} mesh needs {backend}")
    return _lay_out(axes, dev)


def reshape_mesh(mesh: Mesh, axes: Tuple[Tuple[str, int], ...]) -> Mesh:
    """The ranks of mesh laid out on other (name, size) axes, on the same
    device and world group (the halo_tiled2d engine's ("hx", "hy") mesh
    over a 1-D data mesh).  Every rank must call it, in the same order."""
    return _lay_out(axes, mesh.device)


def _lay_out(axes, dev: torch.device) -> Mesh:
    world = dist.get_world_size()
    names = tuple(a[0] for a in axes)
    sizes = [a[1] for a in axes]
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} processes, the group has {world}")
    rank = dist.get_rank()
    coords, groups = _axis_groups(tuple(sizes), rank, world)
    return Mesh(names, tuple(sizes), rank, world, dev, dist.group.WORLD,
                coords, groups)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

def _pad_axis0(arr: torch.Tensor, n_pad: int, fill=0.0) -> torch.Tensor:
    if n_pad == 0:
        return arr
    pad = torch.full((n_pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], dim=0)


def _n_pad(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple - n


def pad_model(model, multiple: int):
    """Pad only the MPMModel's per-particle fields with inert fillers."""
    k = _n_pad(model.material.shape[0], multiple)
    if k == 0:
        return model
    return dataclasses.replace(
        model,
        material=_pad_axis0(model.material, k, model.active_materials[0]),
        logE=_pad_axis0(model.logE, k, 4.0),
        y=_pad_axis0(model.y, k),
        mu=_pad_axis0(model.mu, k, 1.0),
        lam=_pad_axis0(model.lam, k, 1.0),
        viscosity=_pad_axis0(model.viscosity, k),
    )


def pad_state(state, multiple: int):
    """Pad only the MPMState with inert filler particles (see pad_particles)."""
    k = _n_pad(state.x.shape[0], multiple)
    if k == 0:
        return state
    f32 = dict(dtype=state.F.dtype, device=state.F.device)
    eye = torch.eye(3, **f32).expand(k, 3, 3)
    iso = torch.tensor([1e-8, 0, 0, 1e-8, 0, 1e-8], **f32).expand(k, 6)
    return dataclasses.replace(
        state,
        x=_pad_axis0(state.x, k, 1e-3),
        v=_pad_axis0(state.v, k),
        F=torch.cat([state.F, eye]),
        F_trial=torch.cat([state.F_trial, eye]),
        C=_pad_axis0(state.C, k),
        vol=_pad_axis0(state.vol, k),
        density=_pad_axis0(state.density, k),
        mass=_pad_axis0(state.mass, k),
        init_cov=torch.cat([state.init_cov, iso]),
        cov=torch.cat([state.cov, iso]),
        yield_stress=_pad_axis0(state.yield_stress, k, 1.0),
    )


def pad_particles(state, model, multiple: int, extras: Optional[dict] = None):
    """Pad MPMState / MPMModel (and per-particle extras, filled with 0)
    along axis 0 to a multiple of ``multiple``.

    Fillers are inert: mass = vol = 0, F = F_trial = I, position at the
    domain origin cell.  Returns (state, model, extras, n_orig).
    """
    n = state.x.shape[0]
    k = _n_pad(n, multiple)
    extras = {name: _pad_axis0(a, k) for name, a in (extras or {}).items()}
    return pad_state(state, multiple), pad_model(model, multiple), extras, n


# ---------------------------------------------------------------------------
# per-particle tree maps
# ---------------------------------------------------------------------------

def _map_particles(tree, n: int, fn):
    """Apply fn to every tensor of tree whose leading dimension is n;
    dataclasses field by field, tuples, lists and dicts item by item."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.ndim >= 1 and tree.shape[0] == n else tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_particles(getattr(tree, f.name), n, fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_particles(v, n, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_map_particles(t, n, fn) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _leading(tree) -> int:
    """Leading dimension of tree's first tensor of rank >= 1."""
    if isinstance(tree, torch.Tensor) and tree.ndim >= 1:
        return tree.shape[0]
    items = ([getattr(tree, f.name) for f in dataclasses.fields(tree)]
             if dataclasses.is_dataclass(tree)
             else list(tree.values()) if isinstance(tree, dict)
             else list(tree) if isinstance(tree, (tuple, list)) else [])
    for t in items:
        n = _leading(t)
        if n:
            return n
    return 0


def unpad(tree, n: int):
    """Cut the particle padding off every per-particle tensor of tree (its
    leading dimension is that of tree's first tensor)."""
    return _map_particles(tree, _leading(tree), lambda t: t[:n])


def shard(tree, mesh: Mesh, axis: Optional[str] = None):
    """This rank's contiguous block of every per-particle tensor: those
    whose leading dimension is that of tree's first tensor, a multiple of
    the size of ``axis`` (None: the world)."""
    n = _leading(tree)
    size, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if n % size:
        raise ValueError(f"{n} particles do not split over {size} ranks: "
                         "pad them first (pad_particles)")
    nl = n // size
    return _map_particles(tree, n, lambda t: t[i * nl:(i + 1) * nl])


def all_gather_cat(t: torch.Tensor, mesh: Mesh, dim: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's t along ``axis`` (None: the world) concatenated along
    dim, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t, group=mesh.axis_group(axis))
    return torch.cat(parts, dim=dim)


def gather(tree, mesh: Mesh, axis: Optional[str] = None):
    """The full arrays of every per-particle tensor of this rank's shard
    (as shard picks them): the all-gather along the particle axis."""
    return _map_particles(tree, _leading(tree),
                          lambda t: all_gather_cat(t, mesh, axis=axis))


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's obj on every rank: host decisions (a resized raster
    config) that must agree across the mesh."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device)
    return box[0]


def all_ranks(flag: bool, mesh: Mesh) -> bool:
    """True when flag is True on every rank (an all-reduce MIN)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(t[0])


def neighbor_ppermute(left_out: torch.Tensor, right_out: torch.Tensor,
                      mesh: Mesh, axis: Optional[str] = None):
    """The non-cyclic neighbour shifts of JAX's ``ppermute`` along axis
    (None: the world): rank d's left_out goes to d - 1 and its right_out to
    d + 1.  Returns (from_left, from_right): what the left neighbour sent
    rightwards and what the right neighbour sent leftwards, zeros where
    there is no neighbour (as ``ppermute`` fills a device no pair targets).

    One ``batch_isend_irecv`` on the axis's group, peers by global rank;
    every rank of the axis takes part (an edge rank with its one pair), a
    one-rank axis sends nothing.  ``neighbor_ppermute.bytes_sent`` counts
    the bytes this rank sends."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    left_out, right_out = left_out.contiguous(), right_out.contiguous()
    from_left, from_right = torch.zeros_like(right_out), \
        torch.zeros_like(left_out)
    if n == 1:
        return from_left, from_right
    group, stride = mesh.axis_group(axis), mesh.axis_stride(axis)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, left_out, mesh.rank - stride, group),
                dist.P2POp(dist.irecv, from_left, mesh.rank - stride, group)]
        neighbor_ppermute.bytes_sent += left_out.numel() * \
            left_out.element_size()
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, right_out, mesh.rank + stride, group),
                dist.P2POp(dist.irecv, from_right, mesh.rank + stride, group)]
        neighbor_ppermute.bytes_sent += right_out.numel() * \
            right_out.element_size()
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_left, from_right


neighbor_ppermute.bytes_sent = 0


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank read the same sum: its total cotangent is the sum of
        # the ranks' cotangents
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the ranks of group; differentiable when autograd
    records t, else summed in place (no copy).

    Legal inside a CUDA graph capture (sim/tiles.py's graphs hold it): it
    reads nothing on the host, its copies are made on the current stream
    (while capturing, in the graph's pool), and the backward's all-reduce
    is issued on the stream autograd runs the node on, the capture stream
    when the backward is itself captured."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    dist.all_reduce(t, group=group)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size, index):
        t = t.contiguous()
        ctx.n, ctx.index = t.shape[0], index
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # the consumer is replicated: every rank holds the whole cotangent,
        # this rank's part of it is its slice (a sum over the ranks would
        # count it once per rank)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None, None


def all_gather_grad(t: torch.Tensor, mesh: Mesh,
                    axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's t along ``axis`` (None: the world) concatenated along
    dim 0, differentiable for a consumer that every rank runs alike."""
    return _AllGather.apply(t, mesh.axis_group(axis), mesh.axis_size(axis),
                            mesh.axis_index(axis))
