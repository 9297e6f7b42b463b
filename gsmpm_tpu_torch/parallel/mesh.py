"""Device mesh over processes and the particle-shard helpers.

Port of gsmpm_tpu/parallel/mesh.py.  The JAX mesh is single-controller
SPMD over the devices of one program; the port's is multi-process
``torch.distributed``: one process per GPU (``torchrun --nproc_per_node N``),
each holding a contiguous block of the particles.  ``make_mesh`` joins the
default process group (NCCL on CUDA, gloo on the CPU), ``shard`` slices
this rank's block of every per-particle tensor and ``gather`` is the
all-gather along the particle axis; they replace the JAX package's
``particle_pspec`` and ``_gather_particles``.

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
    over the ranks), rank, world size, device and process group."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    world_size: int
    device: torch.device
    group: object


def make_mesh(axes: Tuple[Tuple[str, int], ...] = (("data", -1),),
              device: Optional[str] = "cuda") -> Mesh:
    """Join (or build from the ``torchrun`` environment) the default process
    group and lay (name, size) axes over its ranks; one size may be -1
    (inferred).  The backend is NCCL for CUDA and gloo for the CPU; a CUDA
    device never runs on gloo.  Each rank takes ``cuda:LOCAL_RANK``."""
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
    world = dist.get_world_size()
    names = tuple(a[0] for a in axes)
    sizes = [a[1] for a in axes]
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} processes, the group has {world}")
    return Mesh(names, tuple(sizes), dist.get_rank(), world, dev,
                dist.group.WORLD)


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


def shard(tree, mesh: Mesh):
    """This rank's contiguous block of every per-particle tensor: those
    whose leading dimension is that of tree's first tensor, a multiple of
    the world size."""
    n = _leading(tree)
    if n % mesh.world_size:
        raise ValueError(f"{n} particles do not split over {mesh.world_size} "
                         "ranks: pad them first (pad_particles)")
    nl = n // mesh.world_size
    return _map_particles(tree, n, lambda t: t[mesh.rank * nl:
                                                (mesh.rank + 1) * nl])


def all_gather_cat(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's t concatenated along dim, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=dim)


def gather(tree, mesh: Mesh):
    """The full arrays of every per-particle tensor of this rank's shard
    (as shard picks them): the all-gather along the particle axis."""
    return _map_particles(tree, _leading(tree),
                          lambda t: all_gather_cat(t, mesh))
