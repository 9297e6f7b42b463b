"""Particle-sharded simulation frame, tile-sharded render and the
multi-device fit steps over a mesh.

Port of gsmpm_tpu/parallel/sharded.py on the multi-process mesh of
parallel/mesh.py:

- simulation: each rank runs the golden engine on its particle shard; its
  dense P2G grid (mass and the 3 momentum planes) is all-reduced over the
  mesh before the grid update (``run_substeps(..., group=...)``, the JAX
  engine's ``psum``).  The grid is small (n_grid^3 nodes), so replicate
  and reduce needs no halo bookkeeping;
- rendering: the gaussians are all-gathered, every rank preprocesses and
  depth-sorts all of them (replicated, so n_dropped is the same on every
  rank) and renders a contiguous range of block rows with
  ``render_block_rows`` (kernel K4); the rows are all-gathered;
- system identification, ``make_sharded_fit_step``: particles over the
  ``data`` axis, block rows over the ``tile`` axis.  Each rank runs the
  differentiable substeps on its shard (engine ``tiled_vjp``: kernels K1,
  K2, K6 with the folded grid all-reduced over the data axis; ``golden``:
  the dense grid all-reduced), all-gathers the splats, renders its rows
  (K4 forward, K5 backward) and back-propagates the loss of the gathered
  image; ``make_camera_dp_fit_step``: one camera per rank of the ``cam``
  axis, the physics replicated, the loss the camera mean.

The fit steps' gradients are the single-device gradients at every mesh
shape: the collectives' adjoints are those of parallel/mesh.py, and the
two reductions of the parameter gradients are written out (the sum over
the tile axis, where each rank back-propagated only its own rows; the
mean over the camera axis of each camera's gradient).  gsmpm_tpu's steps
run under ``shard_map(check_vma=False)``, where the transposes of ``all_gather`` and
``psum`` of a replicated loss sum equal cotangents: its updates are the
device count times the single-device update (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gsmpm_tpu_torch.ops.losses import photometric_loss
from gsmpm_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_gather_grad,
    all_ranks,
    gather,
    shard,
)
from gsmpm_tpu_torch.render.camera import Camera
from gsmpm_tpu_torch.render.renderer import (
    RasterConfig,
    _xla_dropped_count,
    assemble_blocks,
    block_origins,
    preprocess,
    render_block_rows,
    render_with_aux,
)
from gsmpm_tpu_torch.sim.fitting import (
    FitConfig,
    detach_state,
    fit_substeps,
    sgd_learn,
    world_geometry,
)
from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig, MPMState, mu_lam_from_logE_y


def _render_tile_sharded(means3d, cov6, opacity, shs, camera: Camera, bg,
                         sh_degree: int, rcfg: RasterConfig,
                         mesh: Mesh = None, axis: Optional[str] = None):
    """Full-image render with the block rows split over the ranks of the
    mesh's ``axis`` (None: all of them; everything on one device when mesh
    is None).  Inputs are the full (gathered) arrays.  Differentiable: the
    rows' all-gather hands each rank the cotangent of its own rows.
    Returns (image, n_dropped over k_row / k_block)."""
    pre = preprocess(means3d, cov6, opacity, shs, camera, sh_degree, rcfg)
    key = torch.where(pre.valid, pre.depth, torch.inf)
    order = torch.sort(key, stable=True).indices
    dropped = _xla_dropped_count(pre, camera, rcfg)
    _, nbx, nby = block_origins(camera, rcfg)
    if mesh is None:
        blocks = render_block_rows(pre, order, 0.0, nby, nbx, bg, rcfg)
        return assemble_blocks(blocks, camera, rcfg), dropped
    rows_local = -(-nby // mesh.axis_size(axis))
    y_start = float(mesh.axis_index(axis) * rows_local * rcfg.block)
    blocks = render_block_rows(pre, order, y_start, rows_local, nbx, bg, rcfg)
    blocks = all_gather_grad(blocks, mesh, axis)[: nby * nbx]
    return assemble_blocks(blocks, camera, rcfg), dropped


def make_sharded_frame_fn(mesh: Mesh, *, bcs, grid: GridConfig, dt: float,
                          n_substeps: int, incremental_cov: bool = False,
                          rotate_sh: bool = False):
    """(state, model, t) -> (state, t, R) on this rank's particle shard,
    the dense grid all-reduced every substep.  R is None unless rotate_sh.
    The particle count must be divisible by the mesh size (pad with
    parallel.mesh.pad_particles first)."""

    def frame(state, model, t):
        state, t = run_substeps(
            state, model, bcs, t, n_substeps, grid, dt,
            checkpoint_policy=None, incremental_cov=incremental_cov,
            group=mesh.group,
        )
        cov6, R = postprocess(state, rotate_sh=rotate_sh)
        return dataclasses.replace(state, cov=cov6), t, R

    return frame


def make_sharded_render_fn(mesh: Mesh, *, camera: Camera, bg,
                           sh_degree: int,
                           rcfg: RasterConfig = RasterConfig()):
    """fn(means3d, cov6, opacity, shs) on this rank's shard -> (H, W, 3),
    the image replicated on every rank."""

    def render(means3d, cov6, opacity, shs):
        full = gather((means3d, cov6, opacity, shs), mesh)
        img, _ = _render_tile_sharded(*full, camera, bg, sh_degree, rcfg, mesh)
        return img

    return render


# ---------------------------------------------------------------------------
# the fit steps
# ---------------------------------------------------------------------------

class FitStepOut(NamedTuple):
    """One fit step on this rank: the loss (None when not sim_ok), the
    updated logE / y and the state (this rank's shard under the sharded
    step, everything under camera-DP), the time, the image (the whole
    image; camera-DP: this rank's camera's), n_dropped (the same on every
    rank), sim_ok (False on every rank when the tiled engine overflowed
    on any: nothing was rendered or updated, redo the step on golden) and
    the reduced gradients (g_logE, g_y) before clipping."""

    loss: Optional[torch.Tensor]
    logE: torch.Tensor
    y: torch.Tensor
    state: MPMState
    t: float
    image: Optional[torch.Tensor]
    n_dropped: int
    sim_ok: bool
    grads: Optional[tuple]


def _engine(sim_engine: str, mesh: Mesh) -> str:
    """"auto": the tiled-VJP engine on CUDA, golden elsewhere."""
    if sim_engine == "auto":
        return "tiled_vjp" if mesh.device.type == "cuda" else "golden"
    if sim_engine not in ("tiled_vjp", "golden"):
        raise ValueError(f"sim_engine {sim_engine!r}: tiled_vjp | golden")
    return sim_engine


def _sgd(logE, y, g_logE, g_y, lr_logE, lr_y, grad_clip, tie_params,
         group=None):
    """sim/fitting.sgd_learn on this rank's gradients; tied, the finite
    per-particle sum is first summed over ``group`` (the particle shards)."""
    if tie_params:
        def total(g):
            s = torch.where(torch.isfinite(g), g, 0.0).sum().reshape(1)
            if group is not None:
                dist.all_reduce(s, group=group)
            return s

        g_logE, g_y = total(g_logE), total(g_y)
    cfg = FitConfig(lr_logE=lr_logE, lr_y=lr_y, grad_clip=grad_clip,
                    tie_params=tie_params)
    return sgd_learn(logE, y, g_logE, g_y, cfg)


def _dropped(n: torch.Tensor, mesh: Mesh, sum_group=None) -> int:
    """n_dropped summed over sum_group (the cameras), then its maximum over
    the mesh: a count every rank reads alike."""
    t = n.detach().reshape(1).to(torch.int64)
    if sum_group is not None:
        dist.all_reduce(t, group=sum_group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t[0])


def make_sharded_fit_step(
    mesh: Mesh,
    *,
    example_model,
    bcs,
    grid: GridConfig,
    frame_dt: float,
    n_substeps: int,
    camera: Camera,
    bg,
    opacity,
    features,
    sh_degree: int,
    scaling,
    pos_center,
    grid_extent: float,
    lr_logE: float = 0.8,
    lr_y: float = 1.6,
    grad_clip: float = 1.0,
    data_axis: str = "data",
    tile_axis: Optional[str] = "tile",
    tie_params: bool = False,
    rcfg: RasterConfig = RasterConfig(),
    sim_engine: str = "auto",
):
    """One sharded training step of system identification.

    step(logE, y, state, t, gt) -> FitStepOut

    logE, y, state, opacity and features are this rank's block of the
    padded particles along ``data_axis`` (parallel/mesh.shard);
    example_model is the whole padded model (its per-particle material
    fields are sliced here).  Block rows are split over ``tile_axis`` when
    the mesh has it.

    The update is the single-device ``SystemIdentifier.fit_frame``'s
    (sim/fitting.sgd_learn): per particle, or with tie_params one scalar
    pair from the gradient summed over all particles.  n_dropped counts
    candidates over the k_row / k_block caps (the maximum over ranks).

    sim_engine: "auto" (tiled_vjp on CUDA, golden elsewhere), "tiled_vjp"
    (each rank buckets its own shard; the folded grid is all-reduced over
    the data axis in every substep and its recompute: on CUDA inside the
    fitting window's two CUDA graphs, sim/tiles.py's ``_FittingWindow``,
    elsewhere inside every checkpointed substep) or "golden".  sim_ok
    False (the tiled engine overflowed on some rank) means the caller
    rebuilds with "golden" and re-runs the step.
    """
    dt = frame_dt / n_substeps
    tile = tile_axis if tile_axis in mesh.axis_names else None
    engine = _engine(sim_engine, mesh)
    d_group = mesh.axis_group(data_axis)
    base = shard(example_model, mesh, data_axis)

    def step(logE, y, state, t, gt):
        logE = logE.detach().requires_grad_(True)
        y = y.detach().requires_grad_(True)
        with torch.enable_grad():
            mu, lam = mu_lam_from_logE_y(logE, y)
            model = dataclasses.replace(base, logE=logE, y=y, mu=mu, lam=lam)
            state2, t2, ok = fit_substeps(engine, state, model, bcs, t,
                                          n_substeps, grid, dt, d_group)
            # a shard's overflow invalidates the whole step, on every rank
            if not all_ranks(ok, mesh):
                return FitStepOut(None, logE.detach(), y.detach(),
                                  detach_state(state2), t2, None, 0, False,
                                  None)
            xyz_w, cov_w = world_geometry(state2, scaling, pos_center,
                                          grid_extent)
            img, nd = _render_tile_sharded(
                all_gather_grad(xyz_w, mesh, data_axis),
                all_gather_grad(cov_w, mesh, data_axis),
                all_gather_cat(opacity, mesh, axis=data_axis),
                all_gather_cat(features, mesh, axis=data_axis),
                camera, bg, sh_degree, rcfg, mesh, tile)
            loss = photometric_loss(img, gt)
        g_logE, g_y = torch.autograd.grad(loss, (logE, y))
        if tile is not None:
            # each tile rank back-propagated only its own rows
            for g in (g_logE, g_y):
                dist.all_reduce(g, group=mesh.axis_group(tile))
        new_logE, new_y = _sgd(logE.detach(), y.detach(), g_logE, g_y,
                               lr_logE, lr_y, grad_clip, tie_params, d_group)
        return FitStepOut(loss.detach(), new_logE, new_y,
                          detach_state(state2), t2, img.detach(),
                          _dropped(nd, mesh), True, (g_logE, g_y))

    return step


def stack_cameras(cameras):
    """Same-resolution Cameras stacked into one Camera whose array fields
    carry a leading batch axis (the static fields must agree)."""
    c0 = cameras[0]
    for c in cameras[1:]:
        if (c.width, c.height, c.fovx, c.fovy) != (c0.width, c0.height,
                                                   c0.fovx, c0.fovy):
            raise ValueError("stack_cameras needs identical static camera "
                             "fields")
    return Camera(view=np.stack([c.view for c in cameras]),
                  full_proj=np.stack([c.full_proj for c in cameras]),
                  campos=np.stack([c.campos for c in cameras]),
                  width=c0.width, height=c0.height, fovx=c0.fovx,
                  fovy=c0.fovy)


def make_camera_dp_fit_step(
    mesh: Mesh,
    example_model,
    bcs,
    grid: GridConfig,
    frame_dt: float,
    n_substeps: int,
    bg,
    opacity,
    features,
    sh_degree: int,
    scaling,
    pos_center,
    grid_extent: float,
    raster_cfg: RasterConfig = RasterConfig(),
    lr_logE: float = 0.8,
    lr_y: float = 1.6,
    grad_clip: float = 1.0,
    cam_axis: str = "cam",
    *,
    tie_params: bool = False,
    sim_engine: str = "auto",
):
    """Data-parallel system-ID step over a batch of cameras: one camera per
    rank of ``cam_axis``, the physics replicated (no grid collective), the
    loss the mean over the cameras, the gradient its gradient.

    step(logE, y, state, t, cameras_stacked, gts (B, H, W, 3)) ->
    FitStepOut, B the size of cam_axis; rank c takes camera c and gts[c].
    The render is the single-device ``render_with_aux`` (the two-tier
    windowed blend, K4 / K5, or with ``raster_cfg.stream`` the stream
    blend, K3 / K7).  The loss is the
    camera mean, n_dropped the sum over the cameras; sim_ok as in
    make_sharded_fit_step.  With tie_params the gradient is summed over
    the particles after the camera mean.
    """
    dt = frame_dt / n_substeps
    engine = _engine(sim_engine, mesh)
    group = mesh.axis_group(cam_axis)
    nb, c = mesh.axis_size(cam_axis), mesh.axis_index(cam_axis)

    def step(logE, y, state, t, cameras_stacked: Camera, gts):
        cs = cameras_stacked
        cam = Camera(view=cs.view[c], full_proj=cs.full_proj[c],
                     campos=cs.campos[c], width=cs.width, height=cs.height,
                     fovx=cs.fovx, fovy=cs.fovy)
        logE = logE.detach().requires_grad_(True)
        y = y.detach().requires_grad_(True)
        with torch.enable_grad():
            mu, lam = mu_lam_from_logE_y(logE, y)
            model = dataclasses.replace(example_model, logE=logE, y=y, mu=mu,
                                        lam=lam)
            state2, t2, ok = fit_substeps(engine, state, model, bcs, t,
                                          n_substeps, grid, dt)
            if not all_ranks(ok, mesh):
                return FitStepOut(None, logE.detach(), y.detach(),
                                  detach_state(state2), t2, None, 0, False,
                                  None)
            xyz_w, cov_w = world_geometry(state2, scaling, pos_center,
                                          grid_extent)
            img, nd = render_with_aux(xyz_w, cov_w, opacity, features, cam,
                                      bg, sh_degree, raster_cfg)
            loss_c = photometric_loss(img, gts[c])
        g_logE, g_y = torch.autograd.grad(loss_c, (logE, y))
        loss = loss_c.detach().reshape(1).clone()
        for g in (g_logE, g_y, loss):
            dist.all_reduce(g, group=group)  # the mean over the cameras
            g /= nb
        new_logE, new_y = _sgd(logE.detach(), y.detach(), g_logE, g_y,
                               lr_logE, lr_y, grad_clip, tie_params)
        return FitStepOut(loss[0], new_logE, new_y,
                          detach_state(state2), t2, img.detach(),
                          _dropped(nd, mesh, group), True, (g_logE, g_y))

    return step
