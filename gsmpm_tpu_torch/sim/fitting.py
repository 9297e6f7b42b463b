"""System identification: learn E, nu by gradient descent through sim+render.

Port of gsmpm_tpu/sim/fitting.py.  Per-particle logE, y with
E = 10^logE and nu = 0.49 sigmoid(y), updated by clipped SGD (lr 0.8 /
1.6).  One observed frame: ``substeps_per_frame`` differentiable substeps,
the windowed drop-free render, the L1 + SSIM loss, backward, SGD.

The substeps run on the tiled engine with the hand-written transfer VJPs
(``"tiled_vjp"``: kernels K1, K2 and K6) on CUDA, where the JAX package
takes it on the TPU, and on the golden planes engine (``"golden"``,
sim/solver.py) elsewhere; an occupied-tile-cap overflow moves the run to
the golden engine and re-runs the frame, as in the JAX package.  The
render is the one ``raster_cfg`` selects: the windowed path (kernels K4 /
K5, the two-tier windows once a resize set k_dense) or, with
``RasterConfig(stream=True)``, the stream rasterizer (kernels K3 / K7).  A
frame whose render dropped candidates is re-run after the caps (or the
stream's tier budgets) are resized from the measured geometry, so no
truncated gradient is applied.

With a ``mesh`` (parallel/mesh.py, one process per device) ``fit_frame``
runs the sharded fit step of parallel/sharded.py: particles over the data
axis (padded with inert fillers to its size), block rows over the tile
axis.  Its update is the single-device update; the model, the state and
the image stay whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gsmpm_tpu_torch.config import MPMConfig
from gsmpm_tpu_torch.models.gaussians import GaussianScene
from gsmpm_tpu_torch.ops.losses import photometric_loss
from gsmpm_tpu_torch.render.camera import Camera
from gsmpm_tpu_torch.render.renderer import (
    RasterConfig,
    bump_caps_for_dropfree,
    render,
    render_with_aux,
)
from gsmpm_tpu_torch.sim.boundary import BCSet, sticky_ground
from gsmpm_tpu_torch.sim.coupling import (
    grid2world,
    mat_from_upper,
    upper_from_mat,
    world2grid,
)
from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu_torch.sim.solver import run_substeps
from gsmpm_tpu_torch.sim.state import (
    GridConfig,
    MPMState,
    init_model,
    init_state,
    logE_y_from_E_nu,
    mu_lam_from_logE_y,
)
from gsmpm_tpu_torch.sim.tiles import run_substeps_tiled_fitting
from gsmpm_tpu_torch.sim.volume import particle_volume
from gsmpm_tpu_torch.utils.spans import span


class FitConfig(NamedTuple):
    substeps_per_frame: int = 30
    frame_dt: float = 0.03
    lr_logE: float = 0.8
    lr_y: float = 1.6
    grad_clip: float = 1.0
    world_pad: float = 0.3
    # one scalar (logE, y) pair shared by all particles: the gradient is
    # the sum over particles, clipped as a scalar
    tie_params: bool = False


def cfl_dt_limit(E: float, nu: float, density: float, dx: float) -> float:
    """Explicit-MPM stability bound dt < dx / c_p, with the p-wave speed
    c_p = sqrt((lambda + 2 mu) / rho)."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return dx / float(np.sqrt((lam + 2.0 * mu) / density))


def sgd_learn(logE, y, g_logE, g_y, cfg: FitConfig):
    """Per-particle clipped SGD; non-finite gradients are dropped."""
    c = cfg.grad_clip

    def finite(g):
        return torch.where(torch.isfinite(g), g, 0.0)

    if cfg.tie_params:
        g_logE = torch.clamp(finite(g_logE).sum(), -c, c)
        g_y = torch.clamp(finite(g_y).sum(), -c, c)
    else:
        # an infinite gradient is dropped, not clipped to +-c
        g_logE = finite(g_logE).clamp(-c, c)
        g_y = finite(g_y).clamp(-c, c)
    return logE - cfg.lr_logE * g_logE, y - cfg.lr_y * g_y


def detach_state(s: MPMState) -> MPMState:
    return MPMState(**{f.name: getattr(s, f.name).detach()
                       for f in dataclasses.fields(s)})


def world_geometry(state: MPMState, scaling, pos_center, grid_extent: float):
    """(xyz_w, cov_w) of a post-substep state: the render geometry,
    cov = F Sigma0 F^T taken back to world space."""
    F = state.F
    cov6 = upper_from_mat(F @ mat_from_upper(state.init_cov)
                          @ F.transpose(-1, -2))
    return grid2world(state.x, cov6, scaling, pos_center, grid_extent)


def fit_substeps(engine: str, state: MPMState, model, bcs, t: float,
                 n_sub: int, grid: GridConfig, dt: float, group=None):
    """(state, t, ok) after n_sub differentiable fitting substeps on
    ``engine``: "tiled_vjp" (the tiled layout with the hand-written
    transfer VJPs; ok False on an occupied-tile-cap overflow) or "golden"
    (sim/solver.py, checkpointed per substep).  With a process ``group``,
    state is this rank's particle shard and the grid is summed over the
    group's ranks; ok is then this rank's."""
    if engine == "tiled_vjp":
        soa, t, ok = run_substeps_tiled_fitting(
            soa_from_state(state), model, bcs, t, n_sub, grid, dt,
            group=group)
        with span("fit.unpack"):
            state = state_from_soa(soa)
        return state, t, bool(ok)
    state, t = run_substeps(state, model, bcs, t, n_sub, grid, dt,
                            fitting=True, checkpoint_policy="substep",
                            group=group)
    return state, t, True


_APPEARANCE = ("xyz", "features_dc", "features_rest", "opacity", "scaling")


class SystemIdentifier:
    """Fit per-particle logE, y to observed frames by differentiable
    sim+render.  Everything lives on the scene's device."""

    def __init__(
        self,
        scene: GaussianScene,
        mpm_cfg: MPMConfig,
        init_velocity: Optional[torch.Tensor] = None,
        fit_cfg: FitConfig = FitConfig(),
        raster_cfg: RasterConfig = RasterConfig(),
        bg: Optional[torch.Tensor] = None,
        mesh=None,
        data_axis: str = "data",
        tile_axis: str = "tile",
    ):
        """mesh: a parallel.mesh.Mesh; fit_frame then runs the sharded fit
        step (particles over ``data_axis``, block rows over ``tile_axis``
        when the mesh has it), every rank calling it alike."""
        self.scene = scene
        self.device = scene.xyz.device
        self.mpm_cfg = dataclasses.replace(mpm_cfg, fitting=True)
        self.fit_cfg = fit_cfg
        self.raster_cfg = raster_cfg
        self.bg = (torch.ones(3, device=self.device) if bg is None
                   else bg.to(self.device))
        self.grid = GridConfig(mpm_cfg.n_grid, mpm_cfg.grid_extent)
        self.mesh = mesh
        self.data_axis = data_axis
        self.tile_axis = tile_axis
        self._pad_mult = 1 if mesh is None else mesh.axis_size(data_axis)
        n = scene.num_gaussians
        self.n_orig = n
        self.init_velocity = (
            torch.zeros((n, 3), dtype=torch.float32, device=self.device)
            if init_velocity is None else init_velocity)
        self.model = init_model(self.mpm_cfg, n, self.device)
        if fit_cfg.tie_params:
            # one scalar pair: a heterogeneous init collapses to its mean
            self._set_params(torch.full_like(self.model.logE,
                                             float(self.model.logE.mean())),
                             torch.full_like(self.model.y,
                                             float(self.model.y.mean())))
        if self._pad_mult > 1:
            from gsmpm_tpu_torch.parallel.mesh import pad_model

            self.model = pad_model(self.model, self._pad_mult)
        # "tiled_vjp" on CUDA, "golden" elsewhere; a test may set it
        self._sim_engine = None
        self.n_dropped_last = 0
        self._drop_warned = False
        self._k_bumps = 0  # consecutive failed cap rebuilds
        self._total_rebuilds = 0
        self._max_cap_rebuilds = 6

    def _set_params(self, logE, y) -> None:
        mu, lam = mu_lam_from_logE_y(logE, y)
        self.model = dataclasses.replace(self.model, logE=logE, y=y, mu=mu,
                                         lam=lam)

    @property
    def sim_engine(self) -> str:
        if self._sim_engine is None:
            self._sim_engine = ("tiled_vjp" if self.device.type == "cuda"
                                else "golden")
        return self._sim_engine

    # --- per-iteration setup ---

    def reset_state(self) -> MPMState:
        with torch.no_grad():
            g_xyz, self.pos_center, self.scaling = world2grid(
                self.scene.xyz, self.mpm_cfg.grid_extent,
                pad=self.fit_cfg.world_pad)
            g_cov = self.scene.get_covariance() * (self.scaling
                                                   * self.scaling)
            vol = particle_volume(g_xyz, self.mpm_cfg.n_grid,
                                  self.mpm_cfg.grid_extent)
            state = init_state(g_xyz, g_cov, vol, self.mpm_cfg,
                               self.init_velocity)
        if self._pad_mult > 1:
            from gsmpm_tpu_torch.parallel.mesh import pad_state

            state = pad_state(state, self._pad_mult)
        self.bcs = BCSet(grid_ops=(sticky_ground(self.device),))
        return state

    def _appearance(self):
        """(opacity, features) padded to the model's size: fillers have
        opacity 0 and blend to nothing."""
        opacity = self.scene.get_opacity().reshape(-1)
        features = self.scene.get_features()
        k = self.model.logE.shape[0] - opacity.shape[0]
        if k:
            opacity = torch.cat([opacity, opacity.new_zeros(k)])
            features = torch.cat(
                [features, features.new_zeros((k,) + features.shape[1:])])
        return opacity, features

    def _world_geometry(self, state: MPMState):
        return world_geometry(state, self.scaling, self.pos_center,
                              self.mpm_cfg.grid_extent)

    def _measure_and_bump(self, state: MPMState, camera: Camera,
                          mesh=None) -> None:
        """Resize the rasterizer caps from the measured maxima at the
        dropped frame's end-of-frame geometry (+25-50% headroom); on a
        ``mesh`` every rank takes rank 0's resize."""
        with torch.no_grad():
            xyz_w, cov_w = self._world_geometry(state)
            opacity, _ = self._appearance()
            cfg = self.raster_cfg
            new = bump_caps_for_dropfree(cfg, xyz_w, cov_w, opacity, camera)
        if cfg.stream:
            print("fitting: resizing rasterizer tier budgets for a drop-free "
                  f"render (g2/g3/g4 {cfg.stream_g2}/{cfg.stream_g3}/"
                  f"{cfg.stream_g4} -> {new.stream_g2}/{new.stream_g3}/"
                  f"{new.stream_g4}); re-running the frame")
        else:
            print("fitting: resizing rasterizer caps for a drop-free render "
                  f"(k_dense {cfg.k_dense}->{new.k_dense}, n_dense "
                  f"{cfg.n_dense}->{new.n_dense}, k_row {cfg.k_row}->"
                  f"{new.k_row}, k_block {cfg.k_block}->{new.k_block}); "
                  "re-running the frame")
        if mesh is not None:
            from gsmpm_tpu_torch.parallel.mesh import broadcast_object

            new = broadcast_object(new, mesh)
        self.raster_cfg = new
        self._k_bumps += 1
        self._total_rebuilds += 1

    def _drop_free(self, attempt, camera: Camera, mesh=None):
        """Run ``attempt() -> (result, ok, n_dropped, end state)`` until a
        try is drop-free: an engine overflow (ok False) moves the run to
        the golden engine for good, a drop resizes the caps from the
        measured geometry, and the same frame is re-run either way, so no
        truncated gradient is applied.  On a ``mesh`` every rank must read
        the same ok and n_dropped.  Returns the last try's result."""
        while True:
            result, ok, nd, state2 = attempt()
            if not ok:
                print("fitting: tiled-VJP sim engine overflow — falling "
                      "back to the golden planes engine")
                self._sim_engine = "golden"
                continue
            self.n_dropped_last = nd
            if nd == 0:
                self._k_bumps = 0  # the budget bounds consecutive failures
                break
            if self._k_bumps >= self._max_cap_rebuilds:
                break
            self._measure_and_bump(state2, camera, mesh)
        if self.n_dropped_last and not self._drop_warned:
            print(f"WARNING: fitting render still dropped "
                  f"{self.n_dropped_last} candidates after {self._k_bumps} "
                  "cap rebuilds — gradients are biased against a truncated "
                  "image")
            self._drop_warned = True
        return result

    # --- the differentiable frame ---

    def frame_loss(self, logE, y, state: MPMState, t: float, camera: Camera,
                   gt_image):
        """Forward of one fit frame: (loss, state', t', image, n_dropped,
        ok), recorded by autograd from (logE, y).  ok is False when the
        tiled engine overflowed its occupied-tile cap (nothing is rendered
        then)."""
        with span("fit.params"):
            mu, lam = mu_lam_from_logE_y(logE, y)
            model = dataclasses.replace(self.model, logE=logE, y=y, mu=mu,
                                        lam=lam)
        fcfg = self.fit_cfg
        state2, t2, ok = fit_substeps(
            self.sim_engine, state, model, self.bcs, t,
            fcfg.substeps_per_frame, self.grid,
            fcfg.frame_dt / fcfg.substeps_per_frame)
        if not ok:
            return None, state2, t2, None, 0, False
        with span("fit.geometry"):
            xyz_w, cov_w = self._world_geometry(state2)
            opacity, features = self._appearance()
        img, nd = render_with_aux(xyz_w, cov_w, opacity, features, camera,
                                  self.bg, self.scene.sh_degree,
                                  self.raster_cfg)
        with span("fit.loss"):
            loss = photometric_loss(img, gt_image)
        return loss, state2, t2, img, int(nd), True

    def fit_frame(self, state: MPMState, t: float, camera: Camera,
                  gt_image):
        """One observed frame: forward substeps + render, backward, SGD.

        Returns (loss, new_state, new_t, rendered_image), all detached;
        updates self.model's logE / y."""
        with span("fit.frame", request=True):
            if self.mesh is not None:
                return self._fit_frame_sharded(state, t, camera, gt_image)
            return self._fit_frame(state, t, camera, gt_image)

    def _fit_frame(self, state: MPMState, t: float, camera: Camera,
                   gt_image):
        """fit_frame on one device."""

        def attempt():
            logE = self.model.logE.detach().requires_grad_(True)
            y = self.model.y.detach().requires_grad_(True)
            with torch.enable_grad():
                loss, state2, t2, img, nd, ok = self.frame_loss(
                    logE, y, state, t, camera, gt_image)
            return ((loss, state2, t2, img, logE, y), ok, nd,
                    detach_state(state2))

        loss, state2, t2, img, logE, y = self._drop_free(attempt, camera)
        with span("fit.backward", glue=True):
            g_logE, g_y = torch.autograd.grad(loss, (logE, y))
        with span("fit.update"), torch.no_grad():
            new_logE, new_y = sgd_learn(logE.detach(), y.detach(), g_logE,
                                        g_y, self.fit_cfg)
            self._set_params(new_logE, new_y)
        self.last_grads = (g_logE, g_y)
        return loss.detach(), detach_state(state2), t2, img.detach()

    def _fit_frame_sharded(self, state: MPMState, t: float, camera: Camera,
                           gt_image):
        """fit_frame on the mesh: the sharded fit step of
        parallel/sharded.py, the whole padded state in and out, each rank
        stepping its block along the data axis."""
        from gsmpm_tpu_torch.parallel.mesh import gather, shard
        from gsmpm_tpu_torch.parallel.sharded import make_sharded_fit_step

        mesh, axis, fcfg = self.mesh, self.data_axis, self.fit_cfg
        opacity, features = self._appearance()
        st_l, logE_l, y_l, opac_l, feat_l = shard(
            (state, self.model.logE, self.model.y, opacity, features), mesh,
            axis)

        def attempt():
            # built at the engine and caps in use (a closure: no compile)
            step = make_sharded_fit_step(
                mesh, example_model=self.model, bcs=self.bcs, grid=self.grid,
                frame_dt=fcfg.frame_dt, n_substeps=fcfg.substeps_per_frame,
                camera=camera, bg=self.bg, opacity=opac_l, features=feat_l,
                sh_degree=self.scene.sh_degree, scaling=self.scaling,
                pos_center=self.pos_center,
                grid_extent=self.mpm_cfg.grid_extent, lr_logE=fcfg.lr_logE,
                lr_y=fcfg.lr_y, grad_clip=fcfg.grad_clip, data_axis=axis,
                tile_axis=self.tile_axis, tie_params=fcfg.tie_params,
                rcfg=self.raster_cfg, sim_engine=self.sim_engine)
            out = step(logE_l, y_l, st_l, t, gt_image)
            state2 = gather(out.state, mesh, axis)
            return (out, state2), out.sim_ok, out.n_dropped, state2

        out, state2 = self._drop_free(attempt, camera, mesh)
        logE, y, g_logE, g_y = gather((out.logE, out.y) + out.grads, mesh,
                                      axis)
        self._set_params(logE, y)
        self.last_grads = (g_logE, g_y)
        return out.loss, state2, out.t, out.image

    # --- readout ---

    # gsmpm_tpu's readouts (10^mean(logE), nu of mean(y)) with the means
    # taken in float64: with tied parameters they are then each particle's
    # MPMModel.E() / nu() to float32's rounding, where a float32 mean of
    # 10^5 equal values is off by ~1e-7 (1e-6 in E)
    @property
    def optimized_E(self) -> float:
        return float(10.0 ** self.model.logE[: self.n_orig].double().mean())

    @property
    def optimized_nu(self) -> float:
        y_mean = float(self.model.y[: self.n_orig].double().mean())
        return float(0.49 / (1.0 + np.exp(-y_mean)))

    # --- ground truth by simulation ---

    def _render_state(self, state: MPMState, camera: Camera):
        xyz_w, cov_w = self._world_geometry(state)
        opacity, features = self._appearance()
        return render_with_aux(xyz_w, cov_w, opacity, features, camera,
                               self.bg, self.scene.sh_degree, self.raster_cfg)

    @torch.no_grad()
    def generate_ground_truth(self, E_true: float, nu_true: float,
                              cameras: Sequence[Camera], n_frames: int):
        """Frames of the scene simulated at (E_true, nu_true) on the golden
        engine: frame 0 is the initial state, frame f the state after f
        frames.  Drop-free: on any overflow the caps are resized and the
        frames regenerated."""
        logE0, y0 = logE_y_from_E_nu(E_true, nu_true)
        n = self.model.logE.shape[0]
        f32 = dict(dtype=torch.float32, device=self.device)
        logE = torch.full((n,), logE0, **f32)
        y = torch.full((n,), y0, **f32)
        mu, lam = mu_lam_from_logE_y(logE, y)
        model = dataclasses.replace(self.model, logE=logE, y=y, mu=mu,
                                    lam=lam)
        state = self.reset_state()
        n_sub = self.fit_cfg.substeps_per_frame
        for _ in range(3):
            img0, nd = self._render_state(state, cameras[0])
            frames = [img0]
            total_dropped = int(nd)
            st, t = state, 0.0
            for fid in range(1, n_frames):
                cam = cameras[fid % len(cameras)]
                dt = self.fit_cfg.frame_dt / n_sub
                st, t = run_substeps(st, model, self.bcs, t, n_sub,
                                     self.grid, dt, fitting=True,
                                     checkpoint_policy=None)
                img, nd = self._render_state(st, cam)
                frames.append(img)
                total_dropped += int(nd)
            if total_dropped == 0:
                self._k_bumps = 0
                break
            if self._k_bumps >= self._max_cap_rebuilds:
                break
            self._measure_and_bump(st, cameras[(n_frames - 1) % len(cameras)])
        if total_dropped:
            print(f"WARNING: ground-truth render dropped {total_dropped} "
                  "candidates over the rasterizer caps")
        return frames

    # --- frame-0 appearance refinement ---

    def make_appearance_optimizer(self, spatial_lr_scale: float = 1.0):
        """(Adam over the raw gaussian parameters with the reference's
        per-group learning rates, the parameter dict)."""
        lrs = {
            "xyz": 0.0000016 * spatial_lr_scale,
            "features_dc": 0.0025,
            "features_rest": 0.0025 / 20.0,
            "opacity": 0.05,
            "scaling": 0.005,
        }
        params = {k: getattr(self.scene, k).detach().clone().requires_grad_(True)
                  for k in _APPEARANCE}
        opt = torch.optim.Adam(
            [{"params": [params[k]], "lr": lr} for k, lr in lrs.items()],
            eps=1e-15)
        return opt, params

    def appearance_step(self, opt, params, *, camera: Camera, gt_image):
        """One Adam step on appearance from the frame-0 observation; the
        scene takes the new parameters.  Returns the loss.  ``opt`` (from
        make_appearance_optimizer) holds what gsmpm_tpu passes as optax's
        ``tx`` and ``opt_state``."""
        with span("fit.appearance", request=True):
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                with span("fit.geometry"):
                    sc = GaussianScene(rotation=self.scene.rotation,
                                       sh_degree=self.scene.sh_degree,
                                       **{k: params[k] for k in _APPEARANCE})
                    geom = (sc.get_covariance(), sc.get_opacity().reshape(-1),
                            sc.get_features())
                img = render(sc.xyz, *geom, camera, self.bg, sc.sh_degree,
                             self.raster_cfg)
                with span("fit.loss"):
                    loss = photometric_loss(img, gt_image)
                with span("fit.backward", glue=True):
                    loss.backward()
            with span("fit.update"):
                opt.step()
                self.scene = dataclasses.replace(
                    self.scene, **{k: params[k].detach() for k in _APPEARANCE})
            return loss.detach()
