"""The simulate loop: apps.simulate's frame on one GPU, frame after frame.

Set-up is ``apps.simulate.prepare`` on the seeded scene (the scene loader
is handed the benchmark's tensors) and an ``MPMSolver`` that holds
prepare's state, material model and boundary conditions (the app's ground
collider included).  A step is one frame as the app's tiled frame and
``emit`` make it: ``MPMSolver.step_frame`` (the substep graph of
``tiles.frame_tiled``), ``solver.postprocess`` at the configuration's
``rotate_sh``, a drop-free ``render_with_aux`` (caps resized and the frame
re-rendered while candidates were dropped, as the app does) and the image
copied to the host.  The PNG the app would write is not written.

The check follows the program from its own state: for the frames sampled
from the seed it keeps the state before the frame and what the frame made,
and the reference (``portbench/reference``) recomputes each of those frames
from that state; the start (prepare's particles, volumes, covariances) is
checked on its own against the reference's own set-up.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from portbench import scenes
from portbench.reference import mpm as rm
from portbench.reference import splat as rs

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Loop:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 span=None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.span = span
        self.kept: List[Dict] = []
        # the reference's law of the configuration's material; a material
        # with no law file refuses the run before it starts
        self.law = rm.law(cfg["sim_config"]["mpm"]["material"])

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from gsmpm_tpu_torch.apps import simulate as app
        from gsmpm_tpu_torch.config import SimConfig
        from gsmpm_tpu_torch.models.gaussians import GaussianScene
        from gsmpm_tpu_torch.render.renderer import (RasterConfig,
                                                     bump_caps_for_dropfree,
                                                     render_with_aux)
        from gsmpm_tpu_torch.render.sh import rotate_sh
        from gsmpm_tpu_torch.sim.solver import MPMSolver, postprocess

        cfg = self.cfg
        self.data = scenes.make(cfg["scene"], self.seed, self.dev)
        scene = GaussianScene(**self.data,
                              sh_degree=cfg["scene"].get("sh_degree", 3))
        self.sc = SimConfig.from_dict(cfg["sim_config"])
        mpm = self.sc.mpm
        with mock.patch.object(app, "load_scene",
                               lambda *a, **k: scene):
            su = app.prepare(self.sc, synthetic=scene.num_gaussians,
                             synthetic_res=cfg["render"]["resolution"],
                             device=str(self.dev), quiet=True)
        self.su = su
        st = su.state
        self.start = dict(x=st.x.clone(), vol=st.vol.clone(),
                          init_cov=st.init_cov.clone())
        solver = MPMSolver(st.x, st.cov, st.vol, mpm, device=str(self.dev))
        solver.state, solver.model, solver.bcs = st, su.model, su.bcs
        # the engine the traffic names (the CUDA default; on the CPU its
        # plain twins)
        solver.use_tiled = self.mix["engine"] == "tiled"
        self.solver = solver
        self._postprocess = postprocess
        self._render_with_aux = render_with_aux
        self._bump = bump_caps_for_dropfree
        self._rotate_sh = rotate_sh
        # the app's own drop-free rule: re-render at most this many times
        self.max_rerenders = app._MAX_DROPFREE_REBUILDS
        self.rcfg = RasterConfig(stream=True)
        self.n_frames = 0
        self.reruns = 0
        for _ in range(int(self.mix.get("warmup_frames", 2))):
            self.step(keep=False)

    def _splats(self, x, cov, R):
        su = self.su
        w_xyz, w_cov = su.world(x, cov)
        shs = su.features
        if self.sc.mpm.rotate_sh and R is not None:
            shs = self._rotate_sh(shs, R.transpose(-1, -2),
                                  su.scene.sh_degree)
        return w_xyz, w_cov, su.opacity, shs

    def _render(self, st, R):
        su = self.su
        for attempt in range(self.max_rerenders + 1):
            img, nd = self._render_with_aux(*self._splats(st.x, st.cov, R),
                                            su.camera, su.bg,
                                            su.scene.sh_degree, self.rcfg)
            nd = int(nd)
            if nd == 0 or attempt == self.max_rerenders:
                return img, nd, attempt
            w_xyz, w_cov, opac, _ = self._splats(st.x, st.cov, None)
            self.rcfg = self._bump(self.rcfg, w_xyz, w_cov, opac, su.camera)

    # ------------------------------------------------------------ a step
    def step(self, keep: bool) -> Dict:
        solver = self.solver
        span = self.span
        pre = None
        if keep:
            s = solver.state
            pre = dict(x=s.x.clone(), v=s.v.clone(), C=s.C.clone(),
                       F=s.F_trial.clone(), mass=s.mass.clone(),
                       vol=s.vol.clone(), init_cov=s.init_cov.clone())
        t0 = time.perf_counter()
        with span("sim"):
            solver.step_frame()
            st = solver.state
            cov6, R = self._postprocess(st, rotate_sh=self.sc.mpm.rotate_sh)
            st = dataclasses.replace(st, cov=cov6)
            solver.state = st
            _sync(self.dev)
        t1 = time.perf_counter()
        with span("render"):
            img, nd, reruns = self._render(st, R)
            frame = img.cpu().numpy()
        t2 = time.perf_counter()
        self.n_frames += 1
        self.reruns += reruns
        if keep:
            self.kept.append(dict(pre=pre, x=st.x.clone(),
                                  F=st.F_trial.clone(), cov=cov6.clone(),
                                  image=frame, n_dropped=nd))
        return dict(s=t2 - t0, sim_s=t1 - t0, render_s=t2 - t1,
                    n_dropped=nd, rerenders=reruns, fit=True,
                    engine="tiled" if solver.use_tiled else "golden")

    def next_counted(self) -> bool:
        return True

    def position(self) -> int:
        return 0

    def shape(self) -> Dict:
        mpm = self.sc.mpm
        r = self.cfg["render"]["resolution"]
        return dict(particles=int(self.solver.state.x.shape[0]),
                    n_grid=mpm.n_grid, substeps=mpm.steps_per_frame,
                    width=r, height=r, splats=int(self.su.opacity.shape[0]))

    def counters(self) -> Dict:
        from gsmpm_tpu_torch.sim import tiles

        f = tiles.frame_tiled
        return {"tiles.frame_tiled.captures": f.captures,
                "tiles.frame_tiled.replays": f.replays,
                "tiles.frame_tiled.host_reads": f.host_reads,
                "tiles.frame_tiled.rebuckets": f.rebuckets,
                "frames": self.n_frames, "rerenders": self.reruns}

    def release(self) -> None:
        """Drop the program's state; what the check needs stays."""
        self.solver = self.su = None

    # ------------------------------------------------------------ the check
    def check(self, dtype=torch.float32) -> Dict[str, float]:
        """The compared numbers: each the worst over the kept frames.
        ``dtype`` below float32 makes the reference the control: it then
        stands in the program's place against the float32 reference."""
        cfg = self.cfg
        mc = cfg["sim_config"]["mpm"]
        G, ext = mc["n_grid"], mc["grid_extent"]
        dx = ext / G
        dt = mc["substep_dt"]
        n_sub = int(round(mc["frame_dt"] / dt))
        bcs = rm.grid_bcs(cfg["grid_bcs"])
        d = self.data
        xyz = d["xyz"].float()
        lo, hi = (torch.tensor(v, device=xyz.device) for v in mc["sim_area"])
        idx = torch.nonzero(torch.all((xyz >= lo) & (xyz <= hi), 1)).squeeze(1)
        gx, centre, s = rm.to_grid(xyz[idx], ext)
        gcov = rm.scene_cov6(d["scaling"][idx], d["rotation"][idx]) * s * s
        vol = rm.particle_volume(gx, G, ext)
        start = self.start
        if dtype != torch.float32:   # the control's own set-up
            xc = xyz.to(dtype)[idx]
            sx, _, sc = rm.to_grid(xc, ext)
            start = dict(x=sx.float(), vol=rm.particle_volume(sx, G, ext)
                         .float(), init_cov=(rm.scene_cov6(
                             d["scaling"][idx].to(dtype),
                             d["rotation"][idx].to(dtype)) * sc * sc).float())
        out = dict(
            start_x=float((start["x"] - gx).abs().max() / dx),
            start_vol=float((start["vol"] / vol - 1.0).abs().max()),
            start_cov=float((start["init_cov"] - gcov).abs().max()
                            / gcov.abs().max()))
        # the camera: the upstream modify_cam orbit around grid point
        # (0.5, 0.5, 0.5), the orbit's vertical along grid z
        rc = cfg["render"]
        c = ((torch.tensor([0.5, 0.5, 0.5], device=xyz.device) - ext / 2.0)
             / s + centre).cpu().double().numpy()
        cam = rs.orbit_camera(rc["resolution"], rc["resolution"], rc["fov"],
                              *rc["orbit"], c, rs.orbit_frame(
                                  np.array([0.0, 0.0, 1.0])))
        bg = torch.full((3,), 1.0 if cfg["sim_config"]["render"].get(
            "white_background") else 0.0, device=xyz.device)
        opac = torch.sigmoid(d["opacity"][idx]).reshape(-1)
        shs = torch.cat([d["features_dc"], d["features_rest"]], 1)[idx]
        logE = torch.full_like(opac, float(np.log10(mc["E"])))
        y = torch.full_like(opac, float(-np.log(0.49 / mc["nu"] - 1.0)))
        mu, lam = rm.mu_lam(logE, y)
        db = rs.depth_bits_for(cam)
        worst = dict(x=0.0, F=0.0, cov=0.0, image=0.0)
        for k in self.kept:
            pre = {n: t.to(dtype) for n, t in k["pre"].items()}
            with torch.no_grad():
                st = rm.run(pre, mu.to(dtype), lam.to(dtype), self.law,
                            mc["gravity"], dt, n_sub, G, ext, bcs)
                cov = rm.covariance(st["F"], pre["init_cov"])
                wx, wcov = rm.to_world(st["x"], cov, s.to(dtype),
                                       centre.to(dtype), ext)
                img = rs.image(wx, wcov, opac.to(dtype), shs.to(dtype), cam,
                               bg.to(dtype), depth_bits=db)
            if dtype != torch.float32:   # the control against float32
                with torch.no_grad():
                    st32 = rm.run({n: t.float() for n, t in k["pre"].items()},
                                  mu, lam, self.law, mc["gravity"], dt,
                                  n_sub, G, ext, bcs)
                    cov32 = rm.covariance(st32["F"], k["pre"]["init_cov"])
                    wx32, wcov32 = rm.to_world(st32["x"], cov32, s, centre,
                                               ext)
                    img32 = rs.image(wx32, wcov32, opac, shs, cam, bg,
                                     depth_bits=db)
                prog = dict(x=st["x"].float(), F=st["F"].float(),
                            cov=cov.float(), image=img.float().cpu().numpy())
                st, cov, img = st32, cov32, img32
            else:
                prog = k
            ref_cov = cov.float()
            gaps = dict(
                x=float((prog["x"] - st["x"].float()).abs().max() / dx),
                F=float((prog["F"] - st["F"].float()).abs().max()),
                cov=float((prog["cov"] - ref_cov).abs().max()
                          / ref_cov.abs().max()),
                image=float(np.abs(prog["image"]
                                   - img.float().cpu().numpy()).mean()))
            if k.get("n_dropped", 0):
                gaps["image"] = float("inf")
            for n, v in gaps.items():
                worst[n] = max(worst[n], v) if np.isfinite(v) else float("inf")
        out.update({f"frame_{n}": v for n, v in worst.items()})
        out["frames_checked"] = float(len(self.kept))
        return out
