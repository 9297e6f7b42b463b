"""The identify loop: apps.identify's iteration on one GPU, frame after frame.

Set-up builds the app's ``SystemIdentifier`` on the seeded blob (thrown
down at the configuration's velocity), the 8 ring cameras, the ground truth
of every frame at (E_true, nu_true), the appearance optimizer, and runs
whole iterations (``warmup_iterations``) so that the caps settle and the
fit window's graphs are captured.  A step is one frame of an iteration as
the app runs it: at frame 0 ``reset_state``, ``appearance_step`` on camera
0 and ``reset_state`` again; at frame f > 0 ``fit_frame`` on camera f % 8
against ground-truth frame f; a synchronize after each.

The check follows the program from its own state: for the fit frames
sampled from the seed it keeps the state, parameters and appearance before
the frame and the loss, gradients, update and state the frame made; the
reference recomputes each frame from them (forward through the substeps,
render and loss, autograd back to logE and y, the clipped SGD step).  For
the appearance steps sampled (the mix's ``check_uncounted``) it keeps the
appearance and the Adam state before the step and the loss, gradients and
parameters it made; the reference renders the scene, takes the loss and
its gradients and makes the Adam step from that state.  The stages this
skips are checked on their own: the initial state against the reference's
own set-up, and one ground-truth frame (sampled from the seed) against the
reference's own simulation from its own initial state.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import scenes
from portbench.reference import loss as rl
from portbench.reference import mpm as rm
from portbench.reference import splat as rs

_STATE = ("x", "v", "C", "F", "mass", "vol", "init_cov")
# the appearance step's leaves (SystemIdentifier.make_appearance_optimizer)
_APPEARANCE = ("xyz", "features_dc", "features_rest", "opacity", "scaling")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
_NOUGHT = 1e-3


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
        self.app_kept: List[Dict] = []
        rng = np.random.default_rng(int(seed) % (1 << 63))
        self.gt_check = int(rng.integers(1, cfg["fit"]["frames"]))
        # a cycle of steps is an iteration: step 0 of each is not a fit
        self.cycle = int(cfg["fit"]["frames"])
        # the fitting path's law, whatever the material
        self.law = rm.law("fitting")

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from gsmpm_tpu_torch.apps.identify import make_ring_cameras
        from gsmpm_tpu_torch.config import MPMConfig
        from gsmpm_tpu_torch.models.gaussians import GaussianScene
        from gsmpm_tpu_torch.render.renderer import RasterConfig
        from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier
        from gsmpm_tpu_torch.sim import tiles

        cfg, fc = self.cfg, self.cfg["fit"]
        self.tiles = tiles
        self.data = scenes.make(cfg["scene"], self.seed, self.dev)
        scene = GaussianScene(**self.data,
                              sh_degree=cfg["scene"].get("sh_degree", 3))
        n = scene.num_gaussians
        init_v = torch.tensor(fc["velocity"], dtype=torch.float32,
                              device=self.dev)[None, :].repeat(n, 1)
        mpm_cfg = MPMConfig(**cfg["mpm"], fitting=True)
        rk = dict(self.mix["raster"])
        if "k_block" in rk:
            rk["k_block"] = min(rk["k_block"], n)
        fit_cfg = FitConfig(substeps_per_frame=fc["substeps"],
                            frame_dt=fc["frame_dt"], lr_logE=fc["lr_logE"],
                            lr_y=fc["lr_y"], grad_clip=fc["grad_clip"],
                            world_pad=fc["world_pad"], tie_params=True)
        ident = SystemIdentifier(
            scene, mpm_cfg, init_velocity=init_v,
            raster_cfg=RasterConfig(**rk),
            fit_cfg=fit_cfg, bg=torch.ones(3, device=self.dev))
        # the engine the traffic names (the CUDA default; on the CPU its
        # plain twins)
        ident._sim_engine = self.mix["engine"]
        self.ident = ident
        self.cams = make_ring_cameras(scene, fc["resolution"])
        s0 = ident.reset_state()
        self.start = {k: getattr(s0, k).clone() for k in ("x", "vol",
                                                          "init_cov")}
        self.gt = ident.generate_ground_truth(fc["E_true"], fc["nu_true"],
                                              self.cams, fc["frames"])
        self.gt_kept = self.gt[self.gt_check].clone()
        self.opt, self.params = ident.make_appearance_optimizer()
        self.fid, self.state, self.t = 0, None, 0.0
        self.n_steps = 0
        for _ in range(int(self.mix.get("warmup_iterations", 1))
                       * fc["frames"]):
            self.step(keep=False)

    # ------------------------------------------------------------ a step
    def step(self, keep: bool) -> Dict:
        ident, fc, span = self.ident, self.cfg["fit"], self.span
        fid = self.fid
        counter = self.tiles.run_substeps_tiled_fitting
        replays0 = counter.replays
        rebuilds0 = ident._total_rebuilds
        t0 = time.perf_counter()
        if fid == 0:
            pre = self._appearance_before() if keep else None
            with span("appearance"):
                self.state = ident.reset_state()
                app_loss = ident.appearance_step(self.opt, self.params,
                                                 camera=self.cams[0],
                                                 gt_image=self.gt[0])
                self.state, self.t = ident.reset_state(), 0.0
                _sync(self.dev)
            if keep:
                self.app_kept.append(dict(
                    pre=pre, loss=float(app_loss),
                    grads={k: self.params[k].grad.clone()
                           for k in _APPEARANCE},
                    new={k: self.params[k].detach().clone()
                         for k in _APPEARANCE}))
            loss, nd = None, 0
        else:
            cam = self.cams[fid % len(self.cams)]
            if keep:
                sc = ident.scene
                pre = dict(
                    state={k: getattr(self.state, k).clone() for k in _STATE},
                    logE=float(ident.model.logE[0]), y=float(ident.model.y[0]),
                    xyz=sc.xyz.clone(), opacity=sc.opacity.clone(),
                    shs=torch.cat([sc.features_dc, sc.features_rest],
                                  1).clone(),
                    gt=self.gt[fid].clone(), cam=fid % len(self.cams),
                    frame=fid)
            with span("fit"):
                loss, self.state, self.t, img = ident.fit_frame(
                    self.state, self.t, cam, self.gt[fid])
                _sync(self.dev)
            nd = ident.n_dropped_last
            if keep:
                g_logE, g_y = ident.last_grads
                fin = [float(torch.where(torch.isfinite(g), g, 0.0).sum())
                       for g in (g_logE, g_y)]
                self.kept.append(dict(
                    pre=pre, loss=float(loss), grads=fin,
                    new=[float(ident.model.logE[0]), float(ident.model.y[0])],
                    x=self.state.x.clone(), image=img.clone(),
                    n_dropped=nd))
        t1 = time.perf_counter()
        self.fid = (fid + 1) % fc["frames"]
        self.n_steps += 1
        return dict(s=t1 - t0, fit=fid > 0, frame=fid,
                    loss=None if loss is None else float(loss), n_dropped=nd,
                    replays=counter.replays - replays0,
                    rebuilds=ident._total_rebuilds - rebuilds0,
                    engine=ident.sim_engine)

    def _appearance_before(self) -> Dict:
        """The appearance, the Adam state of each leaf and the target
        before an appearance step."""
        groups = {id(g["params"][0]): g for g in self.opt.param_groups}
        adam = {}
        for k in _APPEARANCE:
            leaf = self.params[k]
            g, st = groups[id(leaf)], self.opt.state.get(leaf, {})
            adam[k] = dict(
                lr=float(g["lr"]), betas=tuple(g["betas"]), eps=float(g["eps"]),
                step=float(st["step"]) if "step" in st else 0.0,
                m=st["exp_avg"].clone() if "exp_avg" in st else None,
                v=st["exp_avg_sq"].clone() if "exp_avg_sq" in st else None)
        return dict(leaves={k: self.params[k].detach().clone()
                            for k in _APPEARANCE},
                    rotation=self.ident.scene.rotation.clone(), adam=adam,
                    gt=self.gt[0].clone())

    def next_counted(self) -> bool:
        return self.fid != 0

    def position(self) -> int:
        """The next step's frame in the iteration."""
        return self.fid

    def shape(self) -> Dict:
        fc = self.cfg["fit"]
        return dict(particles=int(self.ident.scene.num_gaussians),
                    n_grid=self.cfg["mpm"]["n_grid"],
                    substeps=fc["substeps"], width=fc["resolution"],
                    height=fc["resolution"],
                    splats=int(self.ident.scene.num_gaussians))

    def counters(self) -> Dict:
        c = self.tiles.run_substeps_tiled_fitting
        return {"tiles.run_substeps_tiled_fitting.captures": c.captures,
                "tiles.run_substeps_tiled_fitting.replays": c.replays,
                "tiles.run_substeps_tiled_fitting.host_reads": c.host_reads,
                "tiles.run_substeps_tiled_fitting.rebuckets": c.rebuckets,
                "cap_rebuilds": self.ident._total_rebuilds}

    def release(self) -> None:
        self.ident = self.state = self.opt = self.params = None
        self.gt = None

    # ------------------------------------------------------------ the check
    def _setup_ref(self, dtype):
        cfg, fc = self.cfg, self.cfg["fit"]
        mc = cfg["mpm"]
        G, ext = mc["n_grid"], mc["grid_extent"]
        return dict(G=G, ext=ext, dx=ext / G,
                    dt=fc["frame_dt"] / fc["substeps"],
                    n=fc["substeps"], g=mc["gravity"],
                    bcs=rm.grid_bcs(cfg["grid_bcs"]),
                    bg=torch.ones(3, dtype=dtype,
                                  device=self.data["xyz"].device))

    def _frame_ref(self, k: Dict, dtype, p: Dict):
        """(loss, grads, new params, x after) of one kept fit frame."""
        pre = k["pre"]
        st = {n: t.to(dtype) for n, t in pre["state"].items()}
        logE = torch.full(st["mass"].shape, pre["logE"], dtype=dtype,
                          device=st["x"].device, requires_grad=True)
        y = torch.full_like(logE, pre["y"]).requires_grad_(True)
        _, centre, s = rm.to_grid(pre["xyz"].to(dtype), p["ext"],
                                  pad=self.cfg["fit"]["world_pad"])
        cam = self.ref_cams[pre["cam"]]
        with torch.enable_grad():
            mu, lam = rm.mu_lam(logE, y)
            out = rm.run(st, mu, lam, self.law, p["g"], p["dt"], p["n"],
                         p["G"], p["ext"], p["bcs"], checkpoint=True)
            cov = rm.covariance(out["F"], st["init_cov"])
            wx, wcov = rm.to_world(out["x"], cov, s, centre, p["ext"])
            img = rs.image(wx, wcov, torch.sigmoid(pre["opacity"]).reshape(-1)
                           .to(dtype), pre["shs"].to(dtype), cam, p["bg"],
                           depth_bits=rs.depth_bits_for(cam), grad=True)
            loss = rl.photometric(img, pre["gt"].to(dtype))
            g = torch.autograd.grad(loss, (logE, y))
        fc = self.cfg["fit"]
        sums = [float(torch.where(torch.isfinite(gi), gi, 0.0).float().sum())
                for gi in g]
        lrs = (fc["lr_logE"], fc["lr_y"])
        # the clipped SGD step in float32, the parameters' precision
        f32 = np.float32
        new = [float(f32(v) - f32(lr) * f32(np.clip(gs, -fc["grad_clip"],
                                                    fc["grad_clip"])))
               for v, lr, gs in zip((pre["logE"], pre["y"]), lrs, sums)]
        return (float(loss.detach()), sums, new, out["x"].detach().float(),
                img.detach().float())

    def _appearance_ref(self, a: Dict, dtype, p: Dict):
        """(loss, gradients, new leaves) of one kept appearance step: the
        render, loss and gradients in ``dtype``, the Adam step in float32
        (the leaves' precision) from the program's Adam state."""
        pre = a["pre"]
        leaves = {k: pre["leaves"][k].detach().to(dtype).requires_grad_(True)
                  for k in _APPEARANCE}
        cam = self.ref_cams[0]
        with torch.enable_grad():
            cov = rm.scene_cov6(leaves["scaling"], pre["rotation"].to(dtype))
            img = rs.image(leaves["xyz"], cov,
                           torch.sigmoid(leaves["opacity"]).reshape(-1),
                           torch.cat([leaves["features_dc"],
                                      leaves["features_rest"]], 1),
                           cam, p["bg"], depth_bits=rs.depth_bits_for(cam),
                           grad=True)
            loss = rl.photometric(img, pre["gt"].to(dtype))
            grads = torch.autograd.grad(
                loss, [leaves[k] for k in _APPEARANCE], allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                 .detach().float() for k, g in zip(_APPEARANCE, grads)}
        new = {}
        for k in _APPEARANCE:
            ad, g = pre["adam"][k], grads[k]
            b1, b2 = ad["betas"]
            t = ad["step"] + 1.0
            m = (torch.zeros_like(g) if ad["m"] is None else ad["m"])
            v = (torch.zeros_like(g) if ad["v"] is None else ad["v"])
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            denom = v.sqrt() / float(np.sqrt(1.0 - b2 ** t)) + ad["eps"]
            new[k] = pre["leaves"][k] - (ad["lr"] / (1.0 - b1 ** t)) * m / denom
        return float(loss.detach()), grads, new

    def _appearance_gaps(self, a: Dict, prog: Dict, ref) -> Dict[str, float]:
        """The loss's relative gap; by the worst leaf, the gap of the
        gradient's norm and of the change's norm, each against the larger of
        the reference's norm of that leaf and of the median leaf."""
        r_loss, r_grads, r_new = ref
        old = a["pre"]["leaves"]
        gn = {k: float(r_grads[k].norm()) for k in _APPEARANCE}
        gmed = float(np.median(list(gn.values())))
        grad = max(abs(float(prog["grads"][k].float().norm()) - gn[k])
                   / max(gn[k], gmed, 1e-30) for k in _APPEARANCE)
        moved = [k for k in _APPEARANCE if gn[k] >= _NOUGHT * gmed]
        dn = {k: float((r_new[k] - old[k]).norm()) for k in moved}
        dmed = float(np.median(list(dn.values())))
        step = max(abs(float((prog["new"][k] - old[k]).norm()) - dn[k])
                   / max(dn[k], dmed, 1e-30) for k in moved)
        return dict(loss=abs(prog["loss"] - r_loss) / abs(r_loss),
                    grad=grad, step=step)

    def check(self, dtype=torch.float32) -> Dict[str, float]:
        """The compared numbers, each the worst over the kept frames;
        ``dtype`` below float32 makes the reference the control."""
        cfg, fc = self.cfg, self.cfg["fit"]
        d = self.data
        p = self._setup_ref(dtype)
        self.ref_cams = rs.ring_cameras(d["xyz"].mean(0).double().cpu()
                                        .numpy(), fc["resolution"])
        # the start: reset_state's particles against the reference's own
        xyz = d["xyz"].float()
        gx, centre, s = rm.to_grid(xyz, p["ext"], pad=fc["world_pad"])
        gcov = rm.scene_cov6(d["scaling"], d["rotation"]) * s * s
        vol = rm.particle_volume(gx, p["G"], p["ext"])
        start = self.start
        if dtype != torch.float32:   # the control's own set-up
            sx, _, sc = rm.to_grid(xyz.to(dtype), p["ext"],
                                   pad=fc["world_pad"])
            start = dict(x=sx.float(), vol=rm.particle_volume(
                sx, p["G"], p["ext"]).float(), init_cov=(rm.scene_cov6(
                    d["scaling"].to(dtype), d["rotation"].to(dtype))
                    * sc * sc).float())
        out = dict(
            start_x=float((start["x"] - gx).abs().max() / p["dx"]),
            start_vol=float((start["vol"] / vol - 1.0).abs().max()),
            start_cov=float((start["init_cov"] - gcov).abs().max()
                            / gcov.abs().max()))
        # one ground-truth frame from the reference's own initial state
        f = self.gt_check
        with torch.no_grad():
            v0 = torch.tensor(fc["velocity"], device=xyz.device).expand_as(gx)
            st = rm.initial_state(gx, gcov, p["G"], p["ext"],
                                  cfg["mpm"]["density"], v0)
            st = {n: t.to(dtype) for n, t in st.items()}
            logE = torch.full_like(st["mass"], float(np.log10(fc["E_true"])))
            y = torch.full_like(logE, float(-np.log(0.49 / fc["nu_true"] - 1)))
            mu, lam = rm.mu_lam(logE, y)
            st = rm.run(st, mu, lam, self.law, p["g"], p["dt"], f * p["n"],
                        p["G"], p["ext"], p["bcs"])
            cov = rm.covariance(st["F"], st["init_cov"])
            wx, wcov = rm.to_world(st["x"], cov, s.to(dtype),
                                   centre.to(dtype), p["ext"])
            cam = self.ref_cams[f % len(self.ref_cams)]
            gt_ref = rs.image(wx, wcov, torch.sigmoid(d["opacity"]).reshape(-1)
                              .to(dtype), torch.cat([d["features_dc"],
                                                     d["features_rest"]], 1)
                              .to(dtype), cam, p["bg"],
                              depth_bits=rs.depth_bits_for(cam))
        out["gt_image"] = float((self.gt_kept - gt_ref.float()).abs().mean())
        worst = dict(loss=0.0, grad=0.0, step=0.0, x=0.0, image=0.0)
        frames = []
        for k in self.kept:
            r = self._frame_ref(k, torch.float32, self._setup_ref(
                torch.float32))
            if dtype != torch.float32:   # the control against float32
                c = self._frame_ref(k, dtype, p)
                prog = dict(loss=c[0], grads=c[1], new=c[2], x=c[3],
                            image=c[4])
            else:
                prog = k
            lr_loss, g_ref, new_ref, x_ref, img_ref = r
            med = float(np.median([abs(v) for v in g_ref]))
            grad = max(abs(a - b) / max(abs(b), med, 1e-30)
                       for a, b in zip(prog["grads"], g_ref))
            pre = k["pre"]
            d_ref = [nr - o for nr, o in zip(new_ref, (pre["logE"], pre["y"]))]
            d_prog = [np_ - o for np_, o in zip(prog["new"],
                                               (pre["logE"], pre["y"]))]
            # a step is resolved only to 4 float32 spacings of its parameter
            dmed = float(np.median([abs(v) for v in d_ref]))
            floor = [4.0 * float(np.spacing(np.float32(abs(o))))
                     for o in (pre["logE"], pre["y"])]
            step = max(abs(a - b) / max(abs(b), dmed, f)
                       for a, b, f in zip(d_prog, d_ref, floor))
            gaps = dict(loss=abs(prog["loss"] - lr_loss) / abs(lr_loss),
                        grad=grad, step=step,
                        x=float((prog["x"] - x_ref).abs().max() / p["dx"]),
                        image=float((prog["image"] - img_ref).abs().mean()))
            if k.get("n_dropped", 0):
                gaps["loss"] = float("inf")
            for n, v in gaps.items():
                worst[n] = max(worst[n], v) if np.isfinite(v) else float("inf")
            frames.append(dict(frame=pre["frame"], gaps=gaps,
                               loss=[prog["loss"], lr_loss],
                               grads=[prog["grads"], g_ref]))
        out.update({f"fit_{n}": v for n, v in worst.items()})
        out["_frames"] = frames
        app = dict(loss=0.0, grad=0.0, step=0.0)
        for a in self.app_kept:
            ref = self._appearance_ref(a, torch.float32, self._setup_ref(
                torch.float32))
            if dtype != torch.float32:   # the control against float32
                c = self._appearance_ref(a, dtype, p)
                prog = dict(loss=c[0], grads=c[1], new=c[2])
            else:
                prog = a
            for n, v in self._appearance_gaps(a, prog, ref).items():
                app[n] = max(app[n], v) if np.isfinite(v) else float("inf")
        out.update({f"app_{n}": v for n, v in app.items()})
        out["frames_checked"] = float(len(self.kept) + len(self.app_kept))
        return out
