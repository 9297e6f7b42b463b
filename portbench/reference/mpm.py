"""Plain MLS-MPM on a dense grid, the reference that the simulation is held to.

The semantics are those of the upstream solver
(ranrandy/gaussian-splatting-mpm, ``mpm_solver/utils.py``: p2g,
grid_normalization_and_gravity, g2p; the boundary conditions of
``boundary_conditions.py`` and ``collider.py``):
quadratic B-spline weights over the 3 x 3 x 3 stencil, APIC momentum, the
stress impulse -dt V sigma grad w, grid velocity = momentum / mass + dt g,
the grid boundary conditions, then the gather of velocity, APIC C and grad v,
advection and F_trial = (I + dt grad v) F.  Stencil nodes are clamped to the
grid.  The stress law is found by name in ``portbench/reference/laws/``:
one file a material of the simulation path (``jelly.py``) and one for the
fitting path (``fitting.py``); a later material adds its file.

Plain torch, written from the equations; it imports nothing of the program.
Every function computes in the dtype of its inputs, so the same code run on
bfloat16 inputs is the lower-precision control.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.utils.checkpoint

State = Dict[str, torch.Tensor]

_OFFS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


def mu_lam(logE: torch.Tensor, y: torch.Tensor):
    """E = 10^logE, nu = 0.49 sigmoid(y) -> the Lame parameters."""
    E = torch.pow(10.0, logE)
    nu = 0.49 / (1.0 + torch.exp(-y))
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sym_from6(c: torch.Tensor) -> torch.Tensor:
    """(N, 6) [xx, xy, xz, yy, yz, zz] -> (N, 3, 3)."""
    xx, xy, xz, yy, yz, zz = c.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def to6(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1],
                        m[:, 1, 2], m[:, 2, 2]], -1)


def scene_cov6(log_scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """3DGS covariance R S S^T R^T of raw log-scales and quaternions."""
    L = quat_rotmat(quat) * torch.exp(log_scale)[:, None, :]
    return to6(L @ L.transpose(-1, -2))


def to_grid(xyz: torch.Tensor, extent: float, pad: float = 0.0):
    """The scene's bounding box (widened by pad) centred in [0, extent]^3:
    (grid positions, centre (3,), scale ())."""
    lo = xyz.min(0).values - pad
    hi = xyz.max(0).values + pad
    centre = (lo + hi) / 2.0
    s = extent / 2.0 / (hi - lo).max()
    return (xyz - centre) * s + extent / 2.0, centre, s


def to_world(x: torch.Tensor, cov6: torch.Tensor, s, centre, extent: float):
    return (x - extent / 2.0) / s + centre, cov6 / (s * s)


def particle_volume(x: torch.Tensor, n_grid: int, extent: float):
    """dx^3 shared by the particles of each grid cell."""
    dx = extent / n_grid
    cell = torch.clamp(torch.floor(x / dx).long(), 0, n_grid - 1)
    flat = (cell[:, 0] * n_grid + cell[:, 1]) * n_grid + cell[:, 2]
    count = torch.bincount(flat, minlength=n_grid ** 3).to(x.dtype)
    return dx ** 3 / count[flat]


def initial_state(x: torch.Tensor, cov6: torch.Tensor, n_grid: int,
                  extent: float, density: float, v0=None) -> State:
    n = x.shape[0]
    vol = particle_volume(x, n_grid, extent)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(n, 3, 3)
    return dict(
        x=x, v=torch.zeros_like(x) if v0 is None else v0.to(x.dtype),
        C=torch.zeros((n, 3, 3), dtype=x.dtype, device=x.device),
        F=eye.clone(), vol=vol, mass=density * vol, init_cov=cov6)


def surface_collider(point: Sequence[float], normal: Sequence[float],
                     friction: float = 0.0) -> Callable:
    """Half-space collider with friction and the upstream 0.99 damping."""
    n = torch.tensor(normal, dtype=torch.float64)
    n = (n / n.norm()).tolist()

    def apply(gv, pos):
        nt = torch.tensor(n, dtype=gv.dtype, device=gv.device)
        pt = torch.tensor(point, dtype=gv.dtype, device=gv.device)
        below = ((pos - pt) * nt).sum(-1) < 0.0
        vn = (gv * nt).sum(-1)
        vp = gv - torch.clamp_max(vn, 0.0)[:, None] * nt
        speed = torch.linalg.vector_norm(vp, dim=-1)
        fric = (vn < 0.0) & (speed > 1e-20)
        safe = torch.where(speed > 1e-20, speed, torch.ones_like(speed))
        vf = (torch.clamp_min(speed + vn * friction, 0.0)[:, None] * vp
              / safe[:, None])
        new = torch.where(fric[:, None], vf, vp) * 0.99
        return torch.where(below[:, None], new, gv)
    return apply


def box_zero(centre: Sequence[float], half: Sequence[float]) -> Callable:
    """Zero the grid velocity strictly inside an axis-aligned box (the
    upstream sticky ground slab is box_zero((1, .6, 1), (1, .1, 1)))."""
    def apply(gv, pos):
        c = torch.tensor(centre, dtype=gv.dtype, device=gv.device)
        h = torch.tensor(half, dtype=gv.dtype, device=gv.device)
        inside = torch.all(torch.abs(pos - c) < h, dim=-1)
        return torch.where(inside[:, None], torch.zeros_like(gv), gv)
    return apply


def grid_bcs(specs) -> Tuple[Callable, ...]:
    """Grid boundary conditions from a configuration's list:
    {"type": "surface_collider", "point", "normal", "friction"} or
    {"type": "sticky_ground"}, applied in order."""
    out = []
    for s in specs:
        if s["type"] == "surface_collider":
            out.append(surface_collider(s["point"], s["normal"],
                                        s.get("friction", 0.0)))
        elif s["type"] == "sticky_ground":
            out.append(box_zero((1.0, 0.6, 1.0), (1.0, 0.1, 1.0)))
        else:
            raise ValueError(f"unknown boundary condition {s['type']!r}")
    return tuple(out)


def _stencil(x: torch.Tensor, n_grid: int, inv_dx: float):
    """(node ids (N, 27), w (N, 27), grad w (N, 27, 3), node - fx (N, 27, 3)
    in cells)."""
    gp = x * inv_dx
    base = torch.floor(gp - 0.5)
    fx = gp - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                     0.5 * (fx - 0.5) ** 2], -1)               # (N, 3, 3)
    dw = torch.stack([(fx - 1.5) * inv_dx, -2.0 * (fx - 1.0) * inv_dx,
                      (fx - 0.5) * inv_dx], -1)
    b = torch.clamp(base.long(), -1, n_grid - 1)
    o = torch.tensor(_OFFS, device=x.device)                    # (27, 3)
    node = torch.clamp(b[:, None, :] + o[None], 0, n_grid - 1)  # (N, 27, 3)
    ids = (node[..., 0] * n_grid + node[..., 1]) * n_grid + node[..., 2]
    wa = [w[:, a, o[:, a]] for a in range(3)]                   # 3 x (N, 27)
    da = [dw[:, a, o[:, a]] for a in range(3)]
    wt = wa[0] * wa[1] * wa[2]
    gw = torch.stack([da[0] * wa[1] * wa[2], wa[0] * da[1] * wa[2],
                      wa[0] * wa[1] * da[2]], -1)
    dpos = o[None].to(x.dtype) - fx[:, None, :]
    return ids, wt, gw, dpos


def law(name: str) -> Callable:
    """The stress law ``laws/<name>.py``: its ``stress(F, mu, lam)`` gives
    (the elastic F it keeps, the stress).  A name with no file is refused:
    no other law stands in for it."""
    path = Path(__file__).resolve().parent / "laws" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no reference stress law for {name!r} "
                         f"(portbench/reference/laws/{name}.py)")
    spec = importlib.util.spec_from_file_location(
        f"portbench_law_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.stress


def substep(st: State, mu, lam, stress: Callable, gravity, dt: float,
            n_grid: int, extent: float, bcs: Sequence[Callable]) -> State:
    """One substep: stress, P2G, grid update and boundary conditions, G2P.
    ``stress`` is a law of ``law``."""
    x, v, C = st["x"], st["v"], st["C"]
    dx = extent / n_grid
    inv_dx = n_grid / extent
    F, sig = stress(st["F"], mu, lam)
    ids, w, gw, dpos = _stencil(x, n_grid, inv_dx)
    wm = w * st["mass"][:, None]
    apic = torch.einsum("nrc,nkc->nkr", C, dpos * dx)
    force = torch.einsum("nrc,nkc->nkr", sig, gw)
    mom = (wm[..., None] * (v[:, None, :] + apic)
           - dt * st["vol"][:, None, None] * force)
    vals = torch.cat([wm[..., None], mom], -1).reshape(-1, 4)
    grid = torch.zeros((n_grid ** 3, 4), dtype=x.dtype, device=x.device)
    grid = grid.index_add(0, ids.reshape(-1), vals)
    m = grid[:, 0]
    has = m > 1e-15
    g = torch.tensor(gravity, dtype=x.dtype, device=x.device)
    safe_m = torch.where(has, m, torch.ones_like(m))
    gv = torch.where(has[:, None], grid[:, 1:] / safe_m[:, None] + dt * g,
                     torch.zeros_like(grid[:, 1:]))
    if bcs:
        ar = torch.arange(n_grid, device=x.device, dtype=x.dtype)
        pos = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                          -1).reshape(-1, 3) * dx
        for bc in bcs:
            gv = bc(gv, pos)
    gvp = gv[ids.reshape(-1)].reshape(ids.shape + (3,))          # (N, 27, 3)
    new_v = (w[..., None] * gvp).sum(1)
    new_C = torch.einsum("nk,nkr,nkc->nrc", w, gvp, dpos) * (4.0 * inv_dx)
    grad_v = torch.einsum("nkr,nkc->nrc", gvp, gw)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return dict(st, x=x + dt * new_v, v=new_v, C=new_C,
                F=(eye + dt * grad_v) @ F)


def run(st: State, mu, lam, stress: Callable, gravity, dt: float, n: int,
        n_grid: int, extent: float, bcs, checkpoint: bool = False) -> State:
    """n substeps under the law ``stress``; with ``checkpoint`` each is
    recomputed in the backward."""
    keys = ("x", "v", "C", "F")
    for _ in range(n):
        if checkpoint:
            def step(x, v, C, F, mu, lam, _st=st):
                out = substep(dict(_st, x=x, v=v, C=C, F=F), mu, lam,
                              stress, gravity, dt, n_grid, extent, bcs)
                return tuple(out[k] for k in keys)
            out = torch.utils.checkpoint.checkpoint(
                step, *(st[k] for k in keys), mu, lam, use_reentrant=False)
            st = dict(st, **dict(zip(keys, out)))
        else:
            st = substep(st, mu, lam, stress, gravity, dt, n_grid, extent,
                         bcs)
    return st


def covariance(F: torch.Tensor, init_cov6: torch.Tensor) -> torch.Tensor:
    """cov = F Sigma0 F^T, 6-packed."""
    return to6(F @ sym_from6(init_cov6) @ F.transpose(-1, -2))
