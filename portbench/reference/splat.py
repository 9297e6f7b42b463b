"""Plain 3D Gaussian splatting, the reference that every rendered image is
held to.

The semantics are the 3DGS rasterizer's (Kerbl et al. 2023, the
``diff-gaussian-rasterization`` forward): EWA projection with the view-space
clamp at 1.3 tan(fov / 2) and the +0.3 low-pass, radius ceil(3 sqrt(lambda
max)), colours from degree-3 spherical harmonics + 0.5 clamped at 0, then per
pixel block every splat whose radius rectangle meets the block, front to
back: alpha = min(0.99, opacity exp(-q / 2)), skipped below 1/255, and a
pixel stops at the first splat that would take its transmittance below
1e-4; the background fills what is left.  The blocks are 64 pixels wide and
the depth order is that of the float32 depth's top bits (ties by gaussian
index), as the configuration states it for this system.

Plain torch, written from the equations; it imports nothing of the program.
``render`` is differentiable (each chunk of a block's splats is recomputed
in the backward); it computes in the dtype of its inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


# ---------------------------------------------------------------- cameras

def make_camera(width: int, height: int, fovx: float, fovy: float, R_c2w,
                position, znear: float = 0.01, zfar: float = 100.0) -> Dict:
    """Column-vector world-to-view and full projection (OpenGL-style
    perspective, z mapped to [0, zfar / (zfar - znear)])."""
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(R_c2w, np.float64)
    c2w[:3, 3] = np.asarray(position, np.float64)
    view = np.linalg.inv(c2w).astype(np.float32)
    tx, ty = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return dict(view=view, full_proj=(P @ view).astype(np.float32),
                campos=np.asarray(position, np.float32), width=int(width),
                height=int(height), fovx=float(fovx), fovy=float(fovy))


def look_rotation(forward, down) -> np.ndarray:
    """Camera-to-world rotation whose z looks along ``forward`` and whose y
    points as near ``down`` as it can."""
    z = forward / np.linalg.norm(forward)
    y = down - np.dot(down, z) * z
    y = y / np.linalg.norm(y)
    return np.column_stack([np.cross(y, z), y, z])


def orbit_camera(width: int, height: int, fov: float, azimuth: float,
                 elevation: float, radius: float, centre, frame) -> Dict:
    """A camera on the sphere around ``centre`` in the orbit frame (h1, h2,
    vertical) columns, looking at the centre, its y along -vertical."""
    az, el = np.deg2rad(azimuth), np.deg2rad(elevation)
    local = np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                      np.sin(el)]) * radius
    pos = centre + frame @ local
    return make_camera(width, height, fov, fov,
                       look_rotation(centre - pos, -frame[:, 2]), pos)


def orbit_frame(up) -> np.ndarray:
    """(h1, h2, vertical) columns: an orthonormal frame around ``up``."""
    v = up / np.linalg.norm(up)
    h1 = np.array([1.0, 1.0, 1.0])
    if abs(np.dot(h1, v)) < 0.01:
        h1 = np.array([0.72, 0.37, -0.67])
    h1 = h1 - np.dot(h1, v) * v
    h1 = h1 / np.linalg.norm(h1)
    return np.column_stack([h1, np.cross(h1, v), v])


def ring_cameras(centre, resolution: int, n: int = 8,
                 fov: float = 0.7) -> list:
    """n cameras on a ring of radius 3 around ``centre``, a quarter of the
    radius above it, y down."""
    cams = []
    for az in range(0, 360, 360 // n):
        a = np.deg2rad(az)
        pos = centre + 3.0 * np.array([np.cos(a), 0.25, np.sin(a)])
        cams.append(make_camera(resolution, resolution, fov, fov,
                                look_rotation(centre - pos,
                                              np.array([0.0, -1.0, 0.0])),
                                pos))
    return cams


# ---------------------------------------------------------------- projection

def _sh_basis(d: torch.Tensor):
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return [-C1 * y, C1 * z, -C1 * x,
            C2[0] * x * y, C2[1] * y * z, C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z, C2[4] * (xx - yy),
            C3[0] * y * (3.0 * xx - yy), C3[1] * x * y * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy)]


def project(means: torch.Tensor, cov6: torch.Tensor, opacity: torch.Tensor,
            shs: torch.Tensor, cam: Dict, sh_degree: int = 3,
            z_near: float = 0.2) -> Dict[str, torch.Tensor]:
    """Screen-space splats: pixel centre, conic, depth, radius, colour, log
    opacity (-1e30 where the splat is culled)."""
    dt = means.dtype
    V = torch.tensor(cam["view"], dtype=dt, device=means.device)
    P = torch.tensor(cam["full_proj"], dtype=dt, device=means.device)
    mh = torch.cat([means, torch.ones_like(means[:, :1])], 1)
    t = mh @ V[:3].T
    ph = mh @ P.T
    depth = t[:, 2]
    in_front = depth > z_near
    inv_w = 1.0 / (ph[:, 3] + 1e-7)
    W, H = cam["width"], cam["height"]
    px = ((ph[:, 0] * inv_w + 1.0) * W - 1.0) * 0.5
    py = ((ph[:, 1] * inv_w + 1.0) * H - 1.0) * 0.5
    tanx, tany = math.tan(cam["fovx"] / 2), math.tan(cam["fovy"] / 2)
    fx, fy = W / (2.0 * tanx), H / (2.0 * tany)
    z = torch.where(in_front, depth, torch.ones_like(depth))
    tx = torch.clamp(t[:, 0] / z, -1.3 * tanx, 1.3 * tanx) * z
    ty = torch.clamp(t[:, 1] / z, -1.3 * tany, 1.3 * tany) * z
    zeros = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zeros, -fx * tx / (z * z)], -1),
                     torch.stack([zeros, fy / z, -fy * ty / (z * z)], -1)],
                    -2)                                          # (N, 2, 3)
    T = J @ V[:3, :3]
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    S = torch.stack([torch.stack([xx, xy, xz], -1),
                     torch.stack([xy, yy, yz], -1),
                     torch.stack([xz, yz, zz], -1)], -2)
    c2 = T @ S @ T.transpose(-1, -2)
    a, b, c = c2[:, 0, 0] + 0.3, c2[:, 0, 1], c2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det > 0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      zeros)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    campos = torch.tensor(cam["campos"], dtype=dt, device=means.device)
    d = means - campos
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), 1e-9)
    basis = _sh_basis(d)[: (sh_degree + 1) ** 2 - 1]
    col = C0 * shs[:, 0]
    for k, bk in enumerate(basis):
        col = col + bk[:, None] * shs[:, k + 1]
    col = torch.clamp_min(col + 0.5, 0.0)
    valid = in_front & ok & (radius > 0) & (opacity > 0)
    logo = torch.where(valid, torch.log(torch.clamp_min(opacity, 1e-38)),
                       torch.full_like(opacity, -1e30))
    return dict(px=px, py=py, a=c * inv, b=-b * inv, c=a * inv, depth=depth,
                radius=radius, color=col, logo=logo, valid=valid)


# ---------------------------------------------------------------- blending

def _chunk(cand, T, rgb, done, pxl, pyl, t_min, alpha_min):
    """Composite one depth-ordered chunk of splats over a block's pixels."""
    px, py, a, b, c, logo, col = cand
    dx = pxl[None, :] - px[:, None]
    dy = pyl[None, :] - py[:, None]
    power = logo[:, None] - 0.5 * (a[:, None] * dx * dx
                                   + c[:, None] * dy * dy) \
        - b[:, None] * dx * dy
    alpha = torch.clamp_max(torch.exp(power), 0.99)
    alpha = torch.where((power <= logo[:, None]) & (alpha >= alpha_min),
                        alpha, torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    cp = torch.cumprod(one_m, 0)
    T_before = T[None] * torch.cat([torch.ones_like(cp[:1]), cp[:-1]], 0)
    T_after = T_before * one_m
    contrib = ~done[None] & (T_after >= t_min)
    w = torch.where(contrib, T_before * alpha, torch.zeros_like(alpha))
    rgb = rgb + col.T @ w
    keep = torch.where(contrib, one_m, torch.ones_like(one_m))
    T = T * torch.prod(keep, 0)
    done = done | torch.any(T_after < t_min, 0)
    return T, rgb, done


def depth_key(depth: torch.Tensor, depth_bits: int,
              z_near: float = 0.2) -> torch.Tensor:
    """The float32 depth's top ``depth_bits`` bits (its order, quantized)."""
    d = torch.clamp_min(depth.detach().float(), z_near)
    return (d.view(torch.int32) >> (31 - depth_bits)).long()


def render(pre: Dict[str, torch.Tensor], cam: Dict, bg: torch.Tensor,
           block: int = 64, depth_bits: int = 23, t_min: float = 1e-4,
           alpha_min: float = 1.0 / 255.0, chunk: int = 512,
           grad: bool = False) -> torch.Tensor:
    """(H, W, 3) image of projected splats (``project``).  With ``grad``
    the image is differentiable in ``pre``'s float planes."""
    W, H = cam["width"], cam["height"]
    B = block
    nbx, nby = -(-W // B), -(-H // B)
    dev, dt = pre["px"].device, pre["px"].dtype
    r = pre["radius"].detach()

    def span(p, nb):
        p = p.detach()
        hi = torch.floor((p + r + 0.5) / B)
        lo = torch.ceil((p - r + 0.5) / B) - 1.0
        off = (hi < 0) | (lo > nb - 1)
        return lo.clamp(0, nb - 1).long(), hi.clamp(0, nb - 1).long(), off

    x0, x1, offx = span(pre["px"], nbx)
    y0, y1, offy = span(pre["py"], nby)
    live = pre["valid"] & ~offx & ~offy
    g = torch.nonzero(live).squeeze(1)
    sx, sy = (x1 - x0 + 1)[g], (y1 - y0 + 1)[g]
    n_pairs = sx * sy
    gi = torch.repeat_interleave(g, n_pairs)
    k = torch.arange(int(n_pairs.sum()), device=dev) \
        - torch.repeat_interleave(torch.cumsum(n_pairs, 0) - n_pairs, n_pairs)
    sxi = torch.repeat_interleave(sx, n_pairs)
    tile = (y0[gi] + k // sxi) * nbx + x0[gi] + k % sxi
    n = pre["px"].shape[0]
    key = ((tile * (1 << depth_bits) + depth_key(pre["depth"], depth_bits)[gi])
           * (1 << int(n).bit_length()) + gi)
    order = torch.argsort(key)
    tile, gi = tile[order], gi[order]
    bounds = torch.searchsorted(tile, torch.arange(nbx * nby + 1, device=dev))
    planes = (pre["px"], pre["py"], pre["a"], pre["b"], pre["c"], pre["logo"],
              pre["color"])
    P = B * B
    lx = (torch.arange(P, device=dev) % B).to(dt)
    ly = (torch.arange(P, device=dev) // B).to(dt)
    out = []
    for t in range(nbx * nby):
        ox, oy = float((t % nbx) * B), float((t // nbx) * B)
        T = torch.ones(P, dtype=dt, device=dev)
        rgb = torch.zeros((3, P), dtype=dt, device=dev)
        done = torch.zeros(P, dtype=torch.bool, device=dev)
        lo, hi = int(bounds[t]), int(bounds[t + 1])
        for s in range(lo, hi, chunk):
            idx = gi[s:min(s + chunk, hi)]
            cand = tuple(p[idx] for p in planes)
            if grad:
                T, rgb, done = torch.utils.checkpoint.checkpoint(
                    _chunk, cand, T, rgb, done, lx + ox, ly + oy, t_min,
                    alpha_min, use_reentrant=False)
            else:
                T, rgb, done = _chunk(cand, T, rgb, done, lx + ox, ly + oy,
                                      t_min, alpha_min)
            if bool(done.all()):
                break
        out.append(rgb + T[None] * bg[:, None].to(dt))
    img = torch.stack(out).reshape(nby, nbx, 3, B, B)
    img = img.permute(0, 3, 1, 4, 2).reshape(nby * B, nbx * B, 3)
    return img[:H, :W]


def image(means, cov6, opacity, shs, cam, bg, sh_degree: int = 3,
          depth_bits: int = 23, grad: bool = False,
          chunk: int = 512) -> torch.Tensor:
    """project + render."""
    return render(project(means, cov6, opacity, shs, cam, sh_degree), cam,
                  bg, depth_bits=depth_bits, grad=grad, chunk=chunk)


def depth_bits_for(cam: Dict, block: int = 64, keys: Optional[int] = None):
    """The depth bits that leave room for ``keys`` tile keys (by default one
    per 64-pixel block) in a 31-bit sort key."""
    if keys is None:
        keys = (-(-cam["width"] // block)) * (-(-cam["height"] // block))
    return 31 - int(keys).bit_length()
