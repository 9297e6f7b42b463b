"""Tile-based 3D Gaussian splatting renderer: the stream path's front end.

Port of the parts of gsmpm_tpu/render/renderer.py that the drop-free stream
render uses: ``RasterConfig``, ``Preprocessed``, ``preprocess`` (EWA
projection + SH colors, planes layout), ``block_origins``,
``_tile_interval``, ``_raw_planes_nosentinel``, ``assemble_blocks``,
``render_with_aux`` and the stream branch of ``bump_caps_for_dropfree``.
The stream rasterizer is the only path: the windowed (dup-sort / two-tier)
paths and the XLA golden blend are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gsmpm_tpu_torch.render.camera import Camera
from gsmpm_tpu_torch.render.sh import C0, band_basis


class RasterConfig(NamedTuple):
    block: int = 64  # pixel block edge for binning/blending
    t_min: float = 1e-4  # transmittance early-stop (parity with CUDA)
    alpha_min: float = 1.0 / 255.0
    z_near: float = 0.2  # frustum near cull
    # per-tier gaussian budgets of the sorted-segment stream rasterizer
    # (render/stream_raster.py) for splats whose screen rect spans
    # >4 / >16 / >64 fine tiles
    stream_g2: int = 2048
    stream_g3: int = 256
    stream_g4: int = 32


class Preprocessed(NamedTuple):
    """Planes layout: every field is (N,)."""

    pix_x: torch.Tensor
    pix_y: torch.Tensor
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    color_r: torch.Tensor
    color_g: torch.Tensor
    color_b: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor  # bool


def _eval_sh_planes(shs, dx, dy, dz, sh_degree: int):
    """SH -> RGB on planes, term for term as render/sh.py."""
    shp = shs.permute(1, 2, 0)  # (K, 3, N)
    d = torch.stack([dx, dy, dz], dim=-1)
    basis_terms = []
    for l in range(1, sh_degree + 1):
        basis = band_basis(d, l)  # (N, 2l+1)
        basis_terms.extend(basis[:, t] for t in range(2 * l + 1))
    cols = []
    for c in range(3):
        acc = C0 * shp[0, c]
        for t, bt in enumerate(basis_terms):
            acc = acc + bt * shp[1 + t, c]
        cols.append(acc)
    return cols


def preprocess(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacity: torch.Tensor,
    shs: Optional[torch.Tensor],
    camera: Camera,
    sh_degree: int,
    cfg: RasterConfig,
    colors_precomp: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Project gaussians to screen space (EWA splatting), planes layout.

    The 2D covariance gets the rasterizer's view-space clamp and +0.3
    low-pass; radius = ceil(3 sqrt(lambda_max)).
    """
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = camera.view.tolist()
    P = camera.full_proj.tolist()

    t = [V[r][0] * mx + V[r][1] * my + V[r][2] * mz + V[r][3] for r in range(3)]
    depth = t[2]
    in_front = depth > cfg.z_near

    ph = [P[r][0] * mx + P[r][1] * my + P[r][2] * mz + P[r][3] for r in range(2)]
    pw = P[3][0] * mx + P[3][1] * my + P[3][2] * mz + P[3][3]
    inv_w = 1.0 / (pw + 1e-7)
    pix_x = ((ph[0] * inv_w + 1.0) * camera.width - 1.0) * 0.5
    pix_y = ((ph[1] * inv_w + 1.0) * camera.height - 1.0) * 0.5

    fx, fy = camera.focal_x, camera.focal_y
    limx, limy = 1.3 * camera.tanfovx, 1.3 * camera.tanfovy
    z = torch.where(in_front, depth, 1.0)
    tx = torch.clamp(t[0] / z, -limx, limx) * z
    ty = torch.clamp(t[1] / z, -limy, limy) * z
    J00 = fx / z
    J02 = -fx * tx / (z * z)
    J11 = fy / z
    J12 = -fy * ty / (z * z)
    T0 = [J00 * V[0][c] + J02 * V[2][c] for c in range(3)]
    T1 = [J11 * V[1][c] + J12 * V[2][c] for c in range(3)]

    s00, s01, s02 = cov6[:, 0], cov6[:, 1], cov6[:, 2]
    s11, s12, s22 = cov6[:, 3], cov6[:, 4], cov6[:, 5]

    def quad(u, w):
        return (
            u[0] * w[0] * s00 + u[1] * w[1] * s11 + u[2] * w[2] * s22
            + (u[0] * w[1] + u[1] * w[0]) * s01
            + (u[0] * w[2] + u[2] * w[0]) * s02
            + (u[1] * w[2] + u[2] * w[1]) * s12
        )

    a = quad(T0, T0) + 0.3
    b = quad(T0, T1)
    c = quad(T1, T1) + 0.3

    det = a * c - b * b
    det_ok = det > 0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic_a = c * inv_det
    conic_b = -b * inv_det
    conic_c = a * inv_det

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    if colors_precomp is not None:
        col = [colors_precomp[:, i] for i in range(3)]
    else:
        campos = camera.campos.tolist()
        dx = mx - campos[0]
        dy = my - campos[1]
        dz = mz - campos[2]
        inv_n = 1.0 / torch.clamp_min(torch.sqrt(dx * dx + dy * dy + dz * dz),
                                      1e-9)
        col = _eval_sh_planes(shs, dx * inv_n, dy * inv_n, dz * inv_n,
                              sh_degree)
        col = [torch.clamp_min(ci + 0.5, 0.0) for ci in col]

    valid = in_front & det_ok & (radius > 0)
    return Preprocessed(
        pix_x=pix_x, pix_y=pix_y,
        conic_a=conic_a, conic_b=conic_b, conic_c=conic_c,
        depth=depth, radius=radius,
        color_r=col[0], color_g=col[1], color_b=col[2],
        opacity=opacity.reshape(-1), valid=valid,
    )


def block_origins(camera: Camera, cfg: RasterConfig, device="cpu"):
    """Pixel-block origins covering the image, row-major over y.

    Returns (origins (nb,2) [x,y], nbx, nby).
    """
    B = cfg.block
    nbx = -(-camera.width // B)
    nby = -(-camera.height // B)
    bx = torch.arange(nbx, dtype=torch.float32, device=device) * B
    by = torch.arange(nby, dtype=torch.float32, device=device) * B
    origins = torch.stack([bx.repeat(nby), by.repeat_interleave(nbx)], dim=-1)
    return origins, nbx, nby


def _tile_interval(p, r, B, nb):
    """Inclusive tile-index interval [t0, t1] whose blocks intersect p +- r.

    Block t intersects iff t*B - 0.5 <= p + r and p - r <= t*B + B - 0.5,
    i.e. t1 = floor((p + r + 0.5)/B) and t0 = ceil((p - r + 0.5)/B) - 1.
    Returns (t0, t1) clamped to [0, nb-1] plus an ``offscreen`` mask.
    """
    t1u = torch.floor((p + r + 0.5) / B)
    t0u = torch.ceil((p - r + 0.5) / B) - 1.0
    offscreen = (t1u < 0.0) | (t0u > float(nb - 1))
    t0 = torch.clamp(t0u, 0.0, nb - 1).to(torch.int32)
    t1 = torch.clamp(t1u, 0.0, nb - 1).to(torch.int32)
    return t0, t1, offscreen


def _raw_planes_nosentinel(pre: Preprocessed) -> torch.Tensor:
    """(10, N) candidate planes: [pix_x, pix_y, conic_a, conic_b, conic_c,
    log_opa, r, g, b, radius]; invalid gaussians get log_opa = -1e30."""
    logo = torch.where(
        pre.valid & (pre.opacity > 0),
        torch.log(torch.clamp_min(pre.opacity, 1e-38)),
        -1e30,
    )
    return torch.stack([
        pre.pix_x, pre.pix_y, pre.conic_a, pre.conic_b, pre.conic_c,
        logo, pre.color_r, pre.color_g, pre.color_b, pre.radius,
    ])


def assemble_blocks(blocks: torch.Tensor, camera: Camera,
                    cfg: RasterConfig) -> torch.Tensor:
    """(nby*nbx, B, B, 3) row-major blocks -> (H, W, 3) image."""
    B = cfg.block
    nbx = -(-camera.width // B)
    nby = -(-camera.height // B)
    img = (
        blocks.reshape(nby, nbx, B, B, 3)
        .permute(0, 2, 1, 3, 4)
        .reshape(nby * B, nbx * B, 3)
    )
    return img[: camera.height, : camera.width]


def render_with_aux(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacity: torch.Tensor,
    shs: Optional[torch.Tensor],
    camera: Camera,
    bg: torch.Tensor,
    sh_degree: int = 3,
    cfg: RasterConfig = RasterConfig(),
    colors_precomp: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize gaussians with precomputed 3D covariances: (image (H, W, 3),
    n_dropped).

    n_dropped counts candidates beyond the stream tier budgets; the
    reference has no caps, so callers resize and re-render when it is > 0.
    """
    from gsmpm_tpu_torch.render.stream_raster import render_stream

    pre = preprocess(means3d, cov6, opacity, shs, camera, sh_degree, cfg,
                     colors_precomp)
    return render_stream(pre, camera, bg, cfg)


def bump_caps_for_dropfree(
    cfg: RasterConfig,
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
) -> RasterConfig:
    """Resize the stream tier budgets so a re-render of THIS geometry is
    drop-free: measured populations +50%, rounded up to 32, with floors;
    doubles every budget when the measurement already fits."""
    from gsmpm_tpu_torch.render.stream_raster import required_stream_caps

    need = required_stream_caps(means3d, cov6, opacity, camera, cfg)

    def upg(cur, needed, floor):
        return max(cur, floor, -(-int(needed * 1.5) // 32) * 32)

    new = cfg._replace(
        stream_g2=upg(cfg.stream_g2, need["stream_g2"], 256),
        stream_g3=upg(cfg.stream_g3, need["stream_g3"], 64),
        stream_g4=upg(cfg.stream_g4, need["stream_g4"], 16),
    )
    if new == cfg:
        # the overflow came from a pose this measurement doesn't see
        new = cfg._replace(
            stream_g2=2 * cfg.stream_g2,
            stream_g3=2 * cfg.stream_g3,
            stream_g4=2 * cfg.stream_g4,
        )
    return new
