"""Sorted-segment streaming rasterizer: the drop-free render, differentiable.

Port of gsmpm_tpu/render/stream_raster.py.

1. EMISSION: every valid gaussian emits one ``(tile | quantized depth)``
   int32 key per fine tile its screen rect overlaps; rects of <= 4 tiles
   use 4 inline corner slots per gaussian, larger ones draw 16 / 64 / nf
   corner slots from the tier budgets ``RasterConfig.stream_g2/g3/g4``
   (overflow is counted into n_dropped).
2. ONE stable sort of the keys (``torch.sort(stable=True)``, as
   ``lax.sort`` is stable), the 9 geometry planes gathered by its
   permutation: each tile's candidates become the contiguous depth-ordered
   segment ``[bounds[t], bounds[t+1])`` of one (9, L) array.
3. The blend walks each display block's segment front to back: kernel K3
   (csrc/stream_raster.cu) on the GPU, ``stream_blend_ref`` on the CPU.
   The TPU kernel's scalar-prefetch step tables are not needed: each GPU
   block reads its own ``bounds``.
4. The backward walks the same segments back to front, recovering the
   transmittance by division, and emits d(sorted planes) with the F-build
   chain rule applied per slot: kernel K7 on the GPU,
   ``stream_blend_bwd_ref`` on the CPU (``_StreamCore``).  The gathers of
   the emission and the sort are ``index_select``s, whose backward is an
   ``index_add_``, so gradients reach means, covariances, opacities and
   colors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gsmpm_tpu_torch.render.renderer import (
    Preprocessed,
    _raw_planes_nosentinel,
    _tile_interval,
    assemble_blocks,
    block_origins,
    preprocess,
)
from gsmpm_tpu_torch.utils import build
from gsmpm_tpu_torch.utils.spans import span

SENT = 2 ** 31 - 1  # sort key of an unused emission slot
_TWIN_CHUNK = 32    # slots per step of the plain blend twin

# ---------------------------------------------------------------------------
# emission: (tile | depth) keys at the fine level only
# ---------------------------------------------------------------------------


class StreamLevels(NamedTuple):
    fx0: torch.Tensor
    fy0: torch.Tensor
    sx: torch.Tensor  # tile-span width (>= 1)
    area: torch.Tensor  # sx*sy, 0 for invalid
    valid: torch.Tensor
    dq: torch.Tensor  # quantized depth (top bits of the f32, order-preserving)
    nbx: int
    nby: int
    nf: int
    M: int  # 2^depth_bits


def _stream_levels(pre: Preprocessed, camera, cfg) -> StreamLevels:
    B = cfg.block
    _, nbx, nby = block_origins(camera, cfg)
    nf = nbx * nby
    fx0, fx1, offx = _tile_interval(pre.pix_x, pre.radius, B, nbx)
    fy0, fy1, offy = _tile_interval(pre.pix_y, pre.radius, B, nby)
    valid = pre.valid & ~(offx | offy)
    sx = torch.clamp_min(fx1 - fx0 + 1, 1)
    sy = torch.clamp_min(fy1 - fy0 + 1, 1)
    area = torch.where(valid, sx * sy, 0)
    db = 31 - int(nf).bit_length()  # nf * 2^db <= 2^31
    # bit pattern of a positive float32 orders like the float; depth is
    # clamped to z_near > 0, so the arithmetic shift is a logical one
    dq = torch.clamp_min(pre.depth, cfg.z_near).view(torch.int32) >> (31 - db)
    return StreamLevels(fx0, fy0, sx, area, valid, dq, nbx, nby, nf, 1 << db)


# per-gaussian corner budgets of the emission tiers; tier 1 (area <= 4) is
# inline.  tier 4's budget is the full tile count (a whole-screen splat).
_T2_CB = 16
_T3_CB = 64


def _tier_gmap(mask: torch.Tensor, G: int):
    """Compact the masked gaussians into G budget slots.

    Returns (gmap (G,) gaussian index per slot, used (G,) validity).  Masked
    gaussians beyond the budget write to one extra slot that is cut off.
    """
    n = mask.shape[0]
    dev = mask.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    total = torch.sum(mask)
    pos = torch.where(mask & (rank < G), rank, G)
    gmap = torch.zeros((G + 1,), dtype=torch.int64, device=dev)
    gmap[pos] = idx
    used = torch.arange(G, device=dev) < torch.clamp_max(total, G)
    return gmap[:G], used


def _emit_tier(lv: StreamLevels, mask: torch.Tensor, G: int, CB: int):
    """Emission keys for one budgeted tier.

    Returns (keys (G*CB,), gmap (G,), dropped-candidate count).  Slot
    ``g*CB + j`` covers rect corner (j // sx, j % sx) of gaussian gmap[g].
    """
    gmap, used = _tier_gmap(mask, G)
    gfx0 = lv.fx0[gmap][:, None]
    gfy0 = lv.fy0[gmap][:, None]
    gsx = lv.sx[gmap][:, None]
    garea = lv.area[gmap][:, None]
    gdq = lv.dq[gmap][:, None]
    j = torch.arange(CB, dtype=torch.int32, device=mask.device)[None, :]
    dy = j // gsx
    dx = j % gsx
    tile = (gfy0 + dy) * lv.nbx + (gfx0 + dx)
    ok = used[:, None] & (j < garea)
    keys = torch.where(ok, tile * lv.M + gdq, SENT).reshape(-1)
    dropped = torch.sum(torch.where(mask, lv.area, 0)) - torch.sum(ok)
    return keys, gmap, dropped


def stream_emission(pre: Preprocessed, camera, cfg, planes: torch.Tensor):
    """(keys (L,) int32, emis_planes (9, L), n_dropped, levels).

    L = 4N + G2*16 + G3*64 + G4*nf; key order: tier-1 corner-major
    [c0(N) c1(N) c2(N) c3(N)] then the budget tiers.
    """
    lv = _stream_levels(pre, camera, cfg)
    n = pre.pix_x.shape[0]
    t1 = lv.valid & (lv.area <= 4)
    t2 = lv.valid & (lv.area > 4) & (lv.area <= _T2_CB)
    t3 = lv.valid & (lv.area > _T2_CB) & (lv.area <= _T3_CB)
    t4 = lv.valid & (lv.area > _T3_CB)

    keys1 = []
    for j in range(4):
        dy = j // lv.sx
        dx = j % lv.sx
        tile = (lv.fy0 + dy) * lv.nbx + (lv.fx0 + dx)
        ok = t1 & (j < lv.area)
        keys1.append(torch.where(ok, tile * lv.M + lv.dq, SENT))
    keys1 = torch.cat(keys1)
    planes1 = planes.repeat(1, 4)

    G2, G3 = cfg.stream_g2, cfg.stream_g3
    G4 = min(cfg.stream_g4, max(1, n))
    keys2, gmap2, d2 = _emit_tier(lv, t2, G2, _T2_CB)
    keys3, gmap3, d3 = _emit_tier(lv, t3, G3, _T3_CB)
    keys4, gmap4, d4 = _emit_tier(lv, t4, G4, lv.nf)
    # index_select: its backward is an index_add_, where advanced
    # indexing's backward sorts the indices first
    planes2 = planes.index_select(1, gmap2).repeat_interleave(_T2_CB, dim=1)
    planes3 = planes.index_select(1, gmap3).repeat_interleave(_T3_CB, dim=1)
    planes4 = planes.index_select(1, gmap4).repeat_interleave(lv.nf, dim=1)

    keys = torch.cat([keys1, keys2, keys3, keys4]).to(torch.int32)
    emis = torch.cat([planes1, planes2, planes3, planes4], dim=1)
    return keys, emis, d2 + d3 + d4, lv


def required_stream_caps(means3d, cov6, opacity, camera, cfg) -> dict:
    """Measured tier populations of this geometry: the stream_g2/g3/g4
    budgets at which render_stream reports n_dropped == 0."""
    zeros3 = torch.zeros((means3d.shape[0], 3), dtype=torch.float32,
                         device=means3d.device)
    pre = preprocess(means3d, cov6, opacity, None, camera, 0, cfg,
                     colors_precomp=zeros3)
    lv = _stream_levels(pre, camera, cfg)
    t2 = lv.valid & (lv.area > 4) & (lv.area <= _T2_CB)
    t3 = lv.valid & (lv.area > _T2_CB) & (lv.area <= _T3_CB)
    t4 = lv.valid & (lv.area > _T3_CB)
    return {
        "stream_g2": int(torch.sum(t2)),
        "stream_g3": int(torch.sum(t3)),
        "stream_g4": int(torch.sum(t4)),
    }


def sort_stream(keys: torch.Tensor, emis: torch.Tensor, nf: int, M: int):
    """One stable key sort; returns (sorted planes (9, L), bounds (nf+1,)
    int32) with tile t's segment at [bounds[t], bounds[t+1])."""
    skeys, perm = torch.sort(keys, stable=True)
    splanes = emis.index_select(1, perm)
    needles = torch.arange(nf + 1, dtype=torch.int32, device=keys.device) * M
    bounds = torch.searchsorted(skeys, needles).to(torch.int32)
    return splanes, bounds


# ---------------------------------------------------------------------------
# blend: plain twin and kernel K3
# ---------------------------------------------------------------------------


def _pixel_coords(B: int, device):
    """Block-local pixel coordinates and monomials (px, py, px^2, py^2,
    px py), each (B*B,)."""
    pix = torch.arange(B * B, device=device)
    px, py = (pix % B).to(torch.float32), (pix // B).to(torch.float32)
    return px, py, px * px, py * py, px * py


def _chunk_power(p: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                 in_rng: torch.Tensor, pix, alpha_min: float):
    """A chunk of sorted slots p (9, n, C) of n display blocks with origins
    x0 / y0 (n,) against the blocks' pixels ``pix`` (``_pixel_coords``):
    (gx, gy (n, C) splat offsets from the origin; power, exp(power), alpha,
    gate (n, C, P)).  The conic rows and the 7-term power are formed with
    the kernels' expressions in their order, so the twins reach the
    kernels' gate decisions (quad <= 0, alpha >= alpha_min) bit for bit;
    slots outside the segment (~in_rng) get log opacity -1e30."""
    px, py, pxx, pyy, pxy = pix
    gx = p[0] - x0[:, None]
    gy = p[1] - y0[:, None]
    a, b, c = p[2], p[3], p[4]
    logo = torch.where(in_rng, p[5], -1e30)[..., None]
    F0 = (-0.5 * a)[..., None]
    F1 = (a * gx + b * gy)[..., None]
    F2 = (-0.5 * (a * gx * gx + c * gy * gy) - b * gx * gy)[..., None]
    F3 = (-0.5 * c)[..., None]
    F4 = (c * gy + b * gx)[..., None]
    F5 = (-b)[..., None]
    power = F0 * pxx
    power = power + F1 * px
    power = power + F2
    power = power + F3 * pyy
    power = power + F4 * py
    power = power + F5 * pxy
    power = power + logo
    expp = torch.exp(power)
    alpha = torch.clamp_max(expp, 0.99)
    gate = (power <= logo) & (alpha >= alpha_min)
    return gx, gy, power, expp, alpha, gate


def cull_boxes(gx: torch.Tensor, gy: torch.Tensor, p: torch.Tensor,
               alpha_min: float):
    """Kernel K3's cull, in plain torch: for splats at block offsets gx, gy
    with raw planes p (9, ...), the box (x lo, x hi, y lo, y hi) in
    block-local pixel coordinates outside which the splat cannot pass the
    blend gate (power <= log opacity, alpha >= alpha_min).  With power =
    log opacity - q / 2 the gate needs q <= 2 k, k = log opacity -
    ln(alpha_min) (less 1e-3 against expf's rounding): the ellipse's
    half-extents sqrt(2 k c / det) and sqrt(2 k a / det), widened by 0.1%
    and one pixel against the rounding of the kernels' power term.  k < 0
    culls everywhere (an empty box), a conic that is not positive definite
    nowhere (an infinite one).  The expressions are the kernel's, in
    float32; the tests hold the gate's passing pairs inside the box."""
    a, b, c, logo = p[2], p[3], p[4], p[5]
    log_amin = torch.log(torch.tensor(alpha_min, dtype=torch.float32)) - 1e-3
    k = logo - log_amin.to(logo.device)
    det = a * c - b * b
    ex = torch.sqrt(2.0 * k * c / det) * 1.001 + 1.0
    ey = torch.sqrt(2.0 * k * a / det) * 1.001 + 1.0
    finite = (a > 0) & (c > 0) & (det > 0)
    inf = torch.full_like(gx, float("inf"))
    xl = torch.where(finite, gx - ex, -inf)
    xh = torch.where(finite, gx + ex, inf)
    yl = torch.where(finite, gy - ey, -inf)
    yh = torch.where(finite, gy + ey, inf)
    return torch.where(k >= 0, xl, inf), xh, yl, yh


def stream_blend_ref(splanes: torch.Tensor, bounds: torch.Tensor, nbx: int,
                     B: int, t_min: float, alpha_min: float) -> torch.Tensor:
    """Plain twin of kernel K3: blend state (nf, 8, B*B).

    Rows: 0..2 rgb, 3 transmittance, 4 done, 5 last contributing global
    slot + 1, 6..7 zero.  Display block b composites slots
    [bounds[b], bounds[b+1]) front to back: conic from the planes,
    alpha = min(0.99, exp(power)) gated by quad <= 0 and alpha >= alpha_min,
    a pixel stops (done) at the first slot whose T_after would fall below
    t_min.  Vectorized over blocks and ``chunk`` slots at a time with an
    inclusive cumulative product inside the chunk (gsmpm_tpu's formulation;
    the result does not depend on the chunk size beyond rounding).  The
    power term is summed in the monomial order of the kernel, which
    reproduces it bit for bit.
    """
    dev = splanes.device
    nf = bounds.shape[0] - 1
    P = B * B
    L = splanes.shape[1]
    chunk = _TWIN_CHUNK
    lo = bounds[:-1].to(torch.int64)
    hi = bounds[1:].to(torch.int64)
    bid = torch.arange(nf, device=dev)
    x0 = ((bid % nbx) * B).to(torch.float32)
    y0 = ((bid // nbx) * B).to(torch.float32)
    pix = _pixel_coords(B, dev)

    rgb = torch.zeros((nf, 3, P), dtype=torch.float32, device=dev)
    T = torch.ones((nf, P), dtype=torch.float32, device=dev)
    done = torch.zeros((nf, P), dtype=torch.bool, device=dev)
    last = torch.zeros((nf, P), dtype=torch.float32, device=dev)
    nchunks = int(((hi - lo).max() + chunk - 1) // chunk) if nf else 0
    ar = torch.arange(chunk, device=dev)
    for j in range(nchunks):
        act = (lo + j * chunk < hi) & ~done.all(dim=1)
        if not bool(act.any()):
            break
        a_idx = act.nonzero().squeeze(1)
        ids = lo[a_idx, None] + j * chunk + ar                  # (na, C)
        in_rng = ids < hi[a_idx, None]
        p = splanes[:, ids.clamp(max=max(L - 1, 0))]            # (9, na, C)
        _, _, _, _, alpha, gate = _chunk_power(p, x0[a_idx], y0[a_idx],
                                               in_rng, pix, alpha_min)
        alpha = torch.where(gate, alpha, 0.0)
        one_minus = 1.0 - alpha
        cp = torch.cumprod(one_minus, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        Ta = T[a_idx]
        T_before = Ta[:, None, :] * excl
        T_after = T_before * one_minus
        contrib = ~done[a_idx][:, None, :] & (T_after >= t_min)
        w = torch.where(contrib, T_before * alpha, 0.0)
        rgb[a_idx] += torch.einsum("knc,ncp->nkp", p[6:9], w)
        alpha_eff = torch.where(contrib, alpha, 0.0)
        T[a_idx] = Ta * torch.prod(1.0 - alpha_eff, dim=1)
        done[a_idx] = done[a_idx] | torch.any(T_after < t_min, dim=1)
        gidx1 = (ids + 1).to(torch.float32)
        hit = torch.where(contrib & (alpha > 0.0), gidx1[..., None], 0.0)
        last[a_idx] = torch.maximum(last[a_idx], hit.max(dim=1).values)
    out = torch.zeros((nf, 8, P), dtype=torch.float32, device=dev)
    out[:, 0:3] = rgb
    out[:, 3] = T
    out[:, 4] = done.to(torch.float32)
    out[:, 5] = last
    return out


def stream_blend_bwd_ref(splanes: torch.Tensor, bounds: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, nbx: int, B: int,
                         alpha_min: float) -> torch.Tensor:
    """Plain twin of kernel K7: d(sorted planes) (9, L) from the blend state
    ``out`` of ``stream_blend`` and its cotangent ``g`` (rows 0..2 rgb, 3
    T; the other rows are ignored).

    gsmpm_tpu's _stream_bwd_kernel, vectorized over blocks and ``chunk``
    slots at a time: each block walks its segment back to front from the
    chunk holding its largest last contributor, keeping per pixel T_end
    (transmittance after the chunk, recovered by division) and R_end (the
    suffix sum of w (c . g_rgb), seeded with T_final g_T).  A slot
    contributes to a pixel where it passes the forward's gates and lies at
    or before the pixel's last contributor; dpower = dalpha * alpha where
    exp(power) < 0.99 (the clamp).  Per slot, dpower summed over the
    pixels against the monomials of the pixel's offset from the splat's
    centre, and the colors' sum_p g_rgb w, give the 9 raw rows by the F
    build's chain rule (the same derivative as gsmpm_tpu's sums over the
    block-local monomials, without their cancellation).  Slots no block
    walks (past a block's last contributor's chunk, past bounds[nf]) get
    zero.  The forward's stop rule at t_min is recorded in ``out`` (row
    5), so the reverse walk does not need t_min."""
    dev = splanes.device
    nf = bounds.shape[0] - 1
    P = B * B
    L = splanes.shape[1]
    chunk = _TWIN_CHUNK
    lo = bounds[:-1].to(torch.int64)
    hi = bounds[1:].to(torch.int64)
    bid = torch.arange(nf, device=dev)
    x0 = ((bid % nbx) * B).to(torch.float32)
    y0 = ((bid // nbx) * B).to(torch.float32)
    pix = _pixel_coords(B, dev)
    px, py = pix[0], pix[1]

    g_rgb = g[:, 0:3]
    last = out[:, 5]
    T_end = out[:, 3].clone()
    R_end = out[:, 3] * g[:, 3]
    # chunks of each segment up to its largest last contributor
    top = ((last.amax(dim=1).to(torch.int64) - lo).clamp_min(0)
           + chunk - 1) // chunk
    dsp = torch.zeros((9, L), dtype=torch.float32, device=dev)
    ar = torch.arange(chunk, device=dev)
    for j in range(int(top.max()) - 1 if nf else -1, -1, -1):
        b_idx = (j < top).nonzero().squeeze(1)
        ids = lo[b_idx, None] + j * chunk + ar                  # (nb, C)
        in_rng = ids < hi[b_idx, None]
        p = splanes[:, ids.clamp(max=max(L - 1, 0))]            # (9, nb, C)
        gx, gy, _, expp, alpha, gate0 = _chunk_power(
            p, x0[b_idx], y0[b_idx], in_rng, pix, alpha_min)
        a, b, c = p[2], p[3], p[4]
        gidx1 = (ids + 1).to(torch.float32)[..., None]
        contrib = gate0 & (gidx1 <= last[b_idx][:, None, :])
        a_eff = torch.where(contrib, alpha, 0.0)
        one_minus = 1.0 - a_eff
        T_start = T_end[b_idx] / torch.prod(one_minus, dim=1)
        cp = torch.cumprod(one_minus, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        T_before = T_start[:, None, :] * excl
        w = T_before * a_eff
        cdot = torch.einsum("knc,nkp->ncp", p[6:9], g_rgb[b_idx])
        v = w * cdot
        suf = torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])
        S = R_end[b_idx][:, None, :] + (suf - v)
        dA = T_before * cdot - S / one_minus
        dP = torch.where(contrib & (expp < 0.99), dA * alpha, 0.0)
        # the F build's transpose to the raw rows (gsmpm_tpu's in-kernel
        # chain rule) in centred coordinates, power = -0.5 a dx^2 - b dx dy
        # - 0.5 c dy^2 + log opacity: sums over the raw monomials would
        # cancel for splats of a pixel or two
        dx = px - gx[..., None]
        dy = py - gy[..., None]
        sxx = (dP * dx * dx).sum(-1)
        sxy = (dP * dx * dy).sum(-1)
        syy = (dP * dy * dy).sum(-1)
        sx = (dP * dx).sum(-1)
        sy = (dP * dy).sum(-1)
        dFc = torch.einsum("nkp,ncp->knc", g_rgb[b_idx], w)     # (3, nb, C)
        dp = torch.stack([
            a * sx + b * sy, b * sx + c * sy,
            -0.5 * sxx, -sxy, -0.5 * syy,
            dP.sum(-1) * in_rng,  # the log opacity passes inside the segment
            dFc[0], dFc[1], dFc[2],
        ])
        dsp[:, ids[in_rng]] = dp[:, in_rng]
        T_end[b_idx] = T_start
        R_end[b_idx] = R_end[b_idx] + v.sum(dim=1)
    return dsp


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# row 5 of the blend state holds "last contributing slot + 1" as float32,
# exact only below 2^24 (the JAX package's layout, kept for parity)
MAX_SLOTS = 2 ** 24


def _lib():
    lib = build.load("stream_raster")
    lib.gsmpm_stream_fwd.argtypes = [_VP, _I, _VP, _VP, _I, _I, _I, _F, _F, _VP]
    lib.gsmpm_stream_fwd.restype = ctypes.c_int
    lib.gsmpm_stream_bwd.argtypes = [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I,
                                     _F, _VP]
    lib.gsmpm_stream_bwd.restype = ctypes.c_int
    lib.gsmpm_stream_bwd_blocks.argtypes = [_I, _I]
    lib.gsmpm_stream_bwd_blocks.restype = ctypes.c_int
    return lib


def _check_stream(splanes: torch.Tensor, bounds: torch.Tensor, B: int):
    """Raise on inputs the kernels do not take; returns the device."""
    if splanes.shape[1] >= MAX_SLOTS:
        raise ValueError(f"{splanes.shape[1]} stream slots: the blend state "
                         f"stores slot indices as float32, exact below "
                         f"{MAX_SLOTS}")
    dev = splanes.device
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    # K3's warps take 16 x 8 pixel groups
    if B % 16 != 0:
        raise ValueError(f"block size {B} must be a multiple of 16")
    if splanes.dtype != torch.float32 or splanes.dim() != 2 or \
            splanes.shape[0] != 9 or not splanes.is_contiguous():
        raise ValueError("splanes must be a contiguous float32 (9, L) tensor")
    if bounds.dtype != torch.int32 or bounds.device != dev or \
            not bounds.is_contiguous() or bounds.dim() != 1:
        raise ValueError("bounds must be a contiguous int32 (nf+1,) tensor "
                         "on the planes' device")
    return dev


def stream_blend(splanes: torch.Tensor, bounds: torch.Tensor, nbx: int,
                 B: int, t_min: float, alpha_min: float) -> torch.Tensor:
    """Blend state (nf, 8, B*B) of the sorted stream: kernel K3 for CUDA
    tensors, ``stream_blend_ref`` for CPU tensors."""
    dev = _check_stream(splanes, bounds, B)
    if dev.type == "cpu":
        return stream_blend_ref(splanes, bounds, nbx, B, t_min, alpha_min)
    nf = bounds.shape[0] - 1
    out = torch.empty((nf, 8, B * B), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.gsmpm_stream_fwd(
        splanes.data_ptr(), splanes.shape[1], bounds.data_ptr(),
        out.data_ptr(), nf, nbx, B, t_min, alpha_min,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "stream_blend")
    stream_blend.launches += 1
    return out


def stream_blend_bwd(splanes: torch.Tensor, bounds: torch.Tensor,
                     out: torch.Tensor, g: torch.Tensor, nbx: int, B: int,
                     alpha_min: float) -> torch.Tensor:
    """d(sorted planes) (9, L) of the stream blend: kernel K7 for CUDA
    tensors, ``stream_blend_bwd_ref`` for CPU tensors."""
    dev = _check_stream(splanes, bounds, B)
    if dev.type == "cpu":
        return stream_blend_bwd_ref(splanes, bounds, out, g, nbx, B,
                                    alpha_min)
    # a block's 16 x 8 pixel groups spread over one cluster of CUDA blocks,
    # 4 at 64 (a portable cluster holds at most 8)
    if B * B > 4096:
        raise ValueError(f"block {B}: the backward kernel takes blocks up "
                         "to 64")
    nf = bounds.shape[0] - 1
    for name, t in (("out", out), ("g", g)):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != (nf, 8, B * B) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(nf, 8, B * B)} tensor on {dev}")
    # the kernel writes only the chunks it walks: the rest stays zero
    dsp = torch.zeros_like(splanes)
    lib = _lib()
    err = lib.gsmpm_stream_bwd(
        splanes.data_ptr(), splanes.shape[1], bounds.data_ptr(),
        out.data_ptr(), g.data_ptr(), dsp.data_ptr(), nf, nbx, B, alpha_min,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "stream_blend_bwd")
    stream_blend_bwd.launches += 1
    return dsp


def stream_bwd_blocks(nf: int, B: int) -> int:
    """CUDA blocks of one K7 launch over nf display blocks of edge B, as
    the launch computes them (a cluster per display block)."""
    return _lib().gsmpm_stream_bwd_blocks(nf, B)


stream_blend.launches = 0
stream_blend_bwd.launches = 0


class _StreamCore(torch.autograd.Function):
    """(sorted planes (9, L), bounds) -> blend state (nf, 8, B*B), with the
    reverse stream walk as its backward (gsmpm_tpu's _stream_core)."""

    @staticmethod
    def forward(ctx, splanes, bounds, nbx, B, t_min, alpha_min):
        out = stream_blend(splanes, bounds, nbx, B, t_min, alpha_min)
        ctx.save_for_backward(splanes, bounds, out)
        ctx.args = (nbx, B, alpha_min)
        return out

    @staticmethod
    def backward(ctx, g):
        with span("render.backward"):
            splanes, bounds, out = ctx.saved_tensors
            g8 = torch.zeros_like(out)
            g8[:, 0:4] = g[:, 0:4]  # the bookkeeping rows carry no cotangent
            dsp = stream_blend_bwd(splanes, bounds, out, g8, *ctx.args)
            return dsp, None, None, None, None, None


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def stream_inputs(pre: Preprocessed, camera, cfg):
    """Emission + sort: (sorted planes (9, L), bounds (nf+1,), n_dropped,
    levels), the inputs of the blend kernel."""
    planes = _raw_planes_nosentinel(pre)[:9]  # (9, N): radius not needed
    keys, emis, n_dropped, lv = stream_emission(pre, camera, cfg, planes)
    splanes, bounds = sort_stream(keys, emis, lv.nf, lv.M)
    return splanes, bounds, n_dropped, lv


def render_stream(pre: Preprocessed, camera, bg: torch.Tensor, cfg):
    """Drop-free streaming render: (image (H, W, 3), n_dropped).

    n_dropped counts candidates of gaussians beyond the tier budgets
    (stream_g2/g3/g4): zero for any scene whose large-splat population fits
    the budgets, independent of density.  Differentiable in ``pre``'s
    planes (kernels K3 forward, K7 backward).
    """
    splanes, bounds, n_dropped, lv = stream_inputs(pre, camera, cfg)
    B = cfg.block
    out = _StreamCore.apply(splanes, bounds, lv.nbx, B, float(cfg.t_min),
                            float(cfg.alpha_min))

    counts = bounds[1:] - bounds[:-1]
    rgb = out[:, 0:3, :] + out[:, 3:4, :] * bg[None, :, None]
    rgb = torch.where((counts > 0)[:, None, None], rgb, bg[None, :, None])
    blocks = rgb.reshape(lv.nf, 3, B, B).permute(0, 2, 3, 1)
    return assemble_blocks(blocks, camera, cfg), n_dropped
