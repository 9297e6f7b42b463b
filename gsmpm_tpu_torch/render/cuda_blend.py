"""Windowed tile blend: kernels K4 / K5 (padded layout) and K8 / K9 (packed).

Counterpart of gsmpm_tpu/render/pallas_blend.py.  Each
pixel block b blends its depth-ordered candidate window front to back from
a prebuilt (16, K) coefficient block F (``_build_F``): the quadratic form
of a splat over the block-local pixel monomials H = [px^2, px, 1, py^2, py,
px py, 1] is the 7-term sum F[0:7] . H (row 6 = log opacity, so the sum is
the log alpha), rows 8..10 are the colors.

``blend_blocks`` is differentiable in the candidates: ``_BlendCore`` pairs
the forward blend with a reverse walk that recovers the transmittance by
division and returns dF.  For CUDA tensors both directions are the kernels
of csrc/tile_blend.cu (one kernel each serves every K: global memory has
no VMEM limit, so the TPU's resident/streamed split has no counterpart);
for CPU tensors they are the plain twins ``blend_core_ref`` /
``blend_core_bwd_ref``, transcriptions of the TPU kernels' chunked math.

``blend_packed`` is the same blend on the packed layout: every block's
window stored back to back in one (16, T) array at C-aligned offsets, so
the candidate gather tracks the real candidate total instead of nblocks x
K.  ``_BlendCorePacked`` pairs kernels K8 / K9 (twins ``blend_packed_ref``
/ ``blend_packed_bwd_ref``, which run the padded twins on the gathered
windows).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gsmpm_tpu_torch.utils import build

# candidate plane rows (renderer._raw_planes_nosentinel layout)
CGX, CGY, CA, CB, CC, CLOGO, CR, CG, CB_, CRAD = range(10)
NEG = -1e30  # log opacity of a slot that must blend to nothing


class BlendMeta(NamedTuple):
    C: int          # candidates per chunk of the twins' walk
    B: int          # block edge (pixels)
    t_min: float
    alpha_min: float
    n_chunks: int

    @property
    def P(self) -> int:
        return self.B * self.B


def _blend_meta(K: int, cfg) -> tuple:
    """(C, n_chunks, K_padded) for a candidate capacity K."""
    C = cfg.chunk
    n_chunks = -(-K // C)
    return C, n_chunks, n_chunks * C


def _build_F(cand_raw: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
             B: int) -> torch.Tensor:
    """(10, nblocks, K) candidate planes -> (nblocks, 16, K) F rows.

    Rows 0..5 pair with the monomials [px^2, px, 1, py^2, py, px py] of the
    block-local pixel, row 6 is the log opacity (its monomial is 1), rows
    8..10 the colors.  x0/y0 (nblocks, 1) are the block origins.  A
    candidate whose screen rect misses the block gets log opacity -1e30 and
    blends to exactly nothing.  The packed layout's (10, T) planes with
    per-slot origins x0/y0 (T,) give (16, T): gsmpm_tpu's _build_F_packed
    is this function with the batch axis dropped."""
    gx = cand_raw[CGX] - x0
    gy = cand_raw[CGY] - y0
    a, b, c, r = cand_raw[CA], cand_raw[CB], cand_raw[CC], cand_raw[CRAD]
    in_rect = ((gx + r >= -0.5) & (gx - r <= B - 0.5)
               & (gy + r >= -0.5) & (gy - r <= B - 0.5))
    logo = torch.where(in_rect, cand_raw[CLOGO], NEG)
    zeros = torch.zeros_like(gx)
    rows = [
        -0.5 * a,
        a * gx + b * gy,
        -0.5 * (a * gx * gx + c * gy * gy) - b * gx * gy,
        -0.5 * c,
        c * gy + b * gx,
        -b,
        logo,
        zeros,
        cand_raw[CR], cand_raw[CG], cand_raw[CB_],
        zeros, zeros, zeros, zeros, zeros,
    ]
    return torch.stack(rows, dim=-2)


def window_boxes(F: torch.Tensor, B: int, alpha_min: float):
    """Kernels K5 / K9's cull, in plain torch: for F rows (..., 16, K) the
    box (x lo, x hi, y lo, y hi), each (..., K), in block-local pixel
    coordinates outside which a candidate cannot pass the blend gate
    (power <= F6, alpha >= alpha_min).

    The conic is a = -2 F0, c = -2 F3, b = -F5 (exact); the centre g
    solves [[a, b], [b, c]] g = (F1, F4); the power's peak is the form
    evaluated at g, in the kernels' order (first-order insensitive to the
    rounding of the solve).  With power = peak - q(p - g) / 2 the gate
    needs q <= 2 k, k = peak - ln(alpha_min): half-extents sqrt(2 k c /
    det), sqrt(2 k a / det).  k is widened by 1e-3 (expf) and by 4e-6 of
    the magnitude of the power's terms over the block and at g (the
    rounding of F2, ~1e-3 at the fit's 64-pixel blocks, and of the sums),
    the extents by 0.1% and one pixel (the centre's rounding).  A dead
    column (F6 = -1e30), a log opacity below ln(alpha_min) or k < 0 give
    an empty box (x lo = +inf); a conic that is not positive definite or
    is near-singular (det <= 1e-3 a c) an infinite one.  The expressions
    are the kernels' (csrc/tile_blend.cu window_box), in float32."""
    F0, F1, F2, F3, F4, F5, F6 = (F[..., r, :] for r in range(7))
    log_amin = (torch.log(torch.tensor(alpha_min, dtype=torch.float32))
                - 1e-3).to(F.device)
    a, c, b = -2.0 * F0, -2.0 * F3, -F5
    det = a * c - b * b
    finite = (a > 0) & (c > 0) & (det > 1e-3 * (a * c))
    gx = (c * F1 - b * F4) / det
    gy = (a * F4 - b * F1) / det
    peak = F0 * (gx * gx)
    peak = peak + F1 * gx
    peak = peak + F2
    peak = peak + F3 * (gy * gy)
    peak = peak + F4 * gy
    peak = peak + F5 * (gx * gy)
    peak = peak + F6
    fb = float(B)
    mag = ((F0 * (gx * gx)).abs() + (F1 * gx).abs() + F2.abs()
           + (F3 * (gy * gy)).abs() + (F4 * gy).abs() + (F5 * (gx * gy)).abs()
           + (F0.abs() + F3.abs() + F5.abs()) * (fb * fb)
           + (F1.abs() + F4.abs()) * fb)
    k = peak - log_amin + 4e-6 * mag
    ex = torch.sqrt(2.0 * k * c / det) * 1.001 + 1.0
    ey = torch.sqrt(2.0 * k * a / det) * 1.001 + 1.0
    inf = torch.full_like(F0, float("inf"))
    empty = ~(F6 - log_amin >= 0) | (finite & ~(k >= 0))
    xl = torch.where(finite, gx - ex, -inf)
    xh = torch.where(finite, gx + ex, inf)
    yl = torch.where(finite, gy - ey, -inf)
    yh = torch.where(finite, gy + ey, inf)
    return torch.where(empty, inf, xl), xh, yl, yh


def _monomials(B: int, device):
    """Block-local pixel monomials (px^2, px, py^2, py, px py), each (P,)."""
    pix = torch.arange(B * B, device=device)
    px = (pix % B).to(torch.float32)
    py = (pix // B).to(torch.float32)
    return px * px, px, py * py, py, px * py


def _power(Fc: torch.Tensor, mono) -> torch.Tensor:
    """(n, 16, C) chunk -> (n, C, P) log alpha, summed term by term in the
    order the kernels sum it (they are built without FMA contraction)."""
    pxx, px, pyy, py, pxy = mono

    def r(i):
        return Fc[:, i, :, None]

    power = r(0) * pxx
    power = power + r(1) * px
    power = power + r(2)
    power = power + r(3) * pyy
    power = power + r(4) * py
    power = power + r(5) * pxy
    return power + r(6)


def blend_core_ref(counts: torch.Tensor, F: torch.Tensor,
                   meta: BlendMeta) -> torch.Tensor:
    """Plain twin of kernel K4: blend state (nblocks, 8, P).

    Rows 0..2 rgb, 3 transmittance, 4 done, 5 last contributing candidate
    index + 1, 6..7 zero.  Chunks of C candidates at a time, all blocks
    together: alpha = min(0.99, exp(power)) kept where the quadratic part
    is <= 0 and alpha >= alpha_min, an inclusive cumulative product inside
    the chunk, and a pixel is done at the first candidate whose T_after
    falls below t_min (gsmpm_tpu's _blend_kernel)."""
    C, B, t_min, alpha_min, n_chunks = meta
    nb, dev = F.shape[0], F.device
    P = B * B
    mono = _monomials(B, dev)
    n_live = torch.clamp((counts.to(torch.int64) + C - 1) // C, max=n_chunks)
    rgb = torch.zeros((nb, 3, P), dtype=torch.float32, device=dev)
    T = torch.ones((nb, P), dtype=torch.float32, device=dev)
    done = torch.zeros((nb, P), dtype=torch.bool, device=dev)
    last = torch.zeros((nb, P), dtype=torch.float32, device=dev)
    ar = torch.arange(C, device=dev)
    for c in range(int(n_live.max()) if nb else 0):
        act = (c < n_live) & ~done.all(dim=1)
        if not bool(act.any()):
            break
        a_idx = act.nonzero().squeeze(1)
        Fc = F[a_idx, :, c * C:(c + 1) * C]
        power = _power(Fc, mono)
        lgo = Fc[:, 6, :, None]
        alpha = torch.clamp_max(torch.exp(power), 0.99)
        alpha = torch.where((power <= lgo) & (alpha >= alpha_min), alpha, 0.0)
        one_minus = 1.0 - alpha
        cp = torch.cumprod(one_minus, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        Ta = T[a_idx]
        T_before = Ta[:, None, :] * excl
        T_after = T_before * one_minus
        contrib = ~done[a_idx][:, None, :] & (T_after >= t_min)
        w = torch.where(contrib, T_before * alpha, 0.0)
        rgb[a_idx] += torch.bmm(Fc[:, 8:11], w)
        alpha_eff = torch.where(contrib, alpha, 0.0)
        T[a_idx] = Ta * torch.prod(1.0 - alpha_eff, dim=1)
        done[a_idx] = done[a_idx] | torch.any(T_after < t_min, dim=1)
        gidx1 = (ar + c * C + 1).to(torch.float32)[None, :, None]
        hit = torch.where(contrib & (alpha > 0.0), gidx1, 0.0)
        last[a_idx] = torch.maximum(last[a_idx], hit.max(dim=1).values)
    out = torch.zeros((nb, 8, P), dtype=torch.float32, device=dev)
    out[:, 0:3] = rgb
    out[:, 3] = T
    out[:, 4] = done.to(torch.float32)
    out[:, 5] = last
    return out


def blend_core_bwd_ref(F: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                       meta: BlendMeta) -> torch.Tensor:
    """Plain twin of kernel K5: dF (nblocks, 16, K) from the forward state
    ``out`` and the cotangent ``g`` of it (rows 0..2 rgb, 3 T).

    Walks chunks back to front (gsmpm_tpu's _blend_bwd_kernel), keeping per
    pixel T_end (transmittance after the chunk) and R_end (suffix sum of
    w (c . g_rgb) plus T_final g_T).  Per candidate: T_before recovered by
    division, dL/dalpha = T_before (c . g_rgb) - S / (1 - alpha), zero
    gradient where exp(power) >= 0.99 (the clamp).  dF rows 0..6 =
    sum_p H(p) dpower, rows 8..10 = sum_p g_rgb w.  Chunks past a block's
    last contributor hold no contributor and are skipped."""
    C, B, t_min, alpha_min, n_chunks = meta
    nb, K, dev = F.shape[0], F.shape[2], F.device
    P = B * B
    mono = _monomials(B, dev)
    H = torch.stack([mono[0], mono[1], torch.ones_like(mono[0]), mono[2],
                     mono[3], mono[4], torch.ones_like(mono[0])])  # (7, P)
    g_rgb = g[:, 0:3]
    last = out[:, 5]
    T_end = out[:, 3].clone()
    R_end = out[:, 3] * g[:, 3]
    top = (last.amax(dim=1).to(torch.int64) + C - 1) // C   # chunks walked
    dF = torch.zeros((nb, 16, K), dtype=torch.float32, device=dev)
    ar = torch.arange(C, device=dev)
    for c in range(int(top.max()) - 1 if nb else -1, -1, -1):
        b_idx = (c < top).nonzero().squeeze(1)
        Fc = F[b_idx, :, c * C:(c + 1) * C]
        power = _power(Fc, mono)
        lgo = Fc[:, 6, :, None]
        expp = torch.exp(power)
        alpha = torch.clamp_max(expp, 0.99)
        gate0 = (power <= lgo) & (alpha >= alpha_min)
        gidx1 = (ar + c * C + 1).to(torch.float32)[None, :, None]
        contrib = gate0 & (gidx1 <= last[b_idx][:, None, :])
        a_eff = torch.where(contrib, alpha, 0.0)
        one_minus = 1.0 - a_eff
        T_start = T_end[b_idx] / torch.prod(one_minus, dim=1)
        cp = torch.cumprod(one_minus, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        T_before = T_start[:, None, :] * excl
        w = T_before * a_eff
        cdot = torch.bmm(Fc[:, 8:11].transpose(1, 2), g_rgb[b_idx])
        v = w * cdot
        suf = torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])
        S = R_end[b_idx][:, None, :] + (suf - v)
        dA = T_before * cdot - S / one_minus
        dP = torch.where(contrib & (expp < 0.99), dA * alpha, 0.0)
        cols = slice(c * C, (c + 1) * C)
        dF[b_idx, 0:7, cols] = torch.einsum("rp,ncp->nrc", H, dP)
        dF[b_idx, 8:11, cols] = torch.bmm(g_rgb[b_idx], w.transpose(1, 2))
        T_end[b_idx] = T_start
        R_end[b_idx] = R_end[b_idx] + v.sum(dim=1)
    return dF


# ---------------------------------------------------------------------------
# kernels K4 / K5
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("tile_blend")
    lib.gsmpm_blend_fwd.argtypes = [_VP, _VP, _VP, _I, _I, _I, _F, _F, _VP]
    lib.gsmpm_blend_fwd.restype = ctypes.c_int
    lib.gsmpm_blend_bwd.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP]
    lib.gsmpm_blend_bwd.restype = ctypes.c_int
    for name in ("gsmpm_blend_fwd_blocks", "gsmpm_blend_bwd_blocks"):
        getattr(lib, name).argtypes = [_I, _I]
        getattr(lib, name).restype = ctypes.c_int
    lib.gsmpm_blend_packed_fwd.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                           _I, _F, _F, _VP]
    lib.gsmpm_blend_packed_fwd.restype = ctypes.c_int
    lib.gsmpm_blend_packed_bwd.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _I,
                                           _I, _I, _I, _I, _F, _VP]
    lib.gsmpm_blend_packed_bwd.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_block(B: int) -> None:
    # 16x8 pixel groups, 8 to a CUDA block; K5's blocks of one pixel block
    # form a cluster, 4 at 64 (a portable cluster holds at most 8)
    if B % 16 != 0 or B * B > 4096:
        raise ValueError(f"block {B}: the kernels take multiples of 16 up "
                         "to 64")


def blend_fwd(counts: torch.Tensor, F: torch.Tensor,
              meta: BlendMeta) -> torch.Tensor:
    """Blend state (nblocks, 8, P): kernel K4 for CUDA tensors,
    ``blend_core_ref`` for CPU tensors."""
    dev = F.device
    if dev.type == "cpu":
        return blend_core_ref(counts, F, meta)
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    _check_block(meta.B)
    nb, _, K = F.shape
    _check(F, "F", (nb, 16, K), torch.float32, dev)
    _check(counts, "counts", (nb,), torch.int32, dev)
    out = torch.empty((nb, 8, meta.P), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.gsmpm_blend_fwd(counts.data_ptr(), F.data_ptr(),
                              out.data_ptr(), nb, K, meta.B, meta.t_min,
                              meta.alpha_min,
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "blend_fwd")
    blend_fwd.launches += 1
    return out


def blend_bwd(F: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
              meta: BlendMeta) -> torch.Tensor:
    """dF (nblocks, 16, K): kernel K5 for CUDA tensors,
    ``blend_core_bwd_ref`` for CPU tensors."""
    dev = F.device
    if dev.type == "cpu":
        return blend_core_bwd_ref(F, out, g, meta)
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    _check_block(meta.B)
    nb, _, K = F.shape
    _check(F, "F", (nb, 16, K), torch.float32, dev)
    for name, t in (("out", out), ("g", g)):
        _check(t, name, (nb, 8, meta.P), torch.float32, dev)
    dF = torch.empty_like(F)
    lib = _lib()
    err = lib.gsmpm_blend_bwd(F.data_ptr(), out.data_ptr(), g.data_ptr(),
                              dF.data_ptr(), nb, K, meta.B, meta.alpha_min,
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "blend_bwd")
    blend_bwd.launches += 1
    return dF


def blend_fwd_blocks(nblocks: int, B: int) -> int:
    """CUDA blocks of one K4 / K8 launch over nblocks pixel blocks of edge
    B, as the launch computes them (8 pixel groups of 16 x 8 per block)."""
    return _lib().gsmpm_blend_fwd_blocks(nblocks, B)


def blend_bwd_blocks(nblocks: int, B: int) -> int:
    """CUDA blocks of one K5 / K9 launch over nblocks pixel blocks of edge
    B, as the launch computes them (a cluster per pixel block)."""
    return _lib().gsmpm_blend_bwd_blocks(nblocks, B)


blend_fwd.launches = 0
blend_bwd.launches = 0


class _BlendCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, F, counts, meta):
        out = blend_fwd(counts, F, meta)
        ctx.save_for_backward(F, out)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, g):
        F, out = ctx.saved_tensors
        g8 = torch.zeros_like(out)
        g8[:, 0:4] = g[:, 0:4]  # the bookkeeping rows carry no cotangent
        return blend_bwd(F, out, g8, ctx.meta), None, None


def blend_inputs(cand_raw: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor, cfg):
    """The kernels' inputs of a candidate window: (F (nblocks, 16, K_pad),
    counts int32, BlendMeta); K padded up to a multiple of the chunk."""
    _, nb, K = cand_raw.shape
    C, n_chunks, K_pad = _blend_meta(K, cfg)
    if K_pad != K:
        # pad columns must carry log opacity -1e30: the last chunk can
        # straddle K, and a zero would blend as an opaque splat
        pad = torch.zeros((10, nb, K_pad - K), dtype=cand_raw.dtype,
                          device=cand_raw.device)
        pad[CLOGO] = NEG
        cand_raw = torch.cat([cand_raw, pad], dim=2)
    org = origins.to(torch.float32)
    F = _build_F(cand_raw, org[:, 0:1], org[:, 1:2], cfg.block).contiguous()
    meta = BlendMeta(C, cfg.block, float(cfg.t_min), float(cfg.alpha_min),
                     n_chunks)
    return F, counts.to(torch.int32).contiguous(), meta


def blend_blocks(cand_raw: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor, bg: torch.Tensor, cfg) -> torch.Tensor:
    """cand_raw (10, nblocks, K) depth-ordered candidate planes, counts
    (nblocks,), origins (nblocks, 2) -> blended blocks (nblocks, B, B, 3)
    with the background composited.  Differentiable in cand_raw."""
    nb, B = cand_raw.shape[1], cfg.block
    F, counts, meta = blend_inputs(cand_raw, counts, origins, cfg)
    out = _BlendCore.apply(F, counts, meta)
    rgb = out[:, 0:3, :] + out[:, 3:4, :] * bg[None, :, None]
    return rgb.reshape(nb, 3, B, B).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# packed layout: kernels K8 / K9
# ---------------------------------------------------------------------------


def _packed_windows(counts: torch.Tensor, offs: torch.Tensor, T: int,
                    meta: BlendMeta):
    """Block b's window in the packed (16, T) array: (cols (nb, n_chunks*C)
    column of each window slot, walked (nb, n_chunks*C) the slots its blend
    walks, j < min(ceil(count/C), n_chunks) * C).  Unwalked slots point at
    column T - 1, which the blend does not use.  Raises if a walked window
    leaves the T columns (the kernels' device-side assert)."""
    C, Kw = meta.C, meta.n_chunks * meta.C
    width = torch.clamp((counts.to(torch.int64) + C - 1) // C,
                        max=meta.n_chunks) * C
    o = offs.to(torch.int64)
    # a block that walks nothing may carry any offset
    if bool(((width > 0) & ((o < 0) | (o + width > T))).any()):
        raise ValueError(f"offs / counts: a block's window leaves the {T} "
                         "columns of the packed array")
    j = torch.arange(Kw, device=counts.device)
    walked = j[None, :] < width[:, None]
    cols = torch.where(walked, o[:, None] + j, T - 1)
    return cols, walked


def blend_packed_ref(counts: torch.Tensor, offs: torch.Tensor, F: torch.Tensor,
                     meta: BlendMeta) -> torch.Tensor:
    """Plain twin of kernel K8: blend state (nblocks, 8, P) of the packed
    layout.  Block b blends columns [offs[b], offs[b] + n_live*C) of F
    (16, T) front to back, its last-contributor index local to that slice
    (gsmpm_tpu's _blend_kernel_packed): the padded twin on the gathered
    windows."""
    cols, _ = _packed_windows(counts, offs, F.shape[1], meta)
    return blend_core_ref(counts, F[:, cols].transpose(0, 1), meta)


def blend_packed_bwd_ref(counts: torch.Tensor, offs: torch.Tensor,
                         F: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                         meta: BlendMeta) -> torch.Tensor:
    """Plain twin of kernel K9: dF (16, T) of the packed layout, zero
    outside the walked slots (gsmpm_tpu masks them after its kernel): the
    padded twin's reverse walk on the gathered windows, scattered back."""
    cols, walked = _packed_windows(counts, offs, F.shape[1], meta)
    dFw = blend_core_bwd_ref(F[:, cols].transpose(0, 1), out, g, meta)
    dF = torch.zeros_like(F)
    dF[:, cols[walked]] = dFw.transpose(0, 1)[:, walked]
    return dF


def _check_packed(counts: torch.Tensor, offs: torch.Tensor, F: torch.Tensor,
                  meta: BlendMeta):
    """(nblocks, T) after checking the packed kernels' input shapes without
    a host sync.  The windows' bounds are the kernels' own device-side
    assert: a window that leaves F stops the CUDA context, as an index out
    of range does in PyTorch's kernels."""
    dev = F.device
    _check_block(meta.B)
    nb, T = counts.shape[0], F.shape[-1]
    _check(F, "F", (16, T), torch.float32, dev)
    _check(counts, "counts", (nb,), torch.int32, dev)
    _check(offs, "offs", (nb,), torch.int32, dev)
    return nb, T


def blend_packed_fwd(counts: torch.Tensor, offs: torch.Tensor, F: torch.Tensor,
                     meta: BlendMeta) -> torch.Tensor:
    """Blend state (nblocks, 8, P) of the packed layout: kernel K8 for CUDA
    tensors, ``blend_packed_ref`` for CPU tensors."""
    dev = F.device
    if dev.type == "cpu":
        return blend_packed_ref(counts, offs, F, meta)
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    nb, T = _check_packed(counts, offs, F, meta)
    out = torch.empty((nb, 8, meta.P), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.gsmpm_blend_packed_fwd(
        counts.data_ptr(), offs.data_ptr(), F.data_ptr(), out.data_ptr(), nb,
        T, meta.C, meta.n_chunks, meta.B, meta.t_min, meta.alpha_min,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "blend_packed_fwd")
    blend_packed_fwd.launches += 1
    return out


def blend_packed_bwd(counts: torch.Tensor, offs: torch.Tensor, F: torch.Tensor,
                     out: torch.Tensor, g: torch.Tensor,
                     meta: BlendMeta) -> torch.Tensor:
    """dF (16, T) of the packed layout, zero outside the walked slots:
    kernel K9 for CUDA tensors, ``blend_packed_bwd_ref`` for CPU tensors."""
    dev = F.device
    if dev.type == "cpu":
        return blend_packed_bwd_ref(counts, offs, F, out, g, meta)
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    nb, T = _check_packed(counts, offs, F, meta)
    for name, t in (("out", out), ("g", g)):
        _check(t, name, (nb, 8, meta.P), torch.float32, dev)
    # the kernel writes the walked slots only
    dF = torch.zeros_like(F)
    lib = _lib()
    err = lib.gsmpm_blend_packed_bwd(
        counts.data_ptr(), offs.data_ptr(), F.data_ptr(), out.data_ptr(),
        g.data_ptr(), dF.data_ptr(), nb, T, meta.C, meta.n_chunks, meta.B,
        meta.alpha_min, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "blend_packed_bwd")
    blend_packed_bwd.launches += 1
    return dF


blend_packed_fwd.launches = 0
blend_packed_bwd.launches = 0


class _BlendCorePacked(torch.autograd.Function):
    """gsmpm_tpu's _blend_core_packed.  Its backward needs no mask of the
    unwalked slots: K9 and its twin leave them zero (the TPU kernel's
    unvisited output blocks hold garbage, hence the mask in JAX)."""

    @staticmethod
    def forward(ctx, F, counts, offs, meta):
        out = blend_packed_fwd(counts, offs, F, meta)
        ctx.save_for_backward(F, counts, offs, out)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, g):
        F, counts, offs, out = ctx.saved_tensors
        g8 = torch.zeros_like(out)
        g8[:, 0:4] = g[:, 0:4]  # the bookkeeping rows carry no cotangent
        return (blend_packed_bwd(counts, offs, F, out, g8, ctx.meta), None,
                None, None)


def packed_inputs(cand_packed: torch.Tensor, slot_x0: torch.Tensor,
                  slot_y0: torch.Tensor, cfg):
    """The packed kernels' inputs: (F (16, T), BlendMeta) of (10, T) packed
    planes with per-slot block origins; n_chunks from the caps' window K."""
    C, n_chunks, _ = _blend_meta(cfg.k_tile + cfg.k_coarse + cfg.k_global,
                                 cfg)
    F = _build_F(cand_packed, slot_x0, slot_y0, cfg.block).contiguous()
    return F, BlendMeta(C, cfg.block, float(cfg.t_min), float(cfg.alpha_min),
                        n_chunks)


def blend_packed(cand_packed: torch.Tensor, slot_x0: torch.Tensor,
                 slot_y0: torch.Tensor, counts: torch.Tensor,
                 offs: torch.Tensor, bg: torch.Tensor, cfg) -> torch.Tensor:
    """Packed-layout blend (gsmpm_tpu's blend_packed_pallas): cand_packed
    (10, T) raw planes in per-block depth order (dead slots carry log
    opacity -1e30), slot_x0 / slot_y0 (T,) per-slot block origins, counts /
    offs (nblocks,) int32 with C-aligned offsets -> blended blocks
    (nblocks, B, B, 3) with the background composited.  Differentiable in
    cand_packed."""
    B = cfg.block
    F, meta = packed_inputs(cand_packed, slot_x0, slot_y0, cfg)
    out = _BlendCorePacked.apply(F, counts, offs, meta)
    rgb = out[:, 0:3, :] + out[:, 3:4, :] * bg[None, :, None]
    return rgb.reshape(counts.shape[0], 3, B, B).permute(0, 2, 3, 1)
