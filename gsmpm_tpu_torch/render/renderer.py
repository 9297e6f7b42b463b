"""Tile-based 3D Gaussian splatting renderer.

Port of gsmpm_tpu/render/renderer.py on its TPU routes (``impl="pallas"``):
``preprocess`` (EWA projection + SH colors, planes layout), then either

- ``stream=True``: the drop-free sorted-segment stream rasterizer
  (render/stream_raster.py, kernels K3 forward and K7 backward), or
- ``stream=False`` (the default): the windowed path.  The dup-sort v2
  selection bins each gaussian into fine / coarse / global tile streams
  with (tile | quantized depth) keys and one stable sort, each pixel block
  merges its depth-first windows, and the candidates blend with kernels K4
  / K5 (render/cuda_blend.py).  With ``k_dense > 0`` the ``n_dense``
  densest fine tiles get a second, wider window (the two-tier path that
  keeps a fitting render drop-free); else ``packed=True`` stores the
  windows back to back in one stream of at most ``t_cap`` slots and blends
  them with kernels K8 / K9.

Every path is differentiable end to end.

``render_block_rows`` is the JAX package's two-stage row / block selection
(k_row, k_block), blended with kernel K4: the mesh render renders its
rank's block rows with it (parallel/sharded.py).
``required_raster_caps`` / ``bump_caps_for_dropfree`` size the caps from a
measured frame.  The XLA golden blend (``_render_xla``) is not ported; the
port's CPU path runs the kernels' plain twins.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gsmpm_tpu_torch.render.camera import Camera
from gsmpm_tpu_torch.render.sh import C0, band_basis


class RasterConfig(NamedTuple):
    """gsmpm_tpu's render knobs, its fields in its order with its defaults.

    The TPU-only knobs are accepted so that a gsmpm_tpu config means the
    same here; each is marked unused on this port."""

    block: int = 64  # pixel block edge for binning/blending
    k_block: int = 1024  # per-block cap of the XLA path (cap sizing only)
    k_row: int = 8192  # per-block-row cap of the XLA path (cap sizing only)
    chunk: int = 64  # candidates per chunk of the blend twins' walk
    block_batch: int = 16  # unused here: gsmpm_tpu's retained compat knob
    t_min: float = 1e-4  # transmittance early-stop (parity with CUDA)
    alpha_min: float = 1.0 / 255.0
    z_near: float = 0.2  # frustum near cull
    remat: bool = True  # unused here: jax.checkpoint of the XLA blend
    skip_empty: bool = True  # unused here: lax.cond over empty XLA blocks
    impl: str = "auto"  # unused here: Pallas vs XLA (CUDA or twin by device)
    # depth-first caps of the windowed path's fine / coarse / global tile
    # streams; their sum is the per-block window K
    k_tile: int = 512
    k_coarse: int = 128
    k_global: int = 128
    sel: str = "auto"  # unused here: the v1 selections (only v2 is ported)
    # packed windowed layout (taken when k_dense == 0): the windows stored
    # back to back at chunk-aligned offsets in one stream of t_cap slots;
    # blocks past t_cap are dropped whole and counted in n_dropped
    packed: bool = False
    t_cap: int = 32768
    # two-tier windowed render (k_dense = 0 disables): the n_dense fine
    # tiles with the longest segments get a second window of k_dense
    k_dense: int = 0
    n_dense: int = 16
    # the drop-free sorted-segment stream rasterizer
    stream: bool = False
    # per-tier gaussian budgets of the stream rasterizer
    # (render/stream_raster.py) for splats whose screen rect spans
    # >4 / >16 / >64 fine tiles
    stream_g2: int = 2048
    stream_g3: int = 256
    stream_g4: int = 32
    stream_unroll: int = 8  # unused here: Pallas chunks per grid step
    stream_chunk: int = 128  # unused here: Pallas lanes per walked chunk


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

    @property
    def pix(self):  # (N, 2)
        return torch.stack([self.pix_x, self.pix_y], dim=-1)

    @property
    def conic(self):  # (N, 3)
        return torch.stack([self.conic_a, self.conic_b, self.conic_c], dim=-1)

    @property
    def color(self):  # (N, 3)
        return torch.stack([self.color_r, self.color_g, self.color_b], dim=-1)


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


# ---------------------------------------------------------------------------
# windowed path: dup-sort v2 selection
# ---------------------------------------------------------------------------

_COARSE = 4  # fine tiles per coarse tile edge
_SENT = 2 ** 31 - 1  # sort key of an unused duplication slot


def _depth_bits(ntt: int) -> int:
    """Depth-quantization bits so (ntt+1) * 2^bits stays inside int32."""
    return 31 - int(ntt + 1).bit_length()


def _dup_levels(pre: Preprocessed, camera: Camera, cfg: RasterConfig):
    """Level and tile assignment shared by the selection and cap sizing.

    Each valid gaussian lands in exactly one stream: fine B-px tiles when
    its screen rect spans <= 2x2 of them, coarse 4B-px tiles when <= 2x2 of
    those, else the single global bucket; it emits up to 4 tiles of that
    stream (the corners of its rect)."""
    B = cfg.block
    dev = pre.pix_x.device
    origins, nbx, nby = block_origins(camera, cfg, dev)
    ncx, ncy = -(-nbx // _COARSE), -(-nby // _COARSE)
    nf = nbx * nby
    nc = ncx * ncy
    fx0, fx1, offx = _tile_interval(pre.pix_x, pre.radius, B, nbx)
    fy0, fy1, offy = _tile_interval(pre.pix_y, pre.radius, B, nby)
    valid = pre.valid & ~(offx | offy)
    spx, spy = fx1 - fx0, fy1 - fy0
    lvl0 = valid & (spx <= 1) & (spy <= 1)
    cx0, cx1 = fx0 // _COARSE, fx1 // _COARSE
    cy0, cy1 = fy0 // _COARSE, fy1 // _COARSE
    cspx, cspy = cx1 - cx0, cy1 - cy0
    lvl1 = valid & ~lvl0 & (cspx <= 1) & (cspy <= 1)
    lvl2 = valid & ~lvl0 & ~lvl1
    return dict(
        fx0=fx0, fy0=fy0, spx=spx, spy=spy, cx0=cx0, cy0=cy0,
        cspx=cspx, cspy=cspy, lvl0=lvl0, lvl1=lvl1, lvl2=lvl2,
        nf=nf, nc=nc, ncx=ncx, gid=nf + nc,
        origins=origins, nbx=nbx, nby=nby,
    )


def _dup_tile(lv: dict, dx: int, dy: int):
    """(tile id, ok) for duplication corner (dy, dx) of every gaussian."""
    ft = (lv["fy0"] + dy) * lv["nbx"] + (lv["fx0"] + dx)
    fok = lv["lvl0"] & (dx <= lv["spx"]) & (dy <= lv["spy"])
    ct = lv["nf"] + (lv["cy0"] + dy) * lv["ncx"] + (lv["cx0"] + dx)
    cok = lv["lvl1"] & (dx <= lv["cspx"]) & (dy <= lv["cspy"])
    gok = lv["lvl2"] & (dx == 0) & (dy == 0)
    tile = torch.where(fok, ft, torch.where(cok, ct, lv["gid"]))
    return tile, fok | cok | gok


def _sort_rows(dq: torch.Tensor, g: torch.Tensor):
    """Stable sort of each row by dq, g carried along (lax.sort's order)."""
    mdq, perm = torch.sort(dq, dim=1, stable=True)
    return mdq, torch.gather(g, 1, perm)


def _select_candidates_dupsort_v2(pre: Preprocessed, camera: Camera,
                                  cfg: RasterConfig,
                                  return_internals: bool = False):
    """Depth-in-key duplication-sort binning.

    Every gaussian emits at most 4 (key, index) pairs, key = tile *
    2^depth_bits + quantized depth (the top bits of the f32 depth, an
    order-preserving bitcast), into one level: fine, coarse or global.  One
    stable sort of the 4N pairs makes each tile's candidates a contiguous
    depth-ordered segment; each pixel block merges its fine, parent-coarse
    and global windows (depth-first, capped at k_tile / k_coarse /
    k_global) with one stable row sort on the depth.

    Returns (gidx (nblocks, K) int32, counts (nblocks,), origins
    (nblocks, 2) int32, n_dropped), K = k_tile + k_coarse + k_global (each
    at most N); gidx rows hold real candidates first (padding points at
    gaussian 0, masked by counts).  n_dropped counts candidates beyond a
    stream's cap.
    """
    n = pre.pix_x.shape[0]
    n4 = 4 * n
    dev = pre.pix_x.device
    i32 = dict(dtype=torch.int32, device=dev)
    lv = _dup_levels(pre, camera, cfg)
    origins, nbx, nby = lv["origins"], lv["nbx"], lv["nby"]
    nf, nc, ncx, gid = lv["nf"], lv["nc"], lv["ncx"], lv["gid"]
    ntt = nf + nc + 1
    db = _depth_bits(ntt)
    M = 1 << db

    # order-preserving depth quantization (depth > 0 wherever valid)
    dq = torch.clamp_min(pre.depth, cfg.z_near).view(torch.int32) >> (31 - db)
    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            tile, ok = _dup_tile(lv, dx, dy)
            keys.append(torch.where(ok, tile * M + dq, _SENT))
    keys = torch.cat(keys).to(torch.int32)
    pays = torch.arange(n, **i32).repeat(4)
    skeys, perm = torch.sort(keys, stable=True)
    spay = pays[perm]
    bounds = torch.searchsorted(
        skeys, torch.arange(ntt + 1, **i32) * M).to(torch.int32)
    st = torch.stack([skeys, spay])  # (2, 4N)
    itl = dict(st=st, bounds=bounds, M=M, n4=n4)

    bx = torch.arange(nbx, **i32)
    by = torch.arange(nby, **i32)
    t_f = (by[:, None] * nbx + bx[None, :]).reshape(-1)
    k0 = min(cfg.k_tile, n)
    k1 = min(cfg.k_coarse, n)
    k2 = min(cfg.k_global, n)
    dq_f, g_f = _stream_windows(itl, t_f, k0)
    dq_c_all, g_c_all = _stream_windows(itl, nf + torch.arange(nc, **i32), k1)
    parent = ((by[:, None] // _COARSE) * ncx
              + (bx[None, :] // _COARSE)).reshape(-1).to(torch.int64)
    dq_c, g_c = dq_c_all[parent], g_c_all[parent]
    dq_g1, g_g1 = _stream_windows(itl, torch.full((1,), gid, **i32), k2)
    dq_g = dq_g1.expand(nf, k2)
    g_g = g_g1.expand(nf, k2)

    mdq, gidx = _sort_rows(torch.cat([dq_f, dq_c, dq_g], dim=1),
                           torch.cat([g_f, g_c, g_g], dim=1))
    counts = torch.sum(mdq < _SENT, dim=1).to(torch.int32)

    # cap-overflow accounting: candidates beyond a stream's depth-first cap
    seg = bounds[1:] - bounds[:-1]
    caps = torch.cat([torch.full((nf,), k0, **i32),
                      torch.full((nc,), k1, **i32),
                      torch.full((1,), k2, **i32)])
    n_dropped = torch.sum(torch.clamp_min(seg - caps, 0))
    origins = origins.to(torch.int32)
    if return_internals:
        itl.update(nf=nf, nc=nc, parent=parent, seg=seg, k0=k0, k1=k1, k2=k2,
                   dq_c_all=dq_c_all, g_c_all=g_c_all, dq_g1=dq_g1,
                   g_g1=g_g1)
        return gidx, counts, origins, n_dropped, itl
    return gidx, counts, origins, n_dropped


def _stream_windows(itl: dict, tile_ids: torch.Tensor, k: int):
    """Depth-first (dq, gaussian index) windows of width k over the given
    tiles' sorted segments, _SENT / 0 past a segment's end."""
    st, bounds, M, n4 = itl["st"], itl["bounds"], itl["M"], itl["n4"]
    tid = tile_ids.to(torch.int64)
    s = bounds[tid]
    e = bounds[tid + 1]
    w = s[:, None] + torch.arange(k, dtype=torch.int32, device=s.device)
    wf = torch.clamp_max(w, n4 - 1).reshape(-1).to(torch.int64)
    kk = st[:, wf].reshape(2, *w.shape)
    live = w < e[:, None]
    dqw = torch.where(live, kk[0] & (M - 1), _SENT)
    gw = torch.where(live, kk[1], 0)
    return dqw, gw


def _gather_candidates(pre: Preprocessed, gidx: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """(10, nblocks, K) candidate planes for the blend: one gather of
    nblocks*K indices from the (10, N) planes; slots past a block's count
    get log opacity -1e30 and blend to nothing."""
    planes = _raw_planes_nosentinel(pre)
    nb, K = gidx.shape
    # index_select: its backward is an index_add_, where advanced
    # indexing's backward sorts the nblocks*K indices first
    cand = planes.index_select(1, gidx.reshape(-1).to(torch.int64)).reshape(
        10, nb, K)
    live = torch.arange(K, device=gidx.device)[None, :] < counts[:, None]
    logo = torch.where(live, cand[5], -1e30)
    return torch.cat([cand[:5], logo[None], cand[6:]], dim=0)


def _dense_tiles(seg_f: torch.Tensor, nd: int):
    """(counts, ids) of the nd longest fine segments; ties go to the lower
    tile id (lax.top_k's order)."""
    cnt, ids = torch.sort(seg_f, descending=True, stable=True)
    return cnt[:nd], ids[:nd]


def _render_two_tier(pre: Preprocessed, camera, bg, cfg: RasterConfig):
    """Two-tier windowed render (cfg.k_dense > 0), gsmpm_tpu's
    _render_pallas_two_tier.

    Tier 1 is the windowed blend at k_tile for every block; the n_dense
    fine tiles with the longest segments get a tier-2 window at k_dense and
    their blocks are re-blended over tier 1's.  Returns (image, n_dropped):
    overflow beyond k_dense on the dense tiles, beyond k_tile on the rest,
    and beyond the coarse / global caps."""
    from gsmpm_tpu_torch.render.cuda_blend import blend_blocks

    gidx, counts, origins, _, itl = _select_candidates_dupsort_v2(
        pre, camera, cfg, return_internals=True)
    cand = _gather_candidates(pre, gidx, counts)
    blocks = blend_blocks(cand, counts, origins, bg, cfg)

    dtiles, gidx_d, counts_d, dropped = _dense_selection(
        itl, pre.pix_x.shape[0], cfg)
    cand_d = _gather_candidates(pre, gidx_d, counts_d)
    blocks_d = blend_blocks(cand_d, counts_d, origins[dtiles], bg, cfg)
    blocks = blocks.index_copy(0, dtiles, blocks_d)
    return assemble_blocks(blocks, camera, cfg), dropped


def _dense_selection(itl: dict, n: int, cfg: RasterConfig):
    """Tier 2 of the two-tier render: (dense tile ids (nd,), gidx (nd, K2),
    counts (nd,), n_dropped of the whole two-tier render)."""
    nf = itl["nf"]
    seg_f = itl["seg"][:nf]
    nd = min(cfg.n_dense, nf)
    kd = min(cfg.k_dense, n)
    dcnt, dtiles = _dense_tiles(seg_f, nd)

    dq_d, g_d = _stream_windows(itl, dtiles, kd)
    par = itl["parent"][dtiles]
    k2 = itl["k2"]
    mdq, gidx_d = _sort_rows(
        torch.cat([dq_d, itl["dq_c_all"][par],
                   itl["dq_g1"].expand(nd, k2)], dim=1),
        torch.cat([g_d, itl["g_c_all"][par], itl["g_g1"].expand(nd, k2)],
                  dim=1))
    counts_d = torch.sum(mdq < _SENT, dim=1).to(torch.int32)
    dropped = (
        torch.sum(torch.clamp_min(seg_f - itl["k0"], 0))
        - torch.sum(torch.clamp_min(dcnt - itl["k0"], 0))
        + torch.sum(torch.clamp_min(dcnt - kd, 0))
        + torch.sum(torch.clamp_min(itl["seg"][nf:nf + itl["nc"]]
                                    - itl["k1"], 0))
        + torch.clamp_min(itl["seg"][-1] - itl["k2"], 0)
    )
    return dtiles, gidx_d, counts_d, dropped


def _packed_candidates(pre: Preprocessed, gidx, counts, origins,
                       cfg: RasterConfig):
    """Pack the merged per-block windows into one compact stream
    (gsmpm_tpu's _render_pallas_packed).

    Block b owns slots [offs[b], offs[b] + ceil(count_b / C) * C) of a
    (10, t_cap) candidate array, offsets C-aligned (C the blend chunk).
    Blocks whose slice would pass t_cap are dropped whole.  The gather is
    t_cap indices instead of nblocks * K.  Returns (cand (10, t_cap), slot
    origins x0, y0 (t_cap,), counts (nblocks,) int32 with the dropped
    blocks' set to 0, offs (nblocks,) int32, candidates dropped)."""
    from gsmpm_tpu_torch.render.cuda_blend import _blend_meta

    nb, K = gidx.shape
    dev = gidx.device
    C, n_chunks, _ = _blend_meta(cfg.k_tile + cfg.k_coarse + cfg.k_global,
                                 cfg)
    t_cap = min(cfg.t_cap, nb * n_chunks * C)
    t_cap = -(-t_cap // C) * C
    counts_c = torch.clamp_max(counts, K)
    aligned = ((counts_c + C - 1) // C) * C
    offs = (torch.cumsum(aligned, 0) - aligned).to(torch.int32)
    fits = offs + aligned <= t_cap
    counts_eff = torch.where(fits, counts_c, 0).to(torch.int32)
    dropped = torch.sum(torch.where(fits, 0, counts_c))

    # slot -> block map without a search: one marker per block start, then
    # a cumulative sum (the JAX package's construction)
    mark = torch.zeros((t_cap + 1,), dtype=torch.int32, device=dev)
    mark.index_add_(0, torch.clamp_max(offs, t_cap).to(torch.int64),
                    torch.ones_like(offs))
    b = torch.clamp(torch.cumsum(mark[:t_cap], 0) - 1, 0, nb - 1)
    j = torch.arange(t_cap, device=dev) - offs[b]
    live = (j >= 0) & (j < counts_eff[b])
    src = b * K + torch.clamp(j, 0, K - 1)
    pg = torch.where(live, gidx.reshape(-1)[src], 0)

    planes = _raw_planes_nosentinel(pre)
    cand = planes.index_select(1, pg.to(torch.int64))  # (10, t_cap)
    logo = torch.where(live, cand[5], -1e30)
    cand = torch.cat([cand[:5], logo[None], cand[6:]], dim=0)
    org = origins.to(torch.float32)
    return cand, org[b, 0], org[b, 1], counts_eff, offs, dropped


def _render_packed(pre: Preprocessed, gidx, counts, origins, dropped, bg,
                   camera, cfg: RasterConfig):
    """The packed windowed render (kernels K8 / K9): (image, n_dropped),
    the candidates of blocks past t_cap counted in n_dropped."""
    from gsmpm_tpu_torch.render.cuda_blend import blend_packed

    cand, x0, y0, counts_eff, offs, over = _packed_candidates(
        pre, gidx, counts, origins, cfg)
    blocks = blend_packed(cand, x0, y0, counts_eff, offs, bg, cfg)
    return assemble_blocks(blocks, camera, cfg), dropped + over


def _render_windowed(pre: Preprocessed, camera, bg, cfg: RasterConfig):
    """Windowed render: selection, gather and the blend; gsmpm_tpu's
    _render_pallas_fwd_impl (two tier when k_dense > 0, else packed or
    padded).  Returns (image, n_dropped)."""
    from gsmpm_tpu_torch.render.cuda_blend import blend_blocks

    if cfg.k_dense > 0:
        return _render_two_tier(pre, camera, bg, cfg)
    gidx, counts, origins, dropped = _select_candidates_dupsort_v2(
        pre, camera, cfg)
    if cfg.packed:
        return _render_packed(pre, gidx, counts, origins, dropped, bg, camera,
                              cfg)
    cand = _gather_candidates(pre, gidx, counts)
    blocks = blend_blocks(cand, counts, origins, bg, cfg)
    return assemble_blocks(blocks, camera, cfg), dropped


def render(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacity: torch.Tensor,
    shs: Optional[torch.Tensor],
    camera: Camera,
    bg: torch.Tensor,
    sh_degree: int = 3,
    cfg: RasterConfig = RasterConfig(),
    colors_precomp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rasterize to an (H, W, 3) image (render_with_aux without n_dropped)."""
    img, _ = render_with_aux(means3d, cov6, opacity, shs, camera, bg,
                             sh_degree, cfg, colors_precomp)
    return img


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

    n_dropped counts candidates beyond the caps (stream tier budgets, the
    windowed path's per-stream caps, the packed stream's t_cap); the
    reference has no caps, so callers resize and re-render when it is > 0.
    Differentiable on every path.
    """
    pre = preprocess(means3d, cov6, opacity, shs, camera, sh_degree, cfg,
                     colors_precomp)
    if cfg.stream:
        from gsmpm_tpu_torch.render.stream_raster import render_stream

        return render_stream(pre, camera, bg, cfg)
    return _render_windowed(pre, camera, bg, cfg)


def _xla_stream_counts(pre: Preprocessed, camera: Camera, cfg: RasterConfig):
    """(row_cnt (nby,), blk_cnt (nby, nbx)) intersection counts of the XLA
    path's two selection stages (row interval test, then block rect test)."""
    B = cfg.block
    dev = pre.pix_x.device
    _, nbx, nby = block_origins(camera, cfg, dev)
    y0s = torch.arange(nby, dtype=torch.float32, device=dev)[:, None] * B
    inter_y = ((pre.pix_y[None, :] + pre.radius[None, :] >= y0s - 0.5)
               & (pre.pix_y[None, :] - pre.radius[None, :] <= y0s + B - 0.5)
               & pre.valid[None, :])
    row_cnt = torch.sum(inter_y, dim=1)
    x0s = torch.arange(nbx, dtype=torch.float32, device=dev)[:, None] * B
    inter_x = ((pre.pix_x[None, :] + pre.radius[None, :] >= x0s - 0.5)
               & (pre.pix_x[None, :] - pre.radius[None, :] <= x0s + B - 0.5))
    blk_cnt = torch.stack([torch.sum(inter_y[r][None, :] & inter_x, dim=1)
                           for r in range(nby)])
    return row_cnt, blk_cnt


def _xla_dropped_count(pre: Preprocessed, camera: Camera,
                       cfg: RasterConfig) -> torch.Tensor:
    """Candidates beyond render_block_rows' k_row / k_block caps."""
    n = pre.pix_x.shape[0]
    k_row = min(cfg.k_row, n)
    k_blk = min(cfg.k_block, k_row)
    row_cnt, blk_cnt = _xla_stream_counts(pre, camera, cfg)
    return (torch.sum(torch.clamp_min(row_cnt - k_row, 0))
            + torch.sum(torch.clamp_min(blk_cnt - k_blk, 0)))


def _first_k(hit: torch.Tensor, k: int):
    """Per row of the (..., L) mask hit: (the column indices of its first k
    hits, in order, zero-filled (..., k); their count (...,)) -- lax.top_k
    of -rank over the hits, lower index first."""
    pos = torch.cumsum(hit.to(torch.int32), dim=-1) - 1
    take = hit & (pos < k)
    idx = torch.zeros(hit.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=hit.device)
    col = torch.arange(hit.shape[-1], device=hit.device).expand(hit.shape)
    idx.scatter_(-1, torch.where(take, pos, k).to(torch.int64), col)
    return idx[..., :k], torch.clamp_max(torch.sum(hit, dim=-1), k)


def block_rows_candidates(pre: Preprocessed, order: torch.Tensor,
                          y_start: float, nby_local: int, nbx: int,
                          cfg: RasterConfig):
    """The candidate windows of nby_local full block rows starting at
    pixel row y_start: (cand (10, nby_local * nbx, K) depth-ordered planes,
    counts (nblocks,), origins (nblocks, 2)), K = min(k_block, k_row, N).

    gsmpm_tpu's two-stage selection (render_block_rows): per row the first
    k_row depth-ordered gaussians (``order``) crossing the row's
    y-interval, then per block the first k_block of those crossing its
    x-interval; slots past a block's count get log opacity -1e30.
    """
    B = cfg.block
    dev = pre.pix_x.device
    n = pre.pix_x.shape[0]
    k_row = min(cfg.k_row, n)
    k_blk = min(cfg.k_block, k_row)
    planes = _raw_planes_nosentinel(pre)[:, order]      # (10, N) by depth
    f32 = dict(dtype=torch.float32, device=dev)
    y0 = y_start + torch.arange(nby_local, **f32) * B
    x0 = torch.arange(nbx, **f32) * B
    sy, sr = planes[1], planes[9]
    inter_y = ((sy + sr >= y0[:, None] - 0.5)
               & (sy - sr <= y0[:, None] + B - 0.5) & pre.valid[order])
    ridx, rcnt = _first_k(inter_y, k_row)               # (R, k_row)
    rows = planes[:, ridx]                              # (10, R, k_row)
    row_ok = torch.arange(k_row, device=dev) < rcnt[:, None]
    cx, cr = rows[0][:, None, :], rows[9][:, None, :]
    inter_x = ((cx + cr >= x0[None, :, None] - 0.5)
               & (cx - cr <= x0[None, :, None] + B - 0.5)
               & row_ok[:, None, :])                    # (R, nbx, k_row)
    bidx, counts = _first_k(inter_x, k_blk)             # (R, nbx, k_blk)
    cand = torch.gather(
        rows[:, :, None, :].expand(10, nby_local, nbx, k_row), 3,
        bidx[None].expand(10, -1, -1, -1),
    ).reshape(10, nby_local * nbx, k_blk)
    counts = counts.reshape(-1)
    live = torch.arange(k_blk, device=dev)[None, :] < counts[:, None]
    cand = torch.cat([cand[:5], torch.where(live, cand[5], -1e30)[None],
                      cand[6:]])
    origins = torch.stack([x0.repeat(nby_local),
                           y0.repeat_interleave(nbx)], dim=-1)
    return cand, counts, origins


def render_block_rows(pre: Preprocessed, order: torch.Tensor, y_start: float,
                      nby_local: int, nbx: int, bg: torch.Tensor,
                      cfg: RasterConfig) -> torch.Tensor:
    """Render nby_local full block rows starting at pixel row y_start:
    (nby_local * nbx, B, B, 3) row-major blocks.  Each block's window
    (block_rows_candidates) blends with kernel K4
    (cuda_blend.blend_blocks), the counterpart of gsmpm_tpu's
    ``_blend_candidates``."""
    from gsmpm_tpu_torch.render.cuda_blend import blend_blocks

    cand, counts, origins = block_rows_candidates(pre, order, y_start,
                                                  nby_local, nbx, cfg)
    return blend_blocks(cand, counts, origins, bg, cfg)


def required_raster_caps(means3d: torch.Tensor, cov6: torch.Tensor,
                         opacity: torch.Tensor, camera: Camera,
                         cfg: RasterConfig = RasterConfig()) -> dict:
    """Measured per-stream candidate maxima of this geometry: the caps at
    which the windowed render reports n_dropped == 0.  Selection is
    geometry only, so no SH evaluation runs.

    Returns {"k_tile", "k_coarse", "k_global", "k_row", "k_block",
    "n_fine_over"} ints; n_fine_over counts the fine tiles over the current
    k_tile (the blocks the two-tier path must re-blend).
    """
    zeros3 = torch.zeros((means3d.shape[0], 3), dtype=torch.float32,
                         device=means3d.device)
    pre = preprocess(means3d, cov6, opacity, None, camera, 0, cfg,
                     colors_precomp=zeros3)
    lv = _dup_levels(pre, camera, cfg)
    nf, nc, gid = lv["nf"], lv["nc"], lv["gid"]
    hist = torch.zeros((nf + nc + 1,), dtype=torch.int64,
                       device=means3d.device)
    for dy in (0, 1):
        for dx in (0, 1):
            tile, ok = _dup_tile(lv, dx, dy)
            hist.index_add_(0, torch.where(ok, tile, 0).to(torch.int64),
                            ok.to(torch.int64))
    row_cnt, blk_cnt = _xla_stream_counts(pre, camera, cfg)
    return {
        "k_tile": int(torch.max(hist[:nf])),
        "k_coarse": int(torch.max(hist[nf:nf + nc])) if nc else 0,
        "k_global": int(hist[gid]),
        "k_row": int(torch.max(row_cnt)),
        "k_block": int(torch.max(blk_cnt)),
        "n_fine_over": int(torch.sum(hist[:nf] > min(cfg.k_tile,
                                                     means3d.shape[0]))),
    }


def bump_caps_for_dropfree(
    cfg: RasterConfig,
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
) -> RasterConfig:
    """Resize cfg so a re-render of THIS geometry is drop-free.

    Stream configs bump the tier budgets (measured populations +50%,
    rounded up to 32, with floors); windowed configs bump the two-tier K
    caps and the XLA row/block caps from required_raster_caps (+25%,
    rounded up to 128).  When the measurement already fits, every cap
    doubles.  The result is >= cfg in every cap."""
    if not cfg.stream:
        need = required_raster_caps(means3d, cov6, opacity, camera, cfg)

        def up(cur, needed):
            return max(cur, -(-int(needed * 1.25) // 128) * 128)

        _, nbx, nby = block_origins(camera, cfg)
        new = cfg._replace(
            k_dense=up(cfg.k_dense, need["k_tile"]),
            n_dense=max(cfg.n_dense, min(need["n_fine_over"] + 4, nbx * nby)),
            k_coarse=up(cfg.k_coarse, need["k_coarse"]),
            k_global=up(cfg.k_global, need["k_global"]),
            k_row=up(cfg.k_row, need["k_row"]),
            k_block=up(cfg.k_block, need["k_block"]),
        )
        if new == cfg:  # the measurement already fits: double
            new = cfg._replace(
                k_dense=2 * max(cfg.k_dense, cfg.k_tile),
                n_dense=min(2 * max(cfg.n_dense, 8), nbx * nby),
                k_row=2 * cfg.k_row, k_block=2 * cfg.k_block,
            )
        return new

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
