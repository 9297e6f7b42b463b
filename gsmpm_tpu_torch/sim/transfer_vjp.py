"""Hand-written VJPs of the tiled MPM transfers (the fitting adjoint).

Port of gsmpm_tpu/sim/transfer_vjp.py.  ``p2g_fit`` / ``g2p_fit`` are
``torch.autograd.Function``s whose backward passes reuse the forward
transfer kernels (sim/cuda_mpm.py) on transformed payloads:

- the cotangent of G2P's grid input is a P2G-shaped scatter: the forward
  P2G with mass = vol = valid, v := v-hat_eff, C := C-hat/dx,
  sigma := grad-hat and dt := -1 yields sum_p [W v-hat + U^k C-hat + D^k
  grad-hat];
- the cotangents of P2G's particle inputs are G2P-shaped gathers: the
  forward G2P with ext := the window cotangent, F := I and dt := 1 yields
  <W-hat, W>, <W-hat, U^k> (C rows / 4 inv_dx) and <W-hat, D^k>
  (F_trial - I).

The position gradients' second-order terms (reductions against d/dx of
the basis products) come from ``cuda_mpm.sored_tiled``: kernel K6 on the
GPU, ``sored_tiled_ref`` (the chunk form below) on the CPU.  Per substep
the two backwards launch K1 once, K2 three times and K6 twice.
"""

from __future__ import annotations

import torch

from gsmpm_tpu_torch.sim import cuda_mpm
from gsmpm_tpu_torch.sim.state import GridConfig
from gsmpm_tpu_torch.sim.tiles import (
    LOCAL_MAX,
    LOCAL_MIN,
    PAD_LO,
    QROWS,
    RC,
    RF,
    RFT,
    RMASS,
    RV,
    RVOL,
    RX,
    RYIELD,
    T_TILE,
    TileConfig,
    TiledState,
    W_WIN,
    _tile_origins,
)

SORED_ROWS = 64  # 21 rows per window component, 3 components, padded
SORED_BATCH = 64  # chunks per step of the twin: pair tables of a few 100 MB


def _mk_ts(q, ct, cf, cl) -> TiledState:
    """TiledState for the transfer wrappers, which read q and the chunk
    tables only."""
    z = torch.zeros((q.shape[1],), dtype=torch.int32, device=q.device)
    flag = torch.zeros((), dtype=torch.bool, device=q.device)
    return TiledState(q=q, aux=q[:1], material=z, orig=z.long(),
                      chunk_tile=ct, chunk_first=cf, chunk_live=cl,
                      need_rebucket=flag, ok=~flag)


# ---------------------------------------------------------------------------
# second-order basis reductions: the plain twin of kernel K6
# ---------------------------------------------------------------------------

def _axis_bases2(xrow, torg, grid: GridConfig, tc: TileConfig):
    """Per chunk and axis: the 16-slot bases w, dw, u (as tiles._axis_bases)
    plus ddw = d(dw)/dx ({1, -2, 1} inv_dx^2) and du = dw (k - fx) -
    w inv_dx.  xrow (c, S), torg (c,) -> five (c, 16, S), out-of-domain
    slots folded onto the boundary cells."""
    g = tc.n_grid
    inv_dx = grid.inv_dx
    dev = xrow.device
    gp = xrow * inv_dx
    basef = torch.floor(gp - 0.5)
    fx = gp - basef
    basep = torch.clamp(basef, -1, g - 1).to(torch.int64) + PAD_LO
    local = torch.clamp(basep - torg[:, None], LOCAL_MIN, LOCAL_MAX)
    slots = torch.arange(W_WIN, dtype=torch.int64, device=dev)[None, :, None]
    k = slots - local[:, None, :]                       # (c, 16, S)
    kf = k.to(xrow.dtype)
    fxb = fx[:, None, :]
    zero = torch.zeros((), dtype=xrow.dtype, device=dev)

    def pick(v0, v1, v2):
        return torch.where(k == 0, v0, torch.where(
            k == 1, v1, torch.where(k == 2, v2, zero)))

    w = pick(0.5 * (1.5 - fxb) ** 2, 0.75 - (fxb - 1.0) ** 2,
             0.5 * (fxb - 0.5) ** 2)
    dw = pick((fxb - 1.5) * inv_dx, -2.0 * (fxb - 1.0) * inv_dx,
              (fxb - 0.5) * inv_dx)
    dd = inv_dx * inv_dx
    ddw = pick(torch.full_like(fxb, dd), torch.full_like(fxb, -2.0 * dd),
               torch.full_like(fxb, dd))
    u = w * (kf - fxb)
    du = dw * (kf - fxb) - w * inv_dx
    kk = torch.arange(W_WIN, dtype=torch.int64, device=dev)[None, None, :]
    tk = torch.clamp(kk + torg[:, None, None], PAD_LO, PAD_LO + g - 1) \
        - torg[:, None, None]
    M = (tk == slots).to(w.dtype)                       # (c, 16, 16)
    return tuple(M @ b for b in (w, dw, u, ddw, du))


def _pair_bc(a16, b16):
    """(c,16,S) x (c,16,S) -> (c,256,S) pair table in the window planes'
    (b, c, yl, zl) column order: row (b*2+c)*64 + yl*8 + zl holds
    a16[b*8+yl] * b16[c*8+zl]."""
    c, _, S = a16.shape
    a = a16.reshape(c, 2, 1, T_TILE, 1, S)
    b = b16.reshape(c, 1, 2, 1, T_TILE, S)
    return (a * b).reshape(c, 256, S)


def sored_tiled_ref(q, win_planes, chunk_tile, chunk_live, grid: GridConfig,
                    tc: TileConfig) -> torch.Tensor:
    """Plain twin of kernel K6: (SORED_ROWS, NP) reductions per slot.

    win_planes (ntiles, 48, 256): 3 components in [comp][i][(b,c,yl,zl)]
    layout.  Component c's rows: [21c + a] = <win_c, d_a W>,
    [21c + 3 + 3a + k] = <win_c, d_a U^k>, [21c + 12 + 3a + k] =
    <win_c, d_a D^k>.  Dead chunks and the padding row are zero.  Chunks go
    SORED_BATCH at a time, so the pair tables stay a few hundred MB at the
    fit path's size."""
    S = tc.S
    nchunk = chunk_tile.shape[0]
    out = torch.zeros((SORED_ROWS, q.shape[1]), dtype=q.dtype, device=q.device)
    for c0 in range(0, nchunk, SORED_BATCH):
        c1 = min(c0 + SORED_BATCH, nchunk)
        nb = c1 - c0
        ct = chunk_tile[c0:c1].to(torch.int64)
        qc = q[:, c0 * S:c1 * S].reshape(QROWS, nb, S).permute(1, 0, 2)
        torg = _tile_origins(ct, tc)
        wx, dwx, ux, ddx, dux = _axis_bases2(qc[:, RX], torg[0], grid, tc)
        wy, dwy, uy, ddy, duy = _axis_bases2(qc[:, RX + 1], torg[1], grid, tc)
        wz, dwz, uz, ddz, duz = _axis_bases2(qc[:, RX + 2], torg[2], grid, tc)
        P = {
            "ww": _pair_bc(wy, wz), "dw": _pair_bc(dwy, wz),
            "wd": _pair_bc(wy, dwz), "uw": _pair_bc(uy, wz),
            "wu": _pair_bc(wy, uz), "Du": _pair_bc(duy, wz),
            "ud": _pair_bc(uy, dwz), "du_": _pair_bc(dwy, uz),
            "uD": _pair_bc(wy, duz), "ad": _pair_bc(ddy, wz),
            "dd": _pair_bc(dwy, dwz), "da": _pair_bc(wy, ddz),
        }
        G = win_planes[ct].reshape(nb, 3, W_WIN, 256)
        live = (chunk_live[c0:c1] == 1).to(q.dtype)[:, None]
        rows = []
        for c in range(3):
            Gc = G[:, c]

            def A(X):  # (nb,16,S) x (nb,16,256) -> (nb,S,256)
                return torch.bmm(X.transpose(1, 2), Gc)

            AW, AD, AU, ADD, ADU = A(wx), A(dwx), A(ux), A(ddx), A(dux)

            def red(Ax, key):
                return torch.sum(Ax * P[key].transpose(1, 2), dim=2)

            rows += [red(AD, "ww"), red(AW, "dw"), red(AW, "wd")]
            rows += [red(ADU, "ww"), red(AD, "uw"), red(AD, "wu"),
                     red(AU, "dw"), red(AW, "Du"), red(AW, "du_"),
                     red(AU, "wd"), red(AW, "ud"), red(AW, "uD")]
            rows += [red(ADD, "ww"), red(AD, "dw"), red(AD, "wd"),
                     red(AD, "dw"), red(AW, "ad"), red(AW, "dd"),
                     red(AD, "wd"), red(AW, "dd"), red(AW, "da")]
        blk = torch.stack(rows, dim=1) * live[:, :, None]    # (nb, R, S)
        out[:len(rows), c0 * S:c1 * S] = blk.permute(1, 0, 2).reshape(
            len(rows), nb * S)
    return out


def _sored_all(q, planes, chunk_tile, chunk_live, grid, tc):
    """Second-order reductions against window planes (ntiles, 3, 16, 256):
    (U (3, 3, 3, NP), D (3, 3, 3, NP)) indexed [comp, a, k], through
    ``cuda_mpm.sored_tiled``."""
    nt = planes.shape[0]
    rows = cuda_mpm.sored_tiled(q, planes.reshape(nt, 3 * W_WIN, 256)
                                .contiguous(), chunk_tile, chunk_live,
                                grid, tc)
    r = rows[:63].reshape(3, 21, -1)
    return (r[:, 3:12].reshape(3, 3, 3, -1), r[:, 12:21].reshape(3, 3, 3, -1))


def _win_to_planes(windows):
    """Octant P2G windows (ntiles, 256, 64) -> per-comp (ntiles, 4, 16, 256)
    planes [comp][a*8+xl][(b*2+c)*64 + yl*8 + zl]."""
    nt = windows.shape[0]
    a = windows.reshape(nt, 2, 4, 4, 8, 64)   # (t, a, bc, comp, xl, col)
    return a.permute(0, 3, 1, 4, 2, 5).reshape(nt, 4, 16, 256)


def _ext_to_planes(ext):
    """G2P blocks (ntiles, 192, 64) -> (ntiles, 3, 16, 256) planes."""
    nt = ext.shape[0]
    a = ext.reshape(nt, 2, 4, 3, 8, 64)
    return a.permute(0, 3, 1, 4, 2, 5).reshape(nt, 3, 16, 256)


def _identity_F(q):
    """q with the F rows set to the identity (the fake G2P calls)."""
    qI = q.clone()
    qI[RF:RF + 9] = 0.0
    for d in (0, 4, 8):
        qI[RF + d] = 1.0
    return qI


def _delta(r, k):
    return 1.0 if r == k else 0.0


# ---------------------------------------------------------------------------
# P2G with a hand-written VJP
# ---------------------------------------------------------------------------

class _P2GFit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, sig, ct, cf, cl, grid, tc, dt):
        out = cuda_mpm.p2g_tiled(_mk_ts(q, ct, cf, cl), sig, grid, tc, dt)
        ctx.save_for_backward(q, sig, ct, cf, cl)
        ctx.cfg = (grid, tc, dt)
        return out

    @staticmethod
    def backward(ctx, What):
        q, sig, ct, cf, cl = ctx.saved_tensors
        grid, tc, dt = ctx.cfg
        What = What.contiguous()
        m, vol = q[RMASS], q[RVOL]
        valid = m > 0
        dx, kappa = grid.dx, 4.0 * grid.inv_dx
        nt = What.shape[0]
        wp = What.reshape(nt, 8, 4, 8, 64)
        qI = _identity_F(q)
        ts = _mk_ts(qI, ct, cf, cl)

        # fake G2P 1: ext := momentum cotangent -> <What_r, W>, <What_r,
        # U^k> (C rows / kappa), <What_r, D^k> (F_trial - I)
        ext1 = wp[:, :, 1:4].reshape(nt, 192, 64).contiguous()
        out1 = cuda_mpm.g2p_tiled(ts, ext1, grid, tc, 1.0)
        # fake G2P 2: mass cotangent in component 0 -> <What_0, D^a>
        ext0 = torch.cat([wp[:, :, 0:1], torch.zeros_like(wp[:, :, 0:2])],
                         dim=2).reshape(nt, 192, 64)
        out0 = cuda_mpm.g2p_tiled(ts, ext0, grid, tc, 1.0)

        def on_valid(x):
            return torch.where(valid, x, 0.0)

        Dred = [[out1[RFT + 3 * r + k] - _delta(r, k) for k in range(3)]
                for r in range(3)]
        dq = torch.zeros_like(q)
        dsig = torch.zeros_like(sig)
        for r in range(3):
            dq[RV + r] = on_valid(m * out1[RV + r])
            for k in range(3):
                dq[RC + 3 * r + k] = on_valid(m * dx * (out1[RC + 3 * r + k]
                                                        / kappa))
                dsig[3 * r + k] = on_valid(-dt * vol * Dred[r][k])
        # position: first-order terms from the recovered reductions
        dxa = [on_valid(m * (out0[RFT + a] - _delta(0, a))) for a in range(3)]
        for r in range(3):
            vr = m * q[RV + r]
            for a in range(3):
                dxa[a] = dxa[a] + on_valid(vr * Dred[r][a])
        # second-order terms against d_a U^k and d_a D^k
        U2, D2 = _sored_all(q, _win_to_planes(What)[:, 1:4], ct, cl, grid, tc)
        for r in range(3):
            for k in range(3):
                cU = m * dx * q[RC + 3 * r + k]
                cD = -dt * vol * sig[3 * r + k]
                for a in range(3):
                    dxa[a] = dxa[a] + on_valid(cU * U2[r, a, k]
                                               + cD * D2[r, a, k])
        for a in range(3):
            dq[RX + a] = dxa[a]
        return dq, dsig, None, None, None, None, None, None


def p2g_fit(q, sig, ct, cf, cl, grid: GridConfig, tc: TileConfig, dt: float):
    """Differentiable tiled P2G: (q, sig) -> octant windows (kernel K1)."""
    return _P2GFit.apply(q.contiguous(), sig.contiguous(), ct, cf, cl,
                         grid, tc, dt)


# ---------------------------------------------------------------------------
# G2P with a hand-written VJP (fitting semantics: F' written to RFT)
# ---------------------------------------------------------------------------

class _G2PFit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, ext, ct, cf, cl, grid, tc, dt):
        out = cuda_mpm.g2p_tiled(_mk_ts(q, ct, cf, cl), ext, grid, tc, dt)
        ctx.save_for_backward(q, ext, ct, cf, cl)
        ctx.cfg = (grid, tc, dt)
        return out

    @staticmethod
    def backward(ctx, ghat):
        q, ext, ct, cf, cl = ctx.saved_tensors
        grid, tc, dt = ctx.cfg
        ghat = ghat.contiguous()
        m = q[RMASS]
        valid = m > 0
        dx, kappa = grid.dx, 4.0 * grid.inv_dx

        def on_valid(x):
            return torch.where(valid, x, 0.0)

        # grad v from a fake G2P (F := I, dt := 1): F'_rc = F_rc + dt
        # sum_k grad_rk F_kc cannot be inverted for a general F
        outI = cuda_mpm.g2p_tiled(_mk_ts(_identity_F(q), ct, cf, cl), ext,
                                  grid, tc, 1.0)
        gradv = [[outI[RFT + 3 * r + k] - _delta(r, k) for k in range(3)]
                 for r in range(3)]
        vhat = [ghat[RV + r] + dt * ghat[RX + r] for r in range(3)]
        gh = [[dt * sum(ghat[RFT + 3 * r + c] * q[RF + 3 * k + c]
                        for c in range(3)) for k in range(3)]
              for r in range(3)]
        Chat = [[kappa * ghat[RC + 3 * r + k] for k in range(3)]
                for r in range(3)]

        # d ext: fake P2G with payloads (mass = vol = valid, v = vhat,
        # C = Chat/dx, sigma = grad-hat, dt = -1)
        vf = valid.to(q.dtype)
        qf = q.clone()
        qf[RMASS] = vf
        qf[RVOL] = vf
        sigf = torch.zeros((16, q.shape[1]), dtype=q.dtype, device=q.device)
        for r in range(3):
            qf[RV + r] = on_valid(vhat[r])
            for k in range(3):
                qf[RC + 3 * r + k] = on_valid(Chat[r][k] / dx)
                sigf[3 * r + k] = on_valid(gh[r][k])
        win = cuda_mpm.p2g_tiled(_mk_ts(qf, ct, cf, cl), sigf, grid, tc, -1.0)
        nt = win.shape[0]
        dext = win.reshape(nt, 8, 4, 8, 64)[:, :, 1:4].reshape(nt, 192, 64)

        dq = torch.zeros_like(q)
        # F'_rc = sum_k (delta_rk + dt grad_rk) F_kc on valid slots, F_rc
        # elsewhere; the RF rows pass through
        for k in range(3):
            for c in range(3):
                dq[RF + 3 * k + c] = (
                    ghat[RF + 3 * k + c] + ghat[RFT + 3 * k + c]
                    + on_valid(dt * sum(gradv[r][k] * ghat[RFT + 3 * r + c]
                                        for r in range(3))))
        # position: first-order (v-hat against D^a) + second-order terms
        dxa = [sum(on_valid(vhat[r] * gradv[r][a]) for r in range(3))
               for a in range(3)]
        U2, D2 = _sored_all(q, _ext_to_planes(ext), ct, cl, grid, tc)
        for r in range(3):
            for k in range(3):
                for a in range(3):
                    dxa[a] = dxa[a] + on_valid(Chat[r][k] * U2[r, a, k]
                                               + gh[r][k] * D2[r, a, k])
        for a in range(3):
            # invalid slots: G2P passes x through
            dq[RX + a] = torch.where(valid, ghat[RX + a] + dxa[a],
                                     ghat[RX + a])
        for row in (RMASS, RVOL, RYIELD):
            dq[row] = ghat[row]
        return dq, dext, None, None, None, None, None, None


def g2p_fit(q, ext, ct, cf, cl, grid: GridConfig, tc: TileConfig, dt: float):
    """Differentiable tiled G2P: (q, ext) -> q' (x, v, C, F_trial updated;
    kernel K2)."""
    return _G2PFit.apply(q.contiguous(), ext.contiguous(), ct, cf, cl,
                         grid, tc, dt)
