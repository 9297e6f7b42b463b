"""Host-side pieces of the K1 and K3 kernel designs, on the CPU.

K3 (csrc/stream_raster.cu) skips a staged slot for a warp's 16 x 8 pixel
group when the slot's box, ``stream_raster.cull_boxes``, misses the group:
every (slot, pixel) pair that passes the blend gate must lie inside the
box, or the kernel would drop a contributor; checked here against a
plain evaluation of the gate.  K1 (csrc/mpm_transfer.cu) runs one block
per chunk, all of a dense tile's blocks adding into one window; its dense
case is built here and checked through the twin.  The kernels themselves
are held against their twins in tests/test_torch_cuda.py.  No JAX: the
cull box has no counterpart in gsmpm_tpu (tests/test_torch_tiles.py holds
the dense case's twin against gsmpm_tpu's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsmpm_tpu_torch.render import stream_raster as sr
from gsmpm_tpu_torch.sim.tiles import TileConfig

ALPHA_MIN = 1.0 / 255.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def crafted_stream(nbx=2, nby=2, B=64, per_block=400, seed=0, device="cpu"):
    """A sorted stream built directly as planes: (splanes (9, L), bounds,
    nbx, B).  Per display block, splats centred from half a block before
    to half a block past it (straddling its pixel groups and its edges),
    conics of random rotation with sigmas from 0.3 to 40 pixels and axis
    ratios up to 50, opacities from 0.001 (below alpha_min) to 0.99; one
    slot in 40 has a conic that is not positive definite."""
    rng = np.random.default_rng(seed)
    nf = nbx * nby
    L = nf * per_block
    blk = np.repeat(np.arange(nf), per_block)
    p = np.zeros((9, L), np.float64)
    p[0] = (blk % nbx) * B + rng.uniform(-0.5 * B, 1.5 * B, L)
    p[1] = (blk // nbx) * B + rng.uniform(-0.5 * B, 1.5 * B, L)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(40.0), L))
    s2 = s1 * np.exp(rng.uniform(np.log(0.02), 0.0, L))
    th = rng.uniform(0.0, np.pi, L)
    cs, sn = np.cos(th), np.sin(th)
    # conic = R diag(1/s1^2, 1/s2^2) R^T
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    p[2] = cs * cs * i1 + sn * sn * i2
    p[3] = cs * sn * (i1 - i2)
    p[4] = sn * sn * i1 + cs * cs * i2
    bad = rng.uniform(size=L) < 1.0 / 40.0
    p[3] = np.where(bad, 1.5 * np.sqrt(p[2] * p[4]), p[3])
    p[5] = np.log(rng.uniform(0.001, 0.99, L))
    p[6:9] = rng.uniform(0.0, 1.0, (3, L))
    bounds = np.arange(nf + 1, dtype=np.int32) * per_block
    return (torch.from_numpy(p.astype(np.float32)).to(device),
            torch.from_numpy(bounds).to(device), nbx, B)


@pytest.mark.parametrize("seed,B", [(0, 64), (1, 80), (2, 32), (3, 16),
                                    (4, 48)])
def test_cull_box_holds_every_gated_pair(seed, B):
    splanes, bounds, nbx, _ = crafted_stream(B=B, seed=seed)
    nf = bounds.numel() - 1
    per = int(bounds[1] - bounds[0])
    bid = torch.arange(nf)
    x0 = ((bid % nbx) * B).float()
    y0 = ((bid // nbx) * B).float()
    p = splanes.reshape(9, nf, per)
    pix = sr._pixel_coords(B, splanes.device)
    gx, gy, _, _, _, gate = sr._chunk_power(
        p, x0, y0, torch.ones((nf, per), dtype=torch.bool), pix, ALPHA_MIN)
    xl, xh, yl, yh = sr.cull_boxes(gx, gy, p, ALPHA_MIN)
    px, py = pix[0], pix[1]
    inside = ((xl[..., None] <= px) & (px <= xh[..., None])
              & (yl[..., None] <= py) & (py <= yh[..., None]))
    assert int(gate.sum()) > 1000             # the stream blends
    assert not bool((gate & ~inside).any())   # no contributor is culled
    # the cull is not empty: faint and small splats leave most pairs out,
    # and the slots below alpha_min get an empty box
    assert float(inside.float().mean()) < 0.5
    faint = p[5] < np.log(ALPHA_MIN) - 1e-3
    assert bool(faint.any()) and bool(torch.isinf(xl[faint]).all())
    # a conic that is not positive definite is never culled by its box
    det = p[2] * p[4] - p[3] * p[3]
    loose = (det <= 0) & ~faint
    assert bool(loose.any()) and bool((xl[loose] == -np.inf).all())


def dense_tiled_state(device="cpu", seed=0, dead_chunk=40):
    """K1's dense case, bucketed by tiles.rebucket: (ts, sig, grid, tc,
    dt).  n_grid 16 (8 tiles); 20,000 particles packed into 3 x 3 x 3 cells
    of tile 0 (~740 a cell), 100 in tile 3 (a tile of one chunk), 6,000
    spread over tile 7; seeded velocity, APIC C, mass, volume and stress.
    The slack chunks at the end are dead, and so is ``dead_chunk`` (inside
    tile 0's 79 chunks; None keeps every chunk that holds particles
    live), so the kernel skips dead chunks among live ones."""
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.state import GridConfig

    rng = np.random.default_rng(seed)
    grid = GridConfig(16, 1.0)
    counts = {0: (20_000, 4.0, 3.0), 3: (100, 0.5, 7.0), 7: (6_000, 0.0, 8.0)}
    n = sum(c for c, _, _ in counts.values())
    tc = TileConfig(grid.n_grid, n, S=256, n_occ_cap=0)
    xs = []
    for t, (cnt, lo, width) in counts.items():
        org = np.array([t // 4, (t // 2) % 2, t % 2]) * 8.0
        xs.append((org + lo + rng.uniform(0.0, width, (cnt, 3))) * grid.dx)
    x = np.concatenate(xs).T
    q = np.zeros((tiles.QROWS, tc.np_rows), np.float32)
    q[tiles.RX:tiles.RX + 3, :n] = x
    q[tiles.RV:tiles.RV + 3, :n] = rng.normal(0.0, 2.0, (3, n))
    q[tiles.RC:tiles.RC + 9, :n] = rng.normal(0.0, 10.0, (9, n))
    for d in (0, 4, 8):
        q[tiles.RF + d] = q[tiles.RFT + d] = 1.0
    q[tiles.RMASS, :n] = rng.uniform(0.5, 1.5, n) * 1e-6
    q[tiles.RVOL, :n] = rng.uniform(0.5, 1.5, n) * 1e-6
    dev = torch.device(device)
    i32 = torch.zeros((tc.nchunk,), dtype=torch.int32, device=dev)
    ts0 = tiles.TiledState(
        q=torch.from_numpy(q).to(dev),
        aux=torch.zeros((tiles.AUXROWS, tc.np_rows), device=dev),
        material=torch.zeros((tc.np_rows,), dtype=torch.int32, device=dev),
        orig=torch.cat([torch.arange(n), torch.full((tc.np_rows - n,), -1)]
                       ).to(dev),
        chunk_tile=i32, chunk_first=i32, chunk_live=i32,
        need_rebucket=torch.zeros((), dtype=torch.bool, device=dev),
        ok=torch.ones((), dtype=torch.bool, device=dev))
    ts = tiles.rebucket(ts0, grid, tc)
    if dead_chunk is not None:
        live = ts.chunk_live.clone()
        live[dead_chunk] = 0
        ts = dataclasses.replace(ts, chunk_live=live)
    sig = torch.from_numpy(rng.normal(0.0, 1e4, (16, tc.np_rows)).astype(
        np.float32)).to(dev)
    return ts, sig, grid, tc, 1e-4


def test_p2g_twin_on_the_dense_case():
    """The dense case's shape (the CUDA tests hold K1 against the twin on
    it) and the twin's mass: all of it lands in the tiles that hold live
    chunks (the B-spline weights sum to one), none in the other five."""
    from gsmpm_tpu_torch.sim import tiles

    ts, sig, grid, tc, dt = dense_tiled_state()
    live = ts.chunk_live == 1
    per_tile = torch.bincount(ts.chunk_tile[live].long(), minlength=8)
    assert per_tile.tolist() == [78, 0, 0, 1, 0, 0, 0, 24]
    assert int((ts.chunk_live == 0).sum()) == tc.nchunk - 103
    win = tiles.p2g_tiled_ref(ts, sig, grid, tc, dt)
    mass = win.reshape(8, 8, 4, 8, 64)[:, :, 0].sum(dim=(1, 2, 3))
    m = ts.q[tiles.RMASS].reshape(-1, tc.S)[live].sum()
    torch.testing.assert_close(mass.sum(), m, rtol=1e-5, atol=0.0)
    assert float(win[per_tile == 0].abs().max()) == 0.0
    assert float(mass[3]) > 0.0
