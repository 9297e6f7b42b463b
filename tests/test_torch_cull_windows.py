"""The cull of the windowed blend walks (K4 / K8 forward, K5 / K9
backward), on the CPU.

csrc/tile_blend.cu skips a staged candidate for a warp's 16 x 8 pixel
group, and for a pixel, when the candidate's box misses it; the box is
derived from the candidate's F rows alone (``cuda_blend.window_boxes``,
the kernel's expressions in plain torch).  Every (candidate, pixel) pair
that passes the blend gate must lie inside the box, or the kernel would
drop a contributor; checked here against the twins' own gate on crafted
windows built through ``cuda_blend._build_F``, and a forward walk that
skips the pairs outside the box must give the unculled walk's bits.  The
kernels are held against their twins in tests/test_torch_cuda.py.  No
JAX: the box has no counterpart in gsmpm_tpu.
"""

import numpy as np
import pytest
import torch

from gsmpm_tpu_torch.render import cuda_blend as cb

ALPHA_MIN = 1.0 / 255.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def crafted_windows(B, nb=3, K=256, seed=0):
    """(F (nb, 16, K), kinds) of candidate windows at block origins far
    from the image's corner.  Splats centred from half a block before to
    half a block past their block, sigmas 0.3 to 40 pixels with axis ratios
    up to 100 and random rotation, opacities from 0.001 (below alpha_min)
    to 0.99 with one in 8 at 0.99 or above; one candidate in 25 has a conic
    that is not positive definite, one in 25 a near-singular one, one in
    25 is a dead column (log opacity -1e30), and the window's last 16
    columns are padding (dead too).  kinds holds the masks of those
    cases, each (nb, K)."""
    rng = np.random.default_rng(seed)
    shape = (nb, K)
    org = rng.integers(3, 9, size=(nb, 2)).astype(np.float32) * B
    cand = np.zeros((10, nb, K), np.float64)
    cand[0] = org[:, 0:1] + rng.uniform(-0.5 * B, 1.5 * B, shape)
    cand[1] = org[:, 1:2] + rng.uniform(-0.5 * B, 1.5 * B, shape)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(40.0), shape))
    s2 = s1 * np.exp(rng.uniform(np.log(0.01), 0.0, shape))
    th = rng.uniform(0.0, np.pi, shape)
    cs, sn = np.cos(th), np.sin(th)
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    cand[2] = cs * cs * i1 + sn * sn * i2
    cand[3] = cs * sn * (i1 - i2)
    cand[4] = sn * sn * i1 + cs * cs * i2
    u = rng.uniform(size=shape)
    not_pd = u < 0.04
    near_sing = (u >= 0.04) & (u < 0.08)
    dead = (u >= 0.08) & (u < 0.12)
    root = np.sqrt(cand[2] * cand[4])
    cand[3] = np.where(not_pd, 1.5 * root, cand[3])
    cand[3] = np.where(near_sing, (1.0 - 1e-5) * root, cand[3])
    opac = rng.uniform(0.001, 0.99, shape)
    opac = np.where(rng.uniform(size=shape) < 0.125,
                    rng.choice([0.99, 0.995, 0.9999], size=shape), opac)
    cand[5] = np.log(opac)
    cand[5] = np.where(dead, -1e30, cand[5])
    pad = np.zeros(shape, bool)
    pad[:, -16:] = True
    cand[5] = np.where(pad, -1e30, cand[5])
    cand[6:9] = rng.uniform(0.0, 1.0, (3, nb, K))
    cand[9] = np.ceil(3.0 * s1)
    o = torch.from_numpy(org)
    F = cb._build_F(torch.from_numpy(cand.astype(np.float32)), o[:, 0:1],
                    o[:, 1:2], B)
    kinds = dict(not_pd=not_pd, near_sing=near_sing, dead=dead | pad)
    return F, {k: torch.from_numpy(v) for k, v in kinds.items()}


@pytest.mark.parametrize("seed,B", [(0, 16), (1, 32), (2, 64), (3, 80)])
def test_window_box_holds_every_gated_pair(seed, B):
    F, kinds = crafted_windows(B, seed=seed)
    mono = cb._monomials(B, F.device)
    power = cb._power(F, mono)                          # (nb, K, P)
    alpha = torch.clamp_max(torch.exp(power), 0.99)
    gate = (power <= F[:, 6, :, None]) & (alpha >= ALPHA_MIN)
    xl, xh, yl, yh = cb.window_boxes(F, B, ALPHA_MIN)
    pix = torch.arange(B * B)
    px, py = (pix % B).float(), (pix // B).float()
    inside = ((xl[..., None] <= px) & (px <= xh[..., None])
              & (yl[..., None] <= py) & (py <= yh[..., None]))
    assert int(gate.sum()) > 1000             # the windows blend
    assert not bool((gate & ~inside).any())   # no contributor is culled
    # the cull is not empty: small and faint splats leave most pairs out
    assert float(inside.float().mean()) < 0.5
    # dead columns and log opacities below alpha_min: empty boxes
    faint = F[:, 6] < np.log(ALPHA_MIN) - 1e-3
    assert bool(kinds["dead"].any()) and bool((faint[kinds["dead"]]).all())
    assert bool(faint.any()) and bool(torch.isinf(xl[faint]).all()) \
        and bool((xl[faint] > 0).all())
    # conics that are not positive definite or near-singular: never culled
    for kind in ("not_pd", "near_sing"):
        m = kinds[kind] & ~faint
        assert bool(m.any())
        assert bool((xl[m] == -np.inf).all() and (xh[m] == np.inf).all()
                    and (yl[m] == -np.inf).all() and (yh[m] == np.inf).all())
    # the other boxes are finite and hold the splat's centre region
    ok = ~(kinds["not_pd"] | kinds["near_sing"] | faint)
    assert bool(torch.isfinite(xl[ok] - xh[ok]).any())


def test_window_box_empty_where_the_peak_is_below_alpha_min():
    """k < 0: a log opacity above ln(alpha_min) whose F rows were built
    for a peak below it (F2 lowered by 100) gives an empty box, and the
    gate passes none of its pairs."""
    F, _ = crafted_windows(32, nb=1, K=64, seed=7)
    live = F[0, 6] > np.log(0.5)
    F = F.clone()
    F[0, 2] = F[0, 2] - 100.0
    xl, _, _, _ = cb.window_boxes(F, 32, ALPHA_MIN)
    mono = cb._monomials(32, F.device)
    power = cb._power(F, mono)
    gate = (power <= F[:, 6, :, None]) & (
        torch.clamp_max(torch.exp(power), 0.99) >= ALPHA_MIN)
    det = (4.0 * F[0, 0] * F[0, 3] - F[0, 5] ** 2)
    m = live & (F[0, 0] < 0) & (F[0, 3] < 0) & (
        det > 1e-3 * 4.0 * F[0, 0] * F[0, 3])
    assert bool(m.any())
    assert bool((xl[0, m] == np.inf).all())
    assert not bool(gate[0, m].any())


def sequential_walk(F, counts, B, t_min, alpha_min, cull):
    """The forward blend of windows F (nb, 16, K) walked one candidate at a
    time, front to back, as kernels K4 / K8 walk them: blend state (nb, 8,
    P).  A pixel takes the twins' gate and update for each candidate j <
    count until its T would fall below t_min; with ``cull`` it skips the
    candidates whose ``window_boxes`` box misses it before the gate."""
    nb, _, K = F.shape
    P, dev = B * B, F.device
    mono = cb._monomials(B, dev)
    pix = torch.arange(P, device=dev)
    px, py = (pix % B).float(), (pix // B).float()
    xl, xh, yl, yh = cb.window_boxes(F, B, alpha_min)
    rgb = torch.zeros((nb, 3, P), device=dev)
    T = torch.ones((nb, P), device=dev)
    done = torch.zeros((nb, P), dtype=torch.bool, device=dev)
    last = torch.zeros((nb, P), device=dev)
    live = torch.arange(K, device=dev)[None, :] < counts[:, None]
    for j in range(K):
        power = cb._power(F[:, :, j:j + 1], mono)[:, 0]     # (nb, P)
        alpha = torch.clamp_max(torch.exp(power), 0.99)
        step = (live[:, j:j + 1] & ~done & (power <= F[:, 6, j:j + 1])
                & (alpha >= alpha_min))
        if cull:
            step &= ((xl[:, j:j + 1] <= px) & (px <= xh[:, j:j + 1])
                     & (yl[:, j:j + 1] <= py) & (py <= yh[:, j:j + 1]))
        T_after = T * (1.0 - alpha)
        stop = step & (T_after < t_min)
        take = step & ~stop
        w = T * alpha
        rgb = torch.where(take[:, None], rgb + F[:, 8:11, j:j + 1] * w[:, None],
                          rgb)
        T = torch.where(take, T_after, T)
        last = torch.where(take, float(j + 1), last)
        done = done | stop
    out = torch.zeros((nb, 8, P), device=dev)
    out[:, 0:3] = rgb
    out[:, 3] = T
    out[:, 4] = done.float()
    out[:, 5] = last
    return out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed,B", [(10, 16), (11, 32), (12, 64), (13, 80)])
def test_culled_forward_walk_is_the_unculled_walk(seed, B, packed):
    """K4 / K8's cull: a sequential forward walk that skips every pair
    outside the candidate's box gives the unculled walk's rgb, T, done and
    last bit for bit (a culled pair is one the gate rejects), on crafted
    windows in the padded and the packed addressing; both agree with the
    chunked twins within their tolerance."""
    # t_min 1e-2: enough pixels stop within the window at every block size
    K, C, t_min = 256, 64, 1e-2
    F, _ = crafted_windows(B, nb=3, K=K, seed=seed)
    counts = torch.tensor([K, 200, 40], dtype=torch.int32)
    for b, c in enumerate(counts.tolist()):
        F[b, 6, c:] = cb.NEG  # past a window's count: dead, as built
    meta = cb.BlendMeta(C, B, t_min, ALPHA_MIN, K // C)
    if packed:
        # the windows back to back at C-aligned offsets, with a tail of
        # columns no block owns, walked through the packed addressing
        aligned = [-(-c // C) * C for c in counts.tolist()]
        offs = torch.tensor(np.concatenate([[0], np.cumsum(aligned)[:-1]]),
                            dtype=torch.int32)
        Fp = torch.zeros((16, sum(aligned) + C))
        for b, (o, a) in enumerate(zip(offs.tolist(), aligned)):
            Fp[:, o:o + a] = F[b, :, :a]
        cols, _ = cb._packed_windows(counts, offs, Fp.shape[1], meta)
        Fw = Fp[:, cols].transpose(0, 1)
        twin = cb.blend_packed_ref(counts, offs, Fp, meta)
    else:
        Fw = F
        twin = cb.blend_core_ref(counts, F, meta)
    plain = sequential_walk(Fw, counts, B, t_min, ALPHA_MIN, cull=False)
    culled = sequential_walk(Fw, counts, B, t_min, ALPHA_MIN, cull=True)
    assert torch.equal(culled, plain)
    # the walk blends, stops some pixels and leaves others open
    assert float(plain[:, 5].max()) > 20
    assert 0 < int(plain[:, 4].sum()) < plain[:, 4].numel()
    assert float((plain[:, 0:4] - twin[:, 0:4]).abs().max()) <= 2e-3
    assert float((plain[:, 4] != twin[:, 4]).float().mean()) <= 1e-3
    assert float((plain[:, 5] != twin[:, 5]).float().mean()) <= 1e-3
