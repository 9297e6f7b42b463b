"""The port's multi-device system identification on 2, 3 and 4 gloo ranks
vs the single-device port and gsmpm_tpu.

Each world size is one group of CPU processes (``multiprocessing`` spawn,
a free localhost port, a join timeout so that a hang fails the test): the
ranks run every case of their world size and rank 0 writes the results to
a file.  Meanwhile three more processes run the JAX package (its 8 host
devices) and the parent the single-device port, on the same numpy-seeded
inputs.  The particle count is odd, so the padding to the data axis is
used.

- the differentiable collectives: a replicated loss through all-gather and
  all-reduce has the one-process gradient, exactly (2 and 3 ranks);
- ``SystemIdentifier(mesh=...).fit_frame``, the sharded fit step, at data
  x tile = 2 x 1, 1 x 2 and 2 x 2 on both engines' twins, per particle and
  tied, against the single-device ``fit_frame``;
- ``make_camera_dp_fit_step`` on 2 cameras against the camera mean of
  single-device steps, on both engines;
- a tile-cap overflow on one rank: every rank redoes the step on golden;
- ``apps.identify --mesh auto`` on 2 ranks, synthetic (the sharded step)
  and with a 2-camera dataset (camera-DP).

The targets are seeded noise images, so that no pixel's L1 sign hangs on
the rounding.  The updates are compared unclipped (grad_clip 1e9,
learning rate 1e6, so that a step moves logE by up to ~0.08, far above
float32's resolution), where a factor of the device count would show.
"""

import json
import multiprocessing
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch

N_FIT = 301
RES = 48  # 3 block rows of 16: under tile = 2 the second rank's last
G = 16    # row lies past the image
SUB = 3
LR = 1e6
CLIP = 1e9
JOIN_TIMEOUT_S = 240
SHARDED = {"2x1": (("data", 2), ("tile", 1)),
           "1x2": (("data", 1), ("tile", 2)),
           "2x2": (("data", 2), ("tile", 2))}
ENGINES = ("golden", "tiled_vjp")
JAX_CASES = ("single", "2x2", "camdp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------

def cam_args(k=0):
    """Camera k looks at the blob from the front (k = 0) or the side."""
    a = 0.5 * np.pi * k
    pos = np.array([0.0, 0.8, 0.0]) + 3.0 * np.array([np.sin(a), 0.0,
                                                      -np.cos(a)])
    fwd = np.array([0.0, 0.8, 0.0]) - pos
    fwd /= np.linalg.norm(fwd)
    y = np.array([0.0, 1.0, 0.0])
    x = np.cross(y, fwd)
    return (RES, RES, 0.7, 0.7, np.column_stack([x, y, fwd]), pos)


def t_camera(k=0):
    from gsmpm_tpu_torch.render.camera import make_camera

    return make_camera(*cam_args(k))


def t_ident(mesh=None, engine="golden", tie=False):
    """The falling blob of tests/test_torch_fit_frame.py on the port."""
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
    from gsmpm_tpu_torch.render.renderer import RasterConfig
    from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier

    ident = SystemIdentifier(
        synthetic_blob_scene(n=N_FIT, seed=3, radius=0.4,
                             center=(0.0, 0.8, 0.0)),
        MPMConfig(material="jelly", E=1e4, nu=0.4, n_grid=G, grid_extent=2.0,
                  gravity=[0.0, -9.81, 0.0], fitting=True),
        init_velocity=torch.tensor([[0.0, -2.0, 0.0]]).repeat(N_FIT, 1),
        fit_cfg=FitConfig(substeps_per_frame=SUB, frame_dt=SUB * 1e-3,
                          lr_logE=LR, lr_y=LR, grad_clip=CLIP,
                          tie_params=tie),
        raster_cfg=RasterConfig(block=16, chunk=32), bg=torch.ones(3),
        mesh=mesh)
    ident._sim_engine = engine
    return ident


def _fit_result(ident, camera, gt) -> dict:
    logE0, y0 = ident.model.logE.clone(), ident.model.y.clone()
    loss, st, _, img = ident.fit_frame(ident.reset_state(), 0.0, camera,
                                       torch.from_numpy(gt))
    n = N_FIT
    return dict(loss=float(loss), image=img.numpy(), x=st.x[:n].numpy(),
                dlogE=(ident.model.logE - logE0)[:n].numpy(),
                dy=(ident.model.y - y0)[:n].numpy(),
                g_logE=ident.last_grads[0][:n].numpy(),
                g_y=ident.last_grads[1][:n].numpy(),
                engine=ident.sim_engine, n_dropped=ident.n_dropped_last)


def _camdp_inputs(mesh, engine):
    """A camera-DP step on the port's fit problem and its arguments."""
    from gsmpm_tpu_torch.parallel.sharded import (
        make_camera_dp_fit_step, stack_cameras,
    )

    ident = t_ident(engine=engine)
    state = ident.reset_state()
    opacity, features = ident._appearance()
    fcfg = ident.fit_cfg
    step = make_camera_dp_fit_step(
        mesh, ident.model, ident.bcs, ident.grid, fcfg.frame_dt, SUB,
        ident.bg, opacity, features, ident.scene.sh_degree, ident.scaling,
        ident.pos_center, 2.0, raster_cfg=ident.raster_cfg, lr_logE=LR,
        lr_y=LR, grad_clip=CLIP, sim_engine=engine)
    return ident, state, step, stack_cameras([t_camera(0), t_camera(1)])


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _exact_problem(world, k=4, m=5, seed=11):
    """Integer-valued float64 pieces, so that every sum is exact: rank r
    holds x_r (k,), scatters M_r x_r into a shared (m,) grid, reads N_r
    grid back and every rank takes the loss of all reads, gathered."""
    rng = np.random.default_rng(seed + world)
    x = rng.integers(-3, 4, size=(world, k)).astype(np.float64)
    M = rng.integers(-2, 3, size=(world, m, k)).astype(np.float64)
    Nr = rng.integers(-2, 3, size=(world, k, m)).astype(np.float64)
    w = rng.integers(1, 4, size=(world * k,)).astype(np.float64)
    return x, M, Nr, w


def _exact_loss(reads, w):
    return torch.sum(w * reads ** 2) + torch.sum(reads ** 3)


def _case_collectives(mesh, rank, world):
    from gsmpm_tpu_torch.parallel.mesh import all_gather_grad, all_reduce_sum

    x, M, Nr, w = (torch.from_numpy(a) for a in _exact_problem(world))
    xr = x[rank].clone().requires_grad_(True)
    grid = all_reduce_sum(M[rank] @ xr, mesh.group)
    loss = _exact_loss(all_gather_grad(Nr[rank] @ grid, mesh), w)
    (g,) = torch.autograd.grad(loss, xr)
    return dict(grad=g.numpy(), loss=loss.item())


def _case_sharded(mesh_axes, engine, tie=False):
    def run(ctx):
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(mesh_axes, "cpu")
        return _fit_result(t_ident(mesh, engine, tie), t_camera(0),
                           ctx["gt"][0])

    return run


def _case_camdp(engine):
    def run(ctx):
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh((("cam", 2),), "cpu")
        ident, state, step, cams = _camdp_inputs(mesh, engine)
        out = step(ident.model.logE, ident.model.y, state, 0.0, cams,
                   torch.from_numpy(np.stack(ctx["gt"])))
        return dict(loss=float(out.loss), x=out.state.x.numpy(),
                    dlogE=(out.logE - ident.model.logE).numpy(),
                    dy=(out.y - ident.model.y).numpy(),
                    g_logE=out.grads[0].numpy(), g_y=out.grads[1].numpy(),
                    n_dropped=out.n_dropped, sim_ok=out.sim_ok)

    return run


def _case_overflow(ctx):
    """Rank 1 alone overflows its occupied-tile cap at bootstrap; rank 0's
    tiled step succeeds locally, and still every rank redoes it on
    golden."""
    from gsmpm_tpu_torch.parallel.mesh import make_mesh
    from gsmpm_tpu_torch.sim import tiles

    mesh = make_mesh(SHARDED["2x1"], "cpu")
    real = tiles.default_tile_config
    if mesh.rank == 1:
        tiles.default_tile_config = \
            lambda g, n: real(g, n)._replace(n_occ_cap=1)
    try:
        return _fit_result(t_ident(mesh, "tiled_vjp"), t_camera(0),
                           ctx["gt"][0])
    finally:
        tiles.default_tile_config = real


def _identify_args(out, **over):
    from gsmpm_tpu_torch.apps import identify as tidentify

    args = dict(output_path=out, synthetic=64, iters=1, frames=2,
                resolution=32, E_true=3e3, E_init=1e4, device="cpu")
    args.update(over)
    return tidentify.build_parser().parse_args(
        [f"--{k}={v}" for k, v in args.items() if v is not None])


def _case_app(ctx, data_path=None):
    from gsmpm_tpu_torch.apps import identify as tidentify

    # a directory per rank: only rank 0's may hold metrics.csv
    out = os.path.join(ctx["root"], f"app_{data_path is not None}_"
                                    f"{torch.distributed.get_rank()}")
    stats = {}
    ident = tidentify.identify(_identify_args(out, data_path=data_path),
                               stats)
    return dict(route=stats["route"], mesh=stats["mesh"],
                losses=[r["loss"] for r in stats["frames"]],
                E=ident.optimized_E, engine=ident.sim_engine,
                csv=(open(os.path.join(out, "metrics.csv")).read()
                     if os.path.exists(os.path.join(out, "metrics.csv"))
                     else None))


CASES = {
    2: dict(**{f"sharded_{s}_{e}": _case_sharded(SHARDED[s], e)
               for s in ("2x1", "1x2") for e in ENGINES},
            **{f"camdp_{e}": _case_camdp(e) for e in ENGINES},
            overflow=_case_overflow,
            app_synthetic=_case_app,
            app_dataset=lambda ctx: _case_app(ctx, ctx["data"])),
    3: {},
    4: dict(**{f"sharded_2x2_{e}": _case_sharded(SHARDED["2x2"], e)
               for e in ENGINES},
            tied_2x2_golden=_case_sharded(SHARDED["2x2"], "golden", True)),
}


def _worker(rank, world, port, ctx):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist = torch.distributed
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh((("data", world),), "cpu")
        res = {"collectives": _case_collectives(mesh, rank, world)}
        res.update({name: fn(ctx) for name, fn in CASES[world].items()})
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(ctx["out"], "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world: int, ctx: dict):
    mp = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [mp.Process(target=_worker, args=(r, world, port, ctx))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, ctx, deadline):
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {len(procs)} ranks still running " \
                     f"after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    with open(ctx["out"], "rb") as f:
        return pickle.load(f)


def _write_dataset(root, n_frames=2, res=32):
    """Two cameras of random RGBA frames (tests/test_torch_fitting.py's
    layout), written with the port's PNG encoder."""
    from gsmpm_tpu_torch.io.video import encode_png

    rng = np.random.default_rng(8)
    cams = []
    for i, name in enumerate(("a", "b")):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.3 * i, 0.5, 3.0]
        cams.append({"camera": name, "K": [[40.0, 0, 16], [0, 40.0, 16],
                                           [0, 0, 1]],
                     "c2w": c2w.tolist()})
        os.makedirs(os.path.join(root, name))
        for fid in range(n_frames):
            px = rng.integers(0, 256, size=(res, res, 4), dtype=np.uint8)
            with open(os.path.join(root, name, f"{fid:03d}.png"), "wb") as f:
                f.write(encode_png(px))
    with open(os.path.join(root, "camera.json"), "w") as f:
        json.dump(cams, f)
    with open(os.path.join(root, "frame.json"), "w") as f:
        json.dump([{f"{i:03d}": 0.04 * i} for i in range(n_frames)], f)


# ---------------------------------------------------------------------------
# the single-device sides, computed while the ranks run
# ---------------------------------------------------------------------------

def _port_single(gt):
    """The single-device port: fit_frame per engine and camera, tied."""
    out = {}
    for e in ENGINES:
        for k in (0, 1):
            out[f"{e}_{k}"] = _fit_result(t_ident(engine=e), t_camera(k),
                                          gt[k])
    out["tied_golden"] = _fit_result(t_ident(tie=True), t_camera(0), gt[0])
    return out


def _jax_fit(gt, case):
    """gsmpm_tpu on the same inputs, its CPU route ("xla" engine, XLA
    render): case "single", its single-device fit_frame; "2x2", its
    sharded step at data x tile = 2 x 2; "camdp", its camera-DP step on 2
    cameras."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.models.synthetic import synthetic_blob_scene
    from gsmpm_tpu.parallel import make_mesh
    from gsmpm_tpu.parallel.sharded import (
        make_camera_dp_fit_step, stack_cameras,
    )
    from gsmpm_tpu.render.camera import make_camera
    from gsmpm_tpu.render.renderer import RasterConfig
    from gsmpm_tpu.sim.fitting import FitConfig, SystemIdentifier

    idt = SystemIdentifier(
        synthetic_blob_scene(n=N_FIT, seed=3, radius=0.4,
                             center=(0.0, 0.8, 0.0)),
        MPMConfig(material="jelly", E=1e4, nu=0.4, n_grid=G, grid_extent=2.0,
                  gravity=[0.0, -9.81, 0.0], fitting=True),
        init_velocity=jnp.tile(jnp.asarray([[0.0, -2.0, 0.0]]), (N_FIT, 1)),
        fit_cfg=FitConfig(substeps_per_frame=SUB, frame_dt=SUB * 1e-3,
                          lr_logE=LR, lr_y=LR, grad_clip=CLIP),
        raster_cfg=RasterConfig(block=16, chunk=32), bg=jnp.ones(3),
        mesh=make_mesh(SHARDED["2x2"]) if case == "2x2" else None)
    cams = [make_camera(*cam_args(k)) for k in (0, 1)]
    logE0, y0 = idt.model.logE, idt.model.y
    if case != "camdp":
        loss, st, _, img = idt.fit_frame(idt.reset_state(), jnp.float32(0.0),
                                         cams[0], jnp.asarray(gt[0]))
        return dict(loss=float(loss), image=np.asarray(img),
                    x=np.asarray(st.x)[:N_FIT],
                    dlogE=np.asarray(idt.model.logE - logE0)[:N_FIT],
                    dy=np.asarray(idt.model.y - y0)[:N_FIT])
    state = idt.reset_state()
    mesh = Mesh(np.array(jax.devices()[:2]), ("cam",))
    step = make_camera_dp_fit_step(
        mesh, idt.model, idt.bcs, idt.grid, SUB * 1e-3, SUB, idt.bg,
        idt.scene.get_opacity().reshape(-1), idt.scene.get_features(),
        idt.scene.sh_degree, idt.scaling, idt.pos_center, 2.0,
        raster_cfg=idt.raster_cfg, lr_logE=LR, lr_y=LR, grad_clip=CLIP,
        example_camera=cams[0])
    with mesh:
        loss, logE, y, st, _, nd, ok = step(
            logE0, y0, state, jnp.float32(0.0), stack_cameras(cams),
            jnp.asarray(np.stack(gt)))
    assert bool(ok) and int(nd) == 0
    return dict(loss=float(loss), x=np.asarray(st.x),
                dlogE=np.asarray(logE - logE0), dy=np.asarray(y - y0))


def _jax_worker(ctx):
    out = _jax_fit(ctx["gt"], ctx["case"])
    with open(ctx["out"], "wb") as f:
        pickle.dump([out], f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks and the JAX package's processes, started
    together, and the single-device port computed here while they run."""
    root = tmp_path_factory.mktemp("fit_mesh")
    rng = np.random.default_rng(5)
    gt = [rng.uniform(size=(RES, RES, 3)).astype(np.float32) for _ in (0, 1)]
    _write_dataset(str(root / "data"))
    ctxs = {w: dict(gt=gt, root=str(root), data=str(root / "data"),
                    out=str(root / f"ranks{w}.pkl")) for w in (2, 3, 4)}
    mp = multiprocessing.get_context("spawn")
    procs = {}
    for case in JAX_CASES:  # one process each: ~40 s of XLA compile apiece
        ctxs[case] = dict(gt=gt, case=case, out=str(root / f"{case}.pkl"))
        procs[case] = [mp.Process(target=_jax_worker, args=(ctxs[case],))]
        procs[case][0].start()
    procs.update({w: _start(w, ctxs[w]) for w in (2, 4, 3)})
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        single = _port_single(gt)
    finally:
        done = {k: _join(procs[k], ctxs[k], deadline) for k in procs}
    return dict(ranks={w: done[w] for w in (2, 3, 4)}, single=single,
                jax={case: done[case][0] for case in JAX_CASES})


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / (np.abs(np.asarray(want)).max() + 1e-30))


# the sharded steps sum the grid over the ranks and back-propagate each
# tile rank's rows apart: float32 sums in other orders over 3 substeps
# and a loss of ~1e-6 (an image difference).  Loss and image within the
# port-vs-JAX fit frame's bounds (tests/test_torch_fit_frame.py), state
# 1e-5, the gradients and the updates 1e-3 of their largest entry
LOSS_ATOL, IMAGE_ATOL, X_ATOL, GRAD_REL = 1e-6, 2e-3, 1e-5, 1e-3


def _same_step(got, want, what, image=True):
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL, what
    if image:
        np.testing.assert_allclose(got["image"], want["image"],
                                   atol=IMAGE_ATOL, err_msg=what)
    np.testing.assert_allclose(got["x"], want["x"], atol=X_ATOL, err_msg=what)
    for k in ("dlogE", "dy") + (("g_logE", "g_y") if "g_y" in want else ()):
        if k in got:
            assert _rel(got[k], want[k]) <= GRAD_REL, (what, k,
                                                       _rel(got[k], want[k]))


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_give_the_one_process_gradient(runs, world):
    x, M, Nr, w = (torch.from_numpy(a) for a in _exact_problem(world))
    x = x.clone().requires_grad_(True)
    grid = sum(M[r] @ x[r] for r in range(world))
    loss = _exact_loss(torch.cat([Nr[r] @ grid for r in range(world)]), w)
    (g,) = torch.autograd.grad(loss, x)
    every = runs["ranks"][world]
    for r in range(world):
        got = every[r]["collectives"]
        assert got["loss"] == loss.item()
        # integer-valued float64: the sums are exact, so equal bits
        np.testing.assert_array_equal(got["grad"], g[r].numpy())
    assert float(torch.abs(g).max()) > 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_sharded_fit_step_matches_single_device(runs, shape, engine):
    world = 4 if shape == "2x2" else 2
    every = runs["ranks"][world]
    got = every[0][f"sharded_{shape}_{engine}"]
    want = runs["single"][f"{engine}_0"]
    assert got["engine"] == want["engine"] == engine
    assert got["n_dropped"] == want["n_dropped"] == 0
    _same_step(got, want, f"{shape} {engine}")
    # the update moved logE by ~0.1: a device-count factor would show
    assert 0.01 < float(np.abs(want["dlogE"]).max()) < 10.0
    # every rank holds the same whole model
    for r in range(1, world):
        np.testing.assert_array_equal(every[r][f"sharded_{shape}_{engine}"]
                                      ["dlogE"], got["dlogE"])


def test_sharded_fit_step_tied_matches_single_device(runs):
    """tie_params: the finite gradient summed over every particle shard
    (gsmpm_tpu's tests/test_parallel.py:309 case, at data x tile = 2 x 2)."""
    got = runs["ranks"][4][0]["tied_2x2_golden"]
    want = runs["single"]["tied_golden"]
    _same_step(got, want, "tied 2x2")
    assert np.ptp(got["dlogE"]) == 0.0 and np.ptp(got["dy"]) == 0.0
    assert abs(float(got["dlogE"][0])) > 0.01


@pytest.mark.parametrize("engine", ENGINES)
def test_camera_dp_matches_camera_mean_of_single_steps(runs, engine):
    got = runs["ranks"][2][0][f"camdp_{engine}"]
    s0, s1 = (runs["single"][f"{engine}_{k}"] for k in (0, 1))
    assert got["sim_ok"] and got["n_dropped"] == 0
    want = dict(loss=0.5 * (s0["loss"] + s1["loss"]), x=s0["x"],
                g_logE=0.5 * (s0["g_logE"] + s1["g_logE"]),
                g_y=0.5 * (s0["g_y"] + s1["g_y"]),
                dlogE=-LR * 0.5 * (s0["g_logE"] + s1["g_logE"]),
                dy=-LR * 0.5 * (s0["g_y"] + s1["g_y"]))
    _same_step(got, want, f"camera-DP {engine}", image=False)
    assert 0.01 < float(np.abs(got["dlogE"]).max()) < 10.0


def test_overflow_on_one_rank_redoes_the_step_on_golden_everywhere(runs):
    every = runs["ranks"][2]
    for r in (0, 1):
        assert every[r]["overflow"]["engine"] == "golden", r
    # redone from the same start on golden: the golden sharded step exactly
    got, want = every[0]["overflow"], every[0]["sharded_2x1_golden"]
    for k in ("x", "dlogE", "dy", "image"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["loss"] == want["loss"]


def test_mesh_steps_match_jax_single_device(runs):
    """The port's sharded (2 x 2) and camera-DP steps against gsmpm_tpu's
    single-device fit_frame: loss, state and update."""
    j = runs["jax"]["single"]
    got = runs["ranks"][4][0]["sharded_2x2_golden"]
    _same_step(got, j, "sharded 2x2 vs gsmpm_tpu single")


def test_jax_mesh_steps_scale_the_update_by_the_device_count(runs):
    """gsmpm_tpu's sharded (2 x 2) and camera-DP (2 cameras) steps agree
    with the port's in loss, state and image, and their updates are the
    device count times the port's (and the single-device) update: the
    fault recorded in ROADMAP C (shard_map(check_vma=False) sums the
    equal cotangents of a replicated loss in the transposes of all_gather
    and psum)."""
    jax_out, ranks = runs["jax"], runs["ranks"]
    cases = (("2x2", ranks[4][0]["sharded_2x2_golden"], 4, True),
             ("camdp", ranks[2][0]["camdp_golden"], 2, False))
    for name, port, ndev, image in cases:
        j = dict(jax_out[name])
        j["dlogE"], j["dy"] = j["dlogE"] / ndev, j["dy"] / ndev
        _same_step(port, j, f"gsmpm_tpu {name} / {ndev}", image=image)
        # and not the update itself
        assert _rel(port["dlogE"], jax_out[name]["dlogE"]) > 0.5


def test_identify_mesh_auto_routes_and_fits(runs):
    """apps.identify --mesh auto on 2 ranks: the sharded step (data 1 x
    tile 2) without a dataset, camera-DP with a 2-camera one; rank 0
    alone writes metrics.csv."""
    every = runs["ranks"][2]
    for case, route, mesh in (
            ("app_synthetic", "sharded", {"data": 1, "tile": 2}),
            ("app_dataset", "camdp", {"rep": 1, "cam": 2})):
        got = every[0][case]
        assert got["route"] == route and got["mesh"] == mesh, case
        assert got["engine"] == "golden"  # the CPU's engine
        assert len(got["losses"]) == 2
        assert all(np.isfinite(v) for v in got["losses"]), case
        assert got["E"] != pytest.approx(1e4, rel=1e-9), case
        rows = got["csv"].splitlines()
        assert rows[0] == "iteration,frame,loss,optimized_E,optimized_nu"
        assert len(rows) == 3, case
        assert every[1][case]["csv"] is None, case
        assert every[1][case]["E"] == got["E"], case
