"""gsmpm_tpu_torch's interface against gsmpm_tpu's.

For every public function, method, NamedTuple and dataclass of gsmpm_tpu
the port has a counterpart under the same name; the shared parameters sit
at the same positions under the same names (a parameter the port moved
behind a dropped one is keyword-only, so no positional call can land on
it); NamedTuple fields and defaults are equal; each sub-package re-exports
gsmpm_tpu's names.  What the port lacks, or stands in for, is listed below
with its reason.  Value tests beside it hold the interface the port gained
(scene selection, MPMModel.E / nu, TileConfig.pad_axis, the Preprocessed
views) and the calls whose positional meaning used to differ to
gsmpm_tpu on seeded numpy inputs.
"""

import dataclasses
import importlib
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmpm_tpu

# gsmpm_tpu modules without a port module, and why.
NO_MODULE = {
    "gsmpm_tpu.render.pallas_blend": "Pallas kernels K4/K5/K8/K9: CUDA in "
    "csrc/tile_blend.cu behind render/cuda_blend.py",
    "gsmpm_tpu.sim.pallas_mpm": "Pallas kernels K1/K2/K6: CUDA in "
    "csrc/mpm_transfer.cu and csrc/mpm_sored.cu behind sim/cuda_mpm.py",
    "gsmpm_tpu.utils.cache": "XLA's persistent compilation cache; the port "
    "builds its libraries once into build/ (utils/build.py)",
}

# Public names of gsmpm_tpu without a counterpart, and why.
NO_COUNTERPART = {
    "gsmpm_tpu.parallel.halo.to_original_soa": "replaced by "
    "original_order_view",
    "gsmpm_tpu.parallel.mesh.particle_pspec": "a shard_map PartitionSpec; "
    "torch.distributed ranks hold plain tensors (mesh.shard / gather)",
    "gsmpm_tpu.parallel.particle_pspec": "the same re-exported",
    "gsmpm_tpu.utils.enable_compilation_cache": "XLA's compilation cache "
    "(utils/cache.py, see NO_MODULE)",
    "gsmpm_tpu.render.renderer.dupsort_applicable": "the v1 selections' "
    "guard; the port has the v2 dup-sort only",
    "gsmpm_tpu.sim.tiles.p2g_chunk_ref": "a chunk reference picked by "
    "impl / chunk_impl; the port's twin is the batched p2g_tiled_ref",
    "gsmpm_tpu.sim.tiles.g2p_chunk_ref": "the same for g2p_tiled_ref",
    "gsmpm_tpu.sim.tiles.p2g_chunk_mm": "the same (matmul variant)",
    "gsmpm_tpu.sim.tiles.g2p_chunk_mm": "the same (matmul variant)",
}

# Parameters renamed in every signature: gsmpm_tpu's -> the port's.
RENAMED = {
    "axis_name": "group",  # a shard_map axis name -> a torch process group
    "devices": "device",  # a list of jax devices -> the rank's torch device
}

# Parameters dropped from every signature.
DROPPED = {
    "impl": "picks Pallas or a chunk reference; the port takes the CUDA "
    "kernel or its twin by the tensors' device",
    "chunk_impl": "the same for the fitting transfers",
    "migration": "the halo frames' choice of a gathered repartition every "
    "segment; the port's neighbour migration takes it by itself when a "
    "buffer would overflow (halo.migrate_neighbor_slots)",
}

# Per-callable stand-ins: gsmpm_tpu's parameter -> the port's (None: none).
STAND_INS = {
    "gsmpm_tpu.sim.fitting.SystemIdentifier.appearance_step": (
        {"tx": "opt", "opt_state": None},
        "the torch optimizer of make_appearance_optimizer holds optax's tx "
        "and opt_state"),
    "gsmpm_tpu.parallel.engines.MeshSimEngine.__init__": (
        {"axis": None, "example_state": None, "example_model": None},
        "shard_map's axis and the example pytrees of its partition specs; "
        "the port's engines run over the mesh's process group"),
    "gsmpm_tpu.parallel.engines.make_mesh_render_fn": (
        {"axis": None, "n_feature_dims": None},
        "the shard_map axis and the feature array's PartitionSpec rank"),
    "gsmpm_tpu.parallel.sharded.make_sharded_frame_fn": (
        {"example_state": None, "example_model": None, "data_axis": None},
        "the example pytrees and axis of shard_map's partition specs"),
    "gsmpm_tpu.parallel.sharded.make_sharded_render_fn": (
        {"n_gaussians": None, "data_axis": None, "tile_axis": None},
        "shard_map's shapes and axes; the port gathers over the mesh's "
        "group and splits the block rows over the same ranks"),
    "gsmpm_tpu.parallel.sharded.make_sharded_fit_step": (
        {"example_state": None},
        "the example pytree of shard_map's state partition spec"),
    "gsmpm_tpu.parallel.sharded.make_camera_dp_fit_step": (
        {"example_camera": None},
        "the static camera fields of shard_map's traced camera batch; the "
        "port passes each rank its camera"),
    "gsmpm_tpu.parallel.tiled_sharded.make_sharded_frame_tiled": (
        {"axis": None},
        "the shard_map axis; the port runs over the mesh's process group"),
}

# Parameters the port requires that gsmpm_tpu does not have, and why.
PORT_REQUIRED = {
    "gsmpm_tpu.parallel.halo.migrate_gathered_slots": {
        "mesh": "the collectives need the port's Mesh (process groups), "
        "where shard_map knows its axes"},
    "gsmpm_tpu.parallel.halo.migrate_neighbor_slots": {
        "mesh": "the same"},
}

JAX_MODULES = sorted(
    ".".join(p.relative_to(pathlib.Path(gsmpm_tpu.__file__).parent.parent)
             .with_suffix("").parts).removesuffix(".__init__")
    for p in pathlib.Path(gsmpm_tpu.__file__).parent.rglob("*.py"))


def _port_name(name):
    return name.replace("gsmpm_tpu", "gsmpm_tpu_torch", 1)


def _positional(params):
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _same_default(a, b):
    if a is inspect.Parameter.empty:
        return True
    if b is inspect.Parameter.empty:
        return False
    if isinstance(a, (bool, int, float, str, tuple, type(None))) \
            or hasattr(a, "_fields"):
        return repr(a) == repr(b)
    return True  # arrays and objects: the port holds torch's counterpart


def signature_faults(qual, ref, port):
    """Where a call written for ``ref`` (gsmpm_tpu's) would bind otherwise
    in ``port``; an empty list when the signatures agree."""
    faults = []
    pa = list(inspect.signature(ref).parameters.values())
    pb = inspect.signature(port).parameters
    mapping, _ = STAND_INS.get(qual, ({}, ""))
    renamed = []  # gsmpm_tpu's parameters by the port's names, None: dropped
    for p in pa:
        name = mapping.get(p.name, RENAMED.get(p.name, p.name))
        renamed.append(None if p.name in DROPPED or name is None else name)
    pos_b = _positional(pb.values())
    n_pos_a = len(_positional(pa))
    for i, (p, name) in enumerate(zip(pa, renamed)):
        if name is None:
            continue
        if name not in pb:
            faults.append(f"{qual}: no parameter {name!r}")
            continue
        q = pb[name]
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) \
                and q.kind is not q.KEYWORD_ONLY \
                and (name not in pos_b or pos_b.index(name) != i):
            faults.append(f"{qual}: {name!r} is positional {i} in gsmpm_tpu, "
                          f"{pos_b.index(name) if name in pos_b else None} "
                          f"here")
        if not _same_default(p.default, q.default):
            faults.append(f"{qual}: {name!r} defaults to {p.default!r} in "
                          f"gsmpm_tpu, {q.default!r} here")
    required = PORT_REQUIRED.get(qual, {})
    for q in pb.values():
        if q.name in renamed or q.kind in (q.VAR_POSITIONAL, q.VAR_KEYWORD):
            continue
        if q.kind is not q.KEYWORD_ONLY and pos_b.index(q.name) < n_pos_a:
            faults.append(f"{qual}: the port's own {q.name!r} takes "
                          f"gsmpm_tpu's positional slot {pos_b.index(q.name)}")
        if q.default is q.empty and q.name not in required:
            faults.append(f"{qual}: the port requires its own {q.name!r}")
    return faults


def _public_members(cls):
    for name, member in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        if name in getattr(cls, "_fields", ()):
            continue
        yield name, member


def class_faults(qual, ref, port):
    faults = []
    if hasattr(ref, "_fields"):
        if list(ref._fields) != list(getattr(port, "_fields", ())):
            faults.append(f"{qual}: fields {ref._fields} != "
                          f"{getattr(port, '_fields', None)}")
        da, db = ref._field_defaults, getattr(port, "_field_defaults", {})
        for k, v in da.items():
            if k not in db or repr(v) != repr(db[k]):
                faults.append(f"{qual}.{k}: default {v!r} != "
                              f"{db.get(k, 'missing')!r}")
    elif dataclasses.is_dataclass(ref):
        fa = [(f.name, f.default) for f in dataclasses.fields(ref)]
        fb = ([(f.name, f.default) for f in dataclasses.fields(port)]
              if dataclasses.is_dataclass(port) else None)
        if fb is None or [n for n, _ in fa] != [n for n, _ in fb] or any(
                not _same_default(
                    inspect.Parameter.empty if a is dataclasses.MISSING
                    else a,
                    inspect.Parameter.empty if b is dataclasses.MISSING
                    else b)
                for (_, a), (_, b) in zip(fa, fb)):
            faults.append(f"{qual}: dataclass fields {fa} != {fb}")
    for name, member in _public_members(ref):
        if name == "__init__" and (hasattr(ref, "_fields")
                                   or dataclasses.is_dataclass(ref)):
            continue
        if not hasattr(port, name):
            faults.append(f"{qual}.{name}: missing")
            continue
        if isinstance(member, property):
            if not isinstance(inspect.getattr_static(port, name), property):
                faults.append(f"{qual}.{name}: not a property here")
            continue
        fn = getattr(ref, name)
        if callable(fn):
            faults += signature_faults(f"{qual}.{name}", fn,
                                       getattr(port, name))
    return faults


@pytest.mark.parametrize("modname", JAX_MODULES)
def test_interface_matches_gsmpm_tpu(modname):
    """Every public name of the gsmpm_tpu module has its counterpart in the
    port, with gsmpm_tpu's parameter positions, names and defaults."""
    if modname in NO_MODULE:
        with pytest.raises(ImportError):
            importlib.import_module(_port_name(modname))
        return
    ref = importlib.import_module(modname)
    port = importlib.import_module(_port_name(modname))
    faults = []
    is_package = hasattr(ref, "__path__")
    for name, obj in vars(ref).items():
        qual = f"{modname}.{name}"
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if not is_package and getattr(obj, "__module__", None) != modname:
            continue  # imported from elsewhere: checked where it is defined
        if not (inspect.isclass(obj) or callable(obj)):
            continue
        if qual in NO_COUNTERPART:
            assert not hasattr(port, name), f"{qual} is ported: unlist it"
            continue
        if not hasattr(port, name):
            faults.append(f"{qual}: missing")
            continue
        if is_package:
            continue  # a re-export: its signature is checked at its module
        if inspect.isclass(obj):
            faults += class_faults(qual, obj, getattr(port, name))
        else:
            faults += signature_faults(qual, obj, getattr(port, name))
    assert not faults, "\n".join(faults)


def _resolve(qual):
    """gsmpm_tpu's object named qual (a module attribute or a method)."""
    for depth in (0, 1):
        mod, *rest = qual.rsplit(".", 1 + depth)
        try:
            obj = importlib.import_module(mod)
        except ImportError:
            continue
        for part in rest:
            obj = getattr(obj, part)
        return obj
    raise AssertionError(qual)


def test_allowlist_names_exist():
    """Every listed name is one of gsmpm_tpu's, and each stand-in names
    parameters its callable has."""
    for qual in list(NO_COUNTERPART) + list(PORT_REQUIRED):
        _resolve(qual)
    for qual, (mapping, reason) in STAND_INS.items():
        params = inspect.signature(_resolve(qual)).parameters
        assert set(mapping) <= set(params) and reason, (qual, mapping)


# ---------------------------------------------------------------------------
# values: the interface the port gained, against gsmpm_tpu
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_arrays(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa: E731
    return dict(xyz=f(3), features_dc=f(1, 3), features_rest=f(3, 3),
                opacity=3.0 * f(1), scaling=f(3) - 3.0, rotation=f(4))


def _scenes(n=200, seed=0):
    from gsmpm_tpu.models.gaussians import GaussianScene as JScene
    from gsmpm_tpu_torch.models.gaussians import GaussianScene as TScene

    a = _scene_arrays(n, seed)
    return (JScene(sh_degree=1, **{k: jnp.asarray(v) for k, v in a.items()}),
            TScene(sh_degree=1, **{k: torch.from_numpy(v)
                                   for k, v in a.items()}))


def _assert_scenes_equal(js, ts):
    assert js.num_gaussians == ts.num_gaussians
    assert js.active_sh_degree == ts.active_sh_degree == ts.sh_degree
    for f in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


def test_scene_select_and_pruning_match_gsmpm_tpu():
    """select (mask and indices), drop_low_opacity, drop_empty_gaussians
    and with_xyz_at(mask_idx=...) give gsmpm_tpu's gaussians, bit for bit
    (tests/test_io.py::test_scene_pruning's cases)."""
    js, ts = _scenes()
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=200) < 0.3
    idx = rng.permutation(200)[:40]
    _assert_scenes_equal(js.select(jnp.asarray(mask)),
                         ts.select(torch.from_numpy(mask)))
    _assert_scenes_equal(js.select(jnp.asarray(idx)),
                         ts.select(torch.from_numpy(idx)))
    for thr in (0.02, 0.5):
        kept_j, kept_t = js.drop_low_opacity(thr), ts.drop_low_opacity(thr)
        _assert_scenes_equal(kept_j, kept_t)
        assert 0 < kept_t.num_gaussians < 200
        assert float(kept_t.get_opacity().min()) >= thr - 1e-6
    _assert_scenes_equal(js.drop_low_opacity(), ts.drop_low_opacity())
    keep = np.arange(200) < 50
    _assert_scenes_equal(js.drop_empty_gaussians(keep),
                         ts.drop_empty_gaussians(keep))
    assert ts.drop_empty_gaussians(keep).num_gaussians == 50
    new = rng.normal(size=(40, 3)).astype(np.float32)
    _assert_scenes_equal(
        js.with_xyz_at(mask_idx=jnp.asarray(idx), new_xyz=jnp.asarray(new)),
        ts.with_xyz_at(mask_idx=torch.from_numpy(idx),
                       new_xyz=torch.from_numpy(new)))


def test_model_E_nu_match_gsmpm_tpu():
    """MPMModel.E() / nu() per particle on seeded (logE, y)."""
    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.sim.state import init_model
    from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
    from gsmpm_tpu_torch.sim.state import init_model as t_init_model

    rng = np.random.default_rng(2)
    logE = rng.uniform(2.0, 7.0, size=300).astype(np.float32)
    y = rng.normal(size=300).astype(np.float32)
    jm = dataclasses.replace(init_model(MPMConfig(), 300),
                             logE=jnp.asarray(logE), y=jnp.asarray(y))
    tm = dataclasses.replace(t_init_model(TMPMConfig(), 300, "cpu"),
                             logE=torch.from_numpy(logE),
                             y=torch.from_numpy(y))
    np.testing.assert_allclose(tm.E().numpy(), np.asarray(jm.E()), rtol=1e-6)
    np.testing.assert_allclose(tm.nu().numpy(), np.asarray(jm.nu()),
                               rtol=1e-6)


@pytest.mark.parametrize("n_grid", [8, 16, 50, 100, 129])
def test_tile_config_pad_axis_matches_gsmpm_tpu(n_grid):
    from gsmpm_tpu.sim.tiles import TileConfig
    from gsmpm_tpu_torch.sim.tiles import TileConfig as TTileConfig

    assert TTileConfig(n_grid, 1000).pad_axis \
        == TileConfig(n_grid, 1000).pad_axis


def test_preprocessed_views_match_gsmpm_tpu():
    """Preprocessed.pix / conic / color of both preprocesses (rtol 1e-5)
    on a seeded degree-1 scene."""
    from gsmpm_tpu.render.camera import make_camera
    from gsmpm_tpu.render.renderer import RasterConfig, preprocess
    from gsmpm_tpu_torch.render import RasterConfig as TRasterConfig
    from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera
    from gsmpm_tpu_torch.render.renderer import preprocess as t_preprocess

    rng = np.random.default_rng(3)
    n = 300
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    A = 0.05 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = np.ascontiguousarray(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    opacity = rng.uniform(0.2, 0.95, size=n).astype(np.float32)
    shs = rng.normal(size=(n, 4, 3)).astype(np.float32)
    args = (64, 64, 0.9, 0.9, np.eye(3), np.zeros(3))
    jp = preprocess(jnp.asarray(means), jnp.asarray(cov6),
                    jnp.asarray(opacity), jnp.asarray(shs),
                    make_camera(*args), 1, RasterConfig())
    tp = t_preprocess(torch.from_numpy(means), torch.from_numpy(cov6),
                      torch.from_numpy(opacity), torch.from_numpy(shs),
                      t_make_camera(*args), 1, TRasterConfig())
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    assert valid.sum() > n // 2
    for view, width in (("pix", 2), ("conic", 3), ("color", 3)):
        got = getattr(tp, view).numpy()
        assert got.shape == (n, width)
        np.testing.assert_allclose(got[valid],
                                   np.asarray(getattr(jp, view))[valid],
                                   rtol=1e-5, atol=1e-6, err_msg=view)


def test_raster_config_positional_and_tpu_knobs():
    """A positional RasterConfig means gsmpm_tpu's fields (the fifth is
    block_batch, not t_min), and gsmpm_tpu's TPU-only knobs are accepted."""
    from gsmpm_tpu.render.renderer import RasterConfig
    from gsmpm_tpu_torch.render import RasterConfig as TRasterConfig

    args = (64, 1024, 8192, 64, 16, 5e-4)
    assert tuple(TRasterConfig(*args)) == tuple(RasterConfig(*args))
    assert TRasterConfig(*args).t_min == 5e-4
    knobs = dict(block_batch=4, remat=False, skip_empty=False, impl="xla",
                 sel="v1", stream_unroll=2, stream_chunk=256)
    assert tuple(TRasterConfig(**knobs)) == tuple(RasterConfig(**knobs))


def _golden_problem():
    """tests/test_torch_fitting.py's golden scene: 600 particles on a 16^3
    grid, an impulse and a surface collider, in both packages."""
    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.sim.boundary import BCSet, ImpulseBC, make_surface_collider
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu.sim.volume import particle_volume
    from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
    from gsmpm_tpu_torch.models.convert import state_from_numpy
    from gsmpm_tpu_torch.sim import boundary as tb
    from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
    from gsmpm_tpu_torch.sim.state import init_model as t_init_model

    n = 600
    kw = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
              substep_dt=1e-4, frame_dt=1e-2, density=200.0)
    cfg = MPMConfig(**kw)
    rng = np.random.default_rng(5)
    xyz = jnp.asarray(rng.uniform(0.1, 1.9, size=(n, 3)).astype(np.float32))
    A = 0.01 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = jnp.asarray(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    v0 = jnp.asarray(2.0 * rng.normal(size=(n, 3)).astype(np.float32))
    state = init_state(xyz, cov6, particle_volume(xyz, 16, 2.0), cfg, v0)
    imp = dict(center=[1.0, 1.0, 1.0], size=[0.5, 0.5, 0.5],
               force=[0.0, 0.0, 50.0])
    bcs = BCSet(particle_ops=(ImpulseBC(
        *(jnp.asarray(imp[k], jnp.float32) for k in imp),
        jnp.float32(0.0), jnp.float32(1.0)),),
        grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    t_bcs = tb.BCSet(particle_ops=(tb.ImpulseBC(
        *(torch.tensor(imp[k]) for k in imp), 0.0, 1.0),),
        grid_ops=(tb.make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    return ((state, init_model(cfg, n), bcs, GridConfig(16, 2.0)),
            (t_state, t_init_model(TMPMConfig(**kw), n, "cpu"), t_bcs,
             TGridConfig(16, 2.0)), cfg.substep_dt)


def _close(got, want, rel, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * (np.abs(want).max() + 1e-12), (what, err)


def test_run_substeps_positional_incremental_cov_matches_gsmpm_tpu():
    """run_substeps(state, model, bcs, t, n, grid, dt, True): the eighth
    positional argument is incremental_cov in both packages (cov advances
    every substep; F is not the fitting F := F_trial)."""
    from gsmpm_tpu.sim.solver import run_substeps
    from gsmpm_tpu_torch.sim.solver import run_substeps as t_run_substeps

    (js, jm, jb, jg), (ts, tm, tb_, tg), dt = _golden_problem()
    stj, _ = run_substeps(js, jm, jb, jnp.float32(0.0), 5, jg, dt, True)
    st, _ = t_run_substeps(ts, tm, tb_, 0.0, 5, tg, dt, True)
    assert not np.allclose(np.asarray(stj.cov), np.asarray(js.cov))
    for name in ("x", "v", "C", "F", "F_trial", "cov"):
        # index_add_ vs scatter-add order, 5 substeps
        _close(getattr(st, name).numpy(), getattr(stj, name), 1e-5, name)


def test_substep_soa_positional_incremental_cov_matches_gsmpm_tpu():
    """substep_soa(state, model, bcs, t, grid, dt, True): incremental_cov,
    seventh positional in both packages."""
    from gsmpm_tpu.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu.sim.kernels import substep_soa
    from gsmpm_tpu_torch.sim import kernels as tk

    (js, jm, jb, jg), (ts, tm, tb_, tg), dt = _golden_problem()
    stj = state_from_soa(jax.jit(lambda s: substep_soa(
        s, jm, jb, jnp.float32(0.0), jg, dt, True))(soa_from_state(js)))
    st = tk.state_from_soa(tk.substep_soa(tk.soa_from_state(ts), tm, tb_,
                                          0.0, tg, dt, True))
    for name in ("x", "v", "C", "F", "F_trial", "cov"):
        _close(getattr(st, name).numpy(), getattr(stj, name), 1e-5, name)


@pytest.mark.parametrize("args", [
    ((0, 0, 0.4), (0, 0, 1)),
    ((0, 0, 0.4), (0, 0, 1), "sticky", 0.2),
    ((0, 0, 0.4), (0, 0, 1), 0.2),
    ((0.1, 0.2, 0.4), (0.3, 0, 1), "sticky", 0.7, 0.0, 1.0),
])
def test_make_surface_collider_positional_matches_gsmpm_tpu(args):
    """The same positional call gives the same collider: the third argument
    is surface (unused), the fourth friction."""
    from gsmpm_tpu.sim.boundary import make_surface_collider
    from gsmpm_tpu_torch.sim.boundary import make_surface_collider as t_make

    jc, tc = make_surface_collider(*args), t_make(*args)
    assert tc.friction == float(jc.friction)
    rng = np.random.default_rng(4)
    gv = rng.normal(size=(512, 3)).astype(np.float32)
    coords = rng.integers(0, 16, size=(512, 3)).astype(np.float32)
    want = jc.apply_grid(jnp.asarray(gv), jnp.asarray(coords), 0.0, 1e-4,
                         0.125)
    got = tc.apply_grid(torch.from_numpy(gv), torch.from_numpy(coords), 0.0,
                        1e-4, 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_simulate_and_fit_frame_bind_as_gsmpm_tpu():
    """simulate's fifth positional argument is checkpoint_interval, and
    fit_frame / appearance_step take gt_image by name, in both packages."""
    from gsmpm_tpu.apps.simulate import simulate
    from gsmpm_tpu.sim.fitting import SystemIdentifier
    from gsmpm_tpu_torch.apps.simulate import simulate as t_simulate
    from gsmpm_tpu_torch.sim.fitting import SystemIdentifier as TIdent

    for fn in (simulate, t_simulate):
        bound = inspect.signature(fn).bind("cfg", 512, 2, True, 3, True,
                                           "none", 64).arguments
        assert (bound["checkpoint_interval"], bound["resume"],
                bound["mesh"], bound["synthetic_res"]) == (3, True, "none", 64)
    for cls in (SystemIdentifier, TIdent):
        bound = inspect.signature(cls.fit_frame).bind(
            "self", "state", 0.0, "camera", gt_image="img").arguments
        assert bound["gt_image"] == "img"
    inspect.signature(TIdent.appearance_step).bind(
        "self", "opt", "params", camera="camera", gt_image="img")
