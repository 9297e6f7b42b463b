"""Config system: JSON scene configs + argparse overlay.

The port's own copy of gsmpm_tpu/config.py (stdlib only, same schema and
the same defaults <- JSON <- CLI chain), so the port imports nothing of the
JAX package.

Parity target: the reference ``ParamGroup`` reflection system
(reference arguments/__init__.py:7-100) and the JSON schema used by
reference configs/*.json.  Reference configs run unmodified:
``SimConfig.from_json("configs/lego.json")`` accepts the exact same files.

Design difference vs reference: plain frozen dataclasses with explicit fields
(validated, typo-safe) instead of attribute reflection; the same
defaults-<-JSON-<-CLI override chain is kept.
"""

from __future__ import annotations

import dataclasses
import json
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class BoundaryConditionConfig:
    """One entry of mpm.boundary_conditions.

    Covers the union of BC schemas consumed by the reference registry
    (reference mpm_solver/boundary_conditions.py:111-117):
    fixed_cube, impulse, sticky_ground, additional_params, modify_material.
    """

    type: str
    id: int = 0
    center: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    size: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    start_time: float = 0.0
    num_dt: float = 0.0
    # impulse
    force: Optional[List[float]] = None
    # additional_params (material parameter modifier)
    E: Optional[float] = None
    nu: Optional[float] = None
    density: Optional[float] = None
    mu: Optional[float] = None
    # modify_material
    material: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BoundaryConditionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown boundary_conditions keys: {sorted(unknown)}")
        return cls(**d)


@dataclass
class ModelConfig:
    """Parity: ModelParams (reference arguments/__init__.py:37-44)."""

    model_path: str = ""
    loaded_iter: int = -1
    debug: bool = False
    # reference puts white_background under "model" in configs/*.json even though
    # RenderParams declares it; accept it in both places.
    white_background: bool = False


@dataclass
class MPMConfig:
    """Parity: MPMParams (reference arguments/__init__.py:47-85)."""

    view_area: List[Any] = field(default_factory=list)
    sim_area: List[List[float]] = field(
        default_factory=lambda: [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    )
    mask: List[Any] = field(default_factory=list)

    E: float = 2e6
    nu: float = 0.4
    viscosity: float = 0.05
    material: str = "jelly"

    gravity: List[float] = field(default_factory=lambda: [0.0, -9.81, 0.0])
    density: float = 1000.0

    n_grid: int = 50
    grid_extent: float = 2.0

    substep_dt: float = 0.0006
    frame_dt: float = 0.03

    rotation_degree: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    # per-rotation axes paired with rotation_degree (appears in reference
    # configs, e.g. reference configs/cake.json, though never consumed
    # by the committed reference code)
    rotation_axis: List[int] = field(default_factory=lambda: [0])

    boundary_conditions: List[BoundaryConditionConfig] = field(default_factory=list)

    fitting: bool = False

    # --- TPU-framework extensions (not in reference schema; defaults preserve
    # reference behavior) ---
    # yield stress default mirrors reference mpm_solver/model.py:55
    yield_stress: float = 0.005
    hardening: int = 1
    xi: float = 1.0
    plastic_viscosity: float = 0.008
    softening: float = 1.0
    friction_angle: float = 25.0
    # incremental covariance update in G2P (reference computes it then overwrites
    # it in postprocess; see SURVEY quirk #5). Off by default: F Sigma0 F^T wins.
    incremental_cov: bool = False
    # rotate SH coefficients by the polar rotation of F (reference computes R but
    # never consumes it; see SURVEY quirk #6).
    rotate_sh: bool = False

    @property
    def steps_per_frame(self) -> int:
        # Parity: reference arguments/__init__.py:83
        return int(self.frame_dt / self.substep_dt)

    @property
    def dx(self) -> float:
        return self.grid_extent / self.n_grid

    @property
    def inv_dx(self) -> float:
        return self.n_grid / self.grid_extent


@dataclass
class RenderConfig:
    """Parity: RenderParams (reference arguments/__init__.py:88-100)."""

    output_path: str = ""
    white_background: bool = False
    view_cam_idx: int = 10
    num_frames: int = 60
    save_pcd: bool = False
    save_pcd_interval: int = 10


@dataclass
class SimConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    mpm: MPMConfig = field(default_factory=MPMConfig)
    render: RenderConfig = field(default_factory=RenderConfig)

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "SimConfig":
        def build(dc_cls, section: Dict[str, Any]):
            known = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in section.items():
                if k not in known:
                    raise ValueError(
                        f"Unknown config key '{k}' for {dc_cls.__name__}"
                    )
                kwargs[k] = v
            return dc_cls(**kwargs)

        model = build(ModelConfig, cfg.get("model", {}))
        mpm_section = dict(cfg.get("mpm", {}))
        bcs = [
            BoundaryConditionConfig.from_dict(b)
            for b in mpm_section.pop("boundary_conditions", [])
        ]
        mpm = build(MPMConfig, mpm_section)
        mpm.boundary_conditions = bcs
        render = build(RenderConfig, cfg.get("render", {}))
        # reference configs place white_background under "model"
        if "white_background" in cfg.get("model", {}):
            render.white_background = cfg["model"]["white_background"]
        return cls(model=model, mpm=mpm, render=render)

    @classmethod
    def from_json(cls, path: str) -> "SimConfig":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    def override_from_args(self, argv: Sequence[str]) -> "SimConfig":
        """argparse overlay: CLI flags override JSON, which overrides defaults.

        Parity with the reference chain (reference arguments/__init__.py:8-27,
        consumed at reference main.py:338-353).
        """
        parser = ArgumentParser(description="Simulation parameters", add_help=False)
        flat: Dict[str, List[str]] = {}
        for section_name in ("model", "mpm", "render"):
            section = getattr(self, section_name)
            for f in dataclasses.fields(section):
                v = getattr(section, f.name)
                if not isinstance(v, (bool, int, float, str)):
                    continue
                if f.name not in flat:
                    if isinstance(v, bool):
                        parser.add_argument(
                            f"--{f.name}", action="store_true", default=None
                        )
                    else:
                        parser.add_argument(f"--{f.name}", type=type(v), default=None)
                    flat[f.name] = []
                flat[f.name].append(section_name)
        args, _ = parser.parse_known_args(argv)
        out = SimConfig(
            model=dataclasses.replace(self.model),
            mpm=dataclasses.replace(self.mpm),
            render=dataclasses.replace(self.render),
        )
        for name, section_names in flat.items():
            v = getattr(args, name, None)
            if v is not None:
                for section_name in section_names:
                    setattr(getattr(out, section_name), name, v)
        return out


def load_config(config_path: str, argv: Sequence[str] = ()) -> SimConfig:
    return SimConfig.from_json(config_path).override_from_args(argv)
