"""Substep driver of the golden engine and the frame-end postprocess.

Port of gsmpm_tpu/sim/solver.py's ``run_substeps`` and ``postprocess``.
The port's forward engine for simulation is the tiled one in sim/tiles.py;
``run_substeps`` drives the golden planes engine (sim/kernels.py), which
generates the fitting ground truth, runs simulate's frames with
``incremental_cov`` or after a tiled-engine overflow, and is the fitting
engine after one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.sim.kernels import (
    postprocess_soa,
    soa_from_state,
    state_from_soa,
    substep_soa,
)
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel, MPMState
from gsmpm_tpu_torch.sim.tiles import _advance


def run_substeps(state: MPMState, model: MPMModel, bcs, time: float,
                 n_substeps: int, grid: GridConfig, dt: float,
                 fitting: bool = False,
                 checkpoint_policy: Optional[str] = "substep",
                 incremental_cov: bool = False, group=None):
    """n_substeps of the golden engine; returns (state, time).

    ``incremental_cov`` advances cov every substep (the reference's
    update_cov); ``group`` all-reduces the dense grid over the ranks of a
    process group, each holding a particle shard (parallel/sharded.py),
    through a differentiable all-reduce while autograd records the run.

    ``checkpoint_policy="substep"`` recomputes each substep in the backward
    pass (``torch.utils.checkpoint``), keeping only the particle state
    between substeps, the JAX package's memory policy; it only matters
    when autograd records the run.  ``time`` is a host float advanced in
    float32 as the JAX clock.
    """
    soa = soa_from_state(state)
    remat = checkpoint_policy == "substep" and torch.is_grad_enabled()
    for _ in range(n_substeps):
        if remat:
            soa = torch.utils.checkpoint.checkpoint(
                substep_soa, soa, model, bcs, time, grid, dt, fitting,
                incremental_cov, group, use_reentrant=False,
            )
        else:
            soa = substep_soa(soa, model, bcs, time, grid, dt, fitting,
                              incremental_cov, group)
        time = _advance(time, dt)
    return state_from_soa(soa), time


def postprocess(state: MPMState, rotate_sh: bool = False):
    """cov = F Sigma0 F^T and the SH polar rotation R, both from F_trial.

    Returns (cov6 (N,6), R (N,3,3) or None); R follows the reference's
    stored-transpose convention.
    """
    cov6_p, R_p = postprocess_soa(soa_from_state(state), rotate_sh)
    cov6 = torch.stack(cov6_p, dim=-1)
    R = m33.to_aos(R_p) if R_p is not None else None
    return cov6, R
