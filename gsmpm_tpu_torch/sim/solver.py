"""Frame-end postprocess (port of gsmpm_tpu/sim/solver.py:postprocess).

The golden-engine driver (run_substeps, MPMSolver) is not ported yet; the
port's forward engine is the tiled one in sim/tiles.py.
"""

from __future__ import annotations

import torch

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.sim.kernels import postprocess_soa, soa_from_state
from gsmpm_tpu_torch.sim.state import MPMState


def postprocess(state: MPMState, rotate_sh: bool = False):
    """cov = F Sigma0 F^T and the SH polar rotation R, both from F_trial.

    Returns (cov6 (N,6), R (N,3,3) or None); R follows the reference's
    stored-transpose convention.
    """
    cov6_p, R_p = postprocess_soa(soa_from_state(state), rotate_sh)
    cov6 = torch.stack(cov6_p, dim=-1)
    R = m33.to_aos(R_p) if R_p is not None else None
    return cov6, R
