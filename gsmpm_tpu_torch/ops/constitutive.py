"""Constitutive models: plastic return maps + Kirchhoff stress.

Port of gsmpm_tpu/ops/constitutive.py, both halves:
- the AoS laws on (N,3,3) deformation gradients (``kirchhoff_stress_*``,
  the ``*_return_mapping`` functions, ``compute_stress_from_F_trial``),
  the readable oracle that sim/solver._substep_aos runs;
- the planes laws the engines run (``compute_stress_soa`` and the
  functions it calls), each a branch-free elementwise function over nine
  (N,) planes.
In both the material switch is a ``torch.where`` over the materials
present (``active_materials``), as in the JAX package, and
``cauchy_stress_stvk_green`` / ``_soa`` is the fitting path's stress (no
return map).

Material ids: 0 jelly (fixed corotated), 1 metal (von Mises + StVK),
2 sand (Drucker-Prager), 3 foam (viscoplastic StVK), 4 fluid (cohesive
fluid + StVK), 5 plasticine (von Mises with softening + StVK).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.ops.svd3 import svd3x3

MATERIAL_JELLY = 0
MATERIAL_METAL = 1
MATERIAL_SAND = 2
MATERIAL_FOAM = 3
MATERIAL_FLUID = 4
MATERIAL_PLASTICINE = 5


def _diag3(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) diagonal."""
    return v[..., :, None] * torch.eye(3, dtype=v.dtype, device=v.device)


def _eye_as(F: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=F.dtype, device=F.device)


# ---------------------------------------------------------------------------
# AoS elastic Kirchhoff stresses
# ---------------------------------------------------------------------------

def kirchhoff_stress_fcr(F, U, V, J, mu, lam):
    """Fixed corotated: tau = 2 mu (F - R) F^T + lam J (J - 1) I."""
    R = U @ V.transpose(-1, -2)
    term = 2.0 * mu[..., None, None] * ((F - R) @ F.transpose(-1, -2))
    return term + (lam * J * (J - 1.0))[..., None, None] * _eye_as(F)


def kirchhoff_stress_stvk(F, U, V, sig, mu, lam):
    """Hencky-strain StVK: tau = U diag(2 mu eps + lam sum(eps)) V^T F^T,
    with the reference's sigma >= 0.01 clamp."""
    sig = torch.clamp_min(sig, 0.01)
    eps = torch.log(sig)
    tau_diag = 2.0 * mu[..., None] * eps + (lam * eps.sum(-1))[..., None]
    return (U @ _diag3(tau_diag) @ V.transpose(-1, -2)
            @ F.transpose(-1, -2))


def kirchhoff_stress_drucker_prager(F, U, V, sig, mu, lam):
    """The reference's Drucker-Prager Kirchhoff stress."""
    sig_safe = torch.clamp_min(sig, 1e-6)
    log_sig = torch.log(sig_safe)
    log_sum = log_sig.sum(-1, keepdim=True)
    center = (2.0 * mu[..., None] * log_sig
              + lam[..., None] * log_sum) / sig_safe
    return (U @ _diag3(center) @ V.transpose(-1, -2)
            @ F.transpose(-1, -2))


def cauchy_stress_stvk_green(F, mu, lam, j_clamp: float = 1e-2):
    """Green-Lagrange StVK Cauchy stress, the fitting path's law:
    E = (F^T F - I)/2; S = 2 mu E + lam tr(E) I; sigma = F S F^T / J, with
    |J| clamped to >= j_clamp."""
    J = torch.linalg.det(F)
    J = torch.where(torch.abs(J) < j_clamp,
                    j_clamp * torch.sign(J) + (J == 0) * j_clamp, J)
    I3 = _eye_as(F)
    E = 0.5 * (F.transpose(-1, -2) @ F - I3)
    trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    S = 2.0 * mu[..., None, None] * E + (lam * trE)[..., None, None] * I3
    return F @ S @ F.transpose(-1, -2) / J[..., None, None]


# ---------------------------------------------------------------------------
# AoS plastic return mappings (all branch-free batched)
# ---------------------------------------------------------------------------

def von_mises_return_mapping(
    F_trial, mu, lam, yield_stress, hardening: int, xi, softening=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """von Mises with optional hardening; returns (F, new_yield_stress).
    ``softening`` (plasticine) turns the hardening into a decay; None keeps
    the metal law."""
    U, sig_old, V = svd3x3(F_trial)
    sig = torch.clamp_min(sig_old, 0.01)
    eps = torch.log(sig)
    mean_eps = eps.mean(-1, keepdim=True)
    tau = 2.0 * mu[..., None] * eps + (lam * eps.sum(-1))[..., None]
    cond = tau - tau.mean(-1, keepdim=True)
    cond_norm = torch.linalg.vector_norm(cond, dim=-1)
    yielding = cond_norm > yield_stress

    eps_hat = eps - mean_eps
    eps_hat_norm = torch.linalg.vector_norm(eps_hat, dim=-1) + 1e-6
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    eps_proj = eps - (delta_gamma / eps_hat_norm)[..., None] * eps_hat
    F_proj = U @ _diag3(torch.exp(eps_proj)) @ V.transpose(-1, -2)

    F_new = torch.where(yielding[..., None, None], F_proj, F_trial)
    d_yield = 2.0 * mu * xi * delta_gamma
    if softening is not None:
        d_yield = -softening * torch.abs(d_yield)
    if hardening == 1:
        new_yield = torch.where(yielding, yield_stress + d_yield, yield_stress)
    else:
        new_yield = yield_stress
    return F_new, new_yield


def sand_return_mapping(F_trial, mu, lam, alpha) -> torch.Tensor:
    """Drucker-Prager sand projection."""
    U, sig, V = svd3x3(F_trial)
    eps = torch.log(torch.clamp_min(torch.abs(sig), 1e-14))
    tr = eps.sum(-1)
    eps_hat = eps - (tr / 3.0)[..., None]
    eps_hat_norm = torch.linalg.vector_norm(eps_hat, dim=-1)
    delta_gamma = (eps_hat_norm
                   + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * alpha)

    Vt = V.transpose(-1, -2)
    # delta_gamma > 0 and tr <= 0: project onto the yield surface
    safe_norm = torch.clamp_min(eps_hat_norm, 1e-12)
    H = eps - eps_hat * (delta_gamma / safe_norm)[..., None]
    F_proj = U @ _diag3(torch.exp(H)) @ Vt
    # delta_gamma > 0 and tr > 0: total failure, F = U V^T
    F_fail = U @ Vt

    yielding = delta_gamma > 0
    expanding = tr > 0
    return torch.where(
        yielding[..., None, None],
        torch.where(expanding[..., None, None], F_fail, F_proj),
        F_trial,
    )


def _deviatoric_viscoplastic_project(
    F_trial, mu, yield_scale, yield_stress, plastic_viscosity, dt, visc_mult,
    sig_clamp,
):
    """Shared core of the foam/fluid viscoplastic return maps."""
    U, sig_old, V = svd3x3(F_trial)
    sig = torch.clamp_min(sig_old, sig_clamp)
    b_trial = sig * sig
    eps = torch.log(sig)
    tr = eps.sum(-1)
    eps_hat = eps - (tr / 3.0)[..., None]
    s_trial = 2.0 * mu[..., None] * eps_hat
    s_norm = torch.linalg.vector_norm(s_trial, dim=-1)
    y = s_norm - yield_scale * math.sqrt(2.0 / 3.0) * yield_stress

    mu_hat = mu * b_trial.sum(-1) / 3.0
    denom = 1.0 + plastic_viscosity * visc_mult / (
        2.0 * torch.clamp_min(mu_hat, 1e-12) * dt)
    s_new_norm = s_norm - y / denom
    scale = s_new_norm / torch.clamp_min(s_norm, 1e-12)
    s_new = scale[..., None] * s_trial
    eps_new = s_new / (2.0 * mu[..., None]) + (tr / 3.0)[..., None]
    F_proj = U @ _diag3(torch.exp(eps_new)) @ V.transpose(-1, -2)
    return torch.where((y > 0)[..., None, None], F_proj, F_trial)


def viscoplasticity_return_mapping_stvk(
    F_trial, mu, yield_stress, plastic_viscosity, dt
) -> torch.Tensor:
    """Foam ("toothpaste") viscoplastic StVK return map: 0.8x yield scale,
    viscosity factor 2, sigma clamp 0.01."""
    return _deviatoric_viscoplastic_project(
        F_trial, mu, 0.8, yield_stress, plastic_viscosity, dt, 2.0, 0.01
    )


def fluid_return_mapping(
    F_trial, mu, yield_stress, plastic_viscosity, dt
) -> torch.Tensor:
    """Cohesive-fluid return map (the reference defines it and never
    dispatches it; here it is material "fluid")."""
    return _deviatoric_viscoplastic_project(
        F_trial, mu, 1.0, yield_stress, plastic_viscosity, dt, 1.0, 0.01
    )


# ---------------------------------------------------------------------------
# AoS fused dispatch: return map + stress
# ---------------------------------------------------------------------------

class StressResult(NamedTuple):
    F: torch.Tensor  # (N,3,3) post-return-map elastic deformation gradient
    stress: torch.Tensor  # (N,3,3) symmetrized Kirchhoff stress
    yield_stress: torch.Tensor  # (N,) possibly hardened


def compute_stress_from_F_trial(
    F_trial: torch.Tensor,
    material: torch.Tensor,
    mu: torch.Tensor,
    lam: torch.Tensor,
    yield_stress: torch.Tensor,
    alpha,
    hardening: int,
    xi,
    plastic_viscosity,
    softening,
    dt,
    active_materials: Tuple[int, ...] = (0,),
) -> StressResult:
    """Vectorized material dispatch: return-map F_trial, then the
    symmetrized Kirchhoff stress (jelly gets fixed corotated, the
    reference's intended branch).

    ``active_materials`` is static: only the laws present in the scene
    run, so a single-material scene pays for exactly one return map.
    """
    m = material
    F = F_trial
    new_yield = yield_stress

    def sel(mid, a, b):
        return torch.where((m == mid)[..., None, None], a, b)

    if MATERIAL_METAL in active_materials:
        F_vm, y_vm = von_mises_return_mapping(
            F_trial, mu, lam, yield_stress, hardening, xi
        )
        F = sel(MATERIAL_METAL, F_vm, F)
        new_yield = torch.where(m == MATERIAL_METAL, y_vm, new_yield)
    if MATERIAL_PLASTICINE in active_materials:
        F_pl, y_pl = von_mises_return_mapping(
            F_trial, mu, lam, yield_stress, hardening, xi, softening=softening
        )
        F = sel(MATERIAL_PLASTICINE, F_pl, F)
        new_yield = torch.where(m == MATERIAL_PLASTICINE, y_pl, new_yield)
    if MATERIAL_SAND in active_materials:
        F = sel(MATERIAL_SAND, sand_return_mapping(F_trial, mu, lam, alpha),
                F)
    if MATERIAL_FOAM in active_materials:
        F = sel(
            MATERIAL_FOAM,
            viscoplasticity_return_mapping_stvk(
                F_trial, mu, yield_stress, plastic_viscosity, dt
            ),
            F,
        )
    if MATERIAL_FLUID in active_materials:
        F = sel(
            MATERIAL_FLUID,
            fluid_return_mapping(F_trial, mu, yield_stress, plastic_viscosity,
                                 dt),
            F,
        )

    J = torch.linalg.det(F)
    U, sig, V = svd3x3(F)

    stress = torch.zeros_like(F)
    if MATERIAL_JELLY in active_materials:
        stress = sel(MATERIAL_JELLY, kirchhoff_stress_fcr(F, U, V, J, mu, lam),
                     stress)
    stvk_mats = [
        mm
        for mm in (MATERIAL_METAL, MATERIAL_FOAM, MATERIAL_FLUID, MATERIAL_PLASTICINE)
        if mm in active_materials
    ]
    if stvk_mats:
        stvk = kirchhoff_stress_stvk(F, U, V, sig, mu, lam)
        is_stvk = torch.zeros_like(m, dtype=torch.bool)
        for mm in stvk_mats:
            is_stvk = is_stvk | (m == mm)
        stress = torch.where(is_stvk[..., None, None], stvk, stress)
    if MATERIAL_SAND in active_materials:
        stress = sel(
            MATERIAL_SAND,
            kirchhoff_stress_drucker_prager(F, U, V, sig, mu, lam), stress
        )

    stress = 0.5 * (stress + stress.transpose(-1, -2))
    return StressResult(F=F, stress=stress, yield_stress=new_yield)


# ---------------------------------------------------------------------------
# SoA ("planes") laws: the same physics, the engines' layout
# ---------------------------------------------------------------------------


def _vm_return_soa(F_trial, mu, lam, yield_stress, hardening, xi, softening=None):
    """Planes von Mises return map (metal; plasticine with softening)."""
    U, sig_raw, V = m33.svd3(F_trial)
    sig = tuple(torch.clamp_min(s, 0.01) for s in sig_raw)
    eps = tuple(torch.log(s) for s in sig)
    sum_eps = eps[0] + eps[1] + eps[2]
    mean_eps = sum_eps / 3.0
    tau = tuple(2.0 * mu * e + lam * sum_eps for e in eps)
    tau_mean = (tau[0] + tau[1] + tau[2]) / 3.0
    cond = tuple(t - tau_mean for t in tau)
    cond_norm = torch.sqrt(cond[0] ** 2 + cond[1] ** 2 + cond[2] ** 2)
    yielding = cond_norm > yield_stress

    eps_hat = tuple(e - mean_eps for e in eps)
    ehn = torch.sqrt(eps_hat[0] ** 2 + eps_hat[1] ** 2 + eps_hat[2] ** 2) + 1e-6
    delta_gamma = ehn - yield_stress / (2.0 * mu)
    ratio = delta_gamma / ehn
    eps_proj = tuple(e - ratio * eh for e, eh in zip(eps, eps_hat))
    F_proj = m33.matmul_t(
        m33.mul_diag_right(U, tuple(torch.exp(e) for e in eps_proj)), V
    )
    F_new = m33.mwhere(yielding, F_proj, F_trial)
    d_yield = 2.0 * mu * xi * delta_gamma
    if softening is not None:
        d_yield = -softening * torch.abs(d_yield)
    if hardening == 1:
        new_yield = torch.where(yielding, yield_stress + d_yield, yield_stress)
    else:
        new_yield = yield_stress
    return F_new, new_yield


def _sand_return_soa(F_trial, mu, lam, alpha):
    """Planes Drucker-Prager sand projection."""
    U, sig, V = m33.svd3(F_trial)
    eps = tuple(torch.log(torch.clamp_min(torch.abs(s), 1e-14)) for s in sig)
    tr = eps[0] + eps[1] + eps[2]
    eps_hat = tuple(e - tr / 3.0 for e in eps)
    ehn = torch.sqrt(eps_hat[0] ** 2 + eps_hat[1] ** 2 + eps_hat[2] ** 2)
    delta_gamma = ehn + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * alpha
    safe_norm = torch.clamp_min(ehn, 1e-12)
    ratio = delta_gamma / safe_norm
    H = tuple(e - eh * ratio for e, eh in zip(eps, eps_hat))
    F_proj = m33.matmul_t(
        m33.mul_diag_right(U, tuple(torch.exp(h) for h in H)), V
    )
    F_fail = m33.matmul_t(U, V)
    return m33.mwhere(
        delta_gamma > 0, m33.mwhere(tr > 0, F_fail, F_proj), F_trial
    )


def _viscoplastic_return_soa(
    F_trial, mu, yield_scale, yield_stress, plastic_viscosity, dt, visc_mult,
    sig_clamp,
):
    """Planes deviatoric viscoplastic projection (foam and fluid)."""
    U, sig_raw, V = m33.svd3(F_trial)
    sig = tuple(torch.clamp_min(s, sig_clamp) for s in sig_raw)
    b_sum = sig[0] ** 2 + sig[1] ** 2 + sig[2] ** 2
    eps = tuple(torch.log(s) for s in sig)
    tr = eps[0] + eps[1] + eps[2]
    eps_hat = tuple(e - tr / 3.0 for e in eps)
    s_trial = tuple(2.0 * mu * eh for eh in eps_hat)
    s_norm = torch.sqrt(s_trial[0] ** 2 + s_trial[1] ** 2 + s_trial[2] ** 2)
    y = s_norm - yield_scale * math.sqrt(2.0 / 3.0) * yield_stress

    mu_hat = mu * b_sum / 3.0
    denom = 1.0 + plastic_viscosity * visc_mult / (
        2.0 * torch.clamp_min(mu_hat, 1e-12) * dt
    )
    s_new_norm = s_norm - y / denom
    sc = s_new_norm / torch.clamp_min(s_norm, 1e-12)
    eps_new = tuple(sc * s / (2.0 * mu) + tr / 3.0 for s in s_trial)
    F_proj = m33.matmul_t(
        m33.mul_diag_right(U, tuple(torch.exp(e) for e in eps_new)), V
    )
    return m33.mwhere(y > 0, F_proj, F_trial)


def _stress_fcr_soa(F, U, V, J, mu, lam):
    R = m33.matmul_t(U, V)
    term = m33.scale(m33.matmul_t(m33.sub(F, R), F), 2.0 * mu)
    return m33.add_scaled_identity(term, lam * J * (J - 1.0))


def _stress_stvk_soa(F, U, V, sig, mu, lam):
    sig = tuple(torch.clamp_min(s, 0.01) for s in sig)
    eps = tuple(torch.log(s) for s in sig)
    sum_eps = eps[0] + eps[1] + eps[2]
    tau = tuple(2.0 * mu * e + lam * sum_eps for e in eps)
    return m33.matmul_t(m33.matmul_t(m33.mul_diag_right(U, tau), V), F)


def _stress_dp_soa(F, U, V, sig, mu, lam):
    sig_safe = tuple(torch.clamp_min(s, 1e-6) for s in sig)
    log_sig = tuple(torch.log(s) for s in sig_safe)
    log_sum = log_sig[0] + log_sig[1] + log_sig[2]
    center = tuple(
        (2.0 * mu * ls + lam * log_sum) / ss for ls, ss in zip(log_sig, sig_safe)
    )
    return m33.matmul_t(m33.matmul_t(m33.mul_diag_right(U, center), V), F)


def cauchy_stress_stvk_green_soa(F, mu, lam, j_clamp: float = 1e-2):
    """Green-Lagrange StVK Cauchy stress, the fitting path's law:
    sigma = F (2 mu E + lam tr(E) I) F^T / J with E = (F^T F - I) / 2 and
    |J| clamped to at least j_clamp."""
    J = m33.det(F)
    J = torch.where(torch.abs(J) < j_clamp,
                    j_clamp * torch.sign(J) + (J == 0) * j_clamp, J)
    E = m33.add_scaled_identity(m33.scale(m33.t_matmul(F, F), 0.5), -0.5)
    trE = m33.trace(E)
    S = m33.add_scaled_identity(m33.scale(E, 2.0 * mu), lam * trE)
    return m33.scale(m33.matmul_t(m33.matmul(F, S), F), 1.0 / J)


def compute_stress_soa(
    F_trial,
    material: torch.Tensor,
    mu: torch.Tensor,
    lam: torch.Tensor,
    yield_stress: torch.Tensor,
    alpha,
    hardening: int,
    xi,
    plastic_viscosity,
    softening,
    dt,
    active_materials: Tuple[int, ...] = (0,),
):
    """Planes material dispatch; returns (F planes, stress planes, yield).

    Return-map F_trial per material, then the symmetrized Kirchhoff stress
    of the resulting F (jelly gets fixed corotated, the reference's intended
    branch).  Scalars (alpha, xi, plastic_viscosity, softening, dt) are
    Python floats.
    """
    m = material
    F = F_trial
    new_yield = yield_stress

    if MATERIAL_METAL in active_materials:
        F_vm, y_vm = _vm_return_soa(F_trial, mu, lam, yield_stress, hardening, xi)
        F = m33.mwhere(m == MATERIAL_METAL, F_vm, F)
        new_yield = torch.where(m == MATERIAL_METAL, y_vm, new_yield)
    if MATERIAL_PLASTICINE in active_materials:
        F_pl, y_pl = _vm_return_soa(
            F_trial, mu, lam, yield_stress, hardening, xi, softening=softening
        )
        F = m33.mwhere(m == MATERIAL_PLASTICINE, F_pl, F)
        new_yield = torch.where(m == MATERIAL_PLASTICINE, y_pl, new_yield)
    if MATERIAL_SAND in active_materials:
        F = m33.mwhere(
            m == MATERIAL_SAND, _sand_return_soa(F_trial, mu, lam, alpha), F
        )
    if MATERIAL_FOAM in active_materials:
        F = m33.mwhere(
            m == MATERIAL_FOAM,
            _viscoplastic_return_soa(
                F_trial, mu, 0.8, yield_stress, plastic_viscosity, dt, 2.0, 0.01
            ),
            F,
        )
    if MATERIAL_FLUID in active_materials:
        F = m33.mwhere(
            m == MATERIAL_FLUID,
            _viscoplastic_return_soa(
                F_trial, mu, 1.0, yield_stress, plastic_viscosity, dt, 1.0, 0.01
            ),
            F,
        )

    J = m33.det(F)
    U, sig, V = m33.svd3(F)

    stress = tuple(torch.zeros_like(F[0]) for _ in range(9))
    if MATERIAL_JELLY in active_materials:
        stress = m33.mwhere(
            m == MATERIAL_JELLY, _stress_fcr_soa(F, U, V, J, mu, lam), stress
        )
    stvk_mats = [
        mm
        for mm in (MATERIAL_METAL, MATERIAL_FOAM, MATERIAL_FLUID, MATERIAL_PLASTICINE)
        if mm in active_materials
    ]
    if stvk_mats:
        stvk = _stress_stvk_soa(F, U, V, sig, mu, lam)
        is_stvk = torch.zeros_like(m, dtype=torch.bool)
        for mm in stvk_mats:
            is_stvk = is_stvk | (m == mm)
        stress = m33.mwhere(is_stvk, stvk, stress)
    if MATERIAL_SAND in active_materials:
        stress = m33.mwhere(
            m == MATERIAL_SAND, _stress_dp_soa(F, U, V, sig, mu, lam), stress
        )

    stress = m33.symmetrize(stress)
    return F, stress, new_yield
