"""Implicit (backward-Euler) bi-material PD transport — matrix-free GMRES.

Port of the 2D path of ``pd_mg_pin_corrosion_tpu/ops/ard_implicit.py``
(reference src/pd_ard_implicit.cpp). M is never assembled as a matrix: its
action is a stencil application with per-slot weight fields W[s] and a
diagonal, built once per coupling cycle from the frozen velocity,
node types and salt mask (same bond physics, including the per-bond
M-matrix upwind clamp of pd_ard_implicit.cpp:254-288).

Numerics kept from the JAX package's CLI, which always enables x64:

* f64 runs solve to 1e-10 with GMRES(50);
* f32 runs solve to 1e-6 with GMRES(25), f64 Gram-Schmidt scalars, the
  inner tolerance floored at 1e-4, and up to two f64 iterative-refinement
  passes whose residual comes from the plain f64 slot sum;
* the preconditioner is two truncated-Neumann sweeps on the Jacobi-scaled
  system.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..fields import State
from ..grid import (FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG,
                    WALL)
from ..kernels import matvec2d, matvec2d_plain
from ..kit import Kit, slot_sum
from .ard import compute_salt_blocked, micro_d_factor, solid_diffusivity
from .gmres import gmres, vector_norm


@dataclass
class ImplicitOperator:
    """Frozen PD transport operator M (one coupling cycle)."""

    W: torch.Tensor        # [S, *shape] off-diagonal stencil weights
    diag: torch.Tensor     # [*shape] diagonal of M
    unknown: torch.Tensor  # [*shape] bool — FLUID | SOLID rows
    # float64 copy of W for the refinement residual, made on first use
    W64: torch.Tensor | None = None


def assemble(state: State, kit: Kit, volume_loss_fraction=0.0) -> ImplicitOperator:
    """Build the per-slot weights of M (pd_ard_implicit.cpp:104-346).

    Velocity, node types, GB/precipitate flags and the salt-blocking mask
    are frozen for the cycle, exactly as the reference's once-per-cycle
    assemble."""
    cfg = kit.cfg
    nt = state.node_type
    i_fluid = nt == FLUID
    i_solid = nt == SOLID_MG
    unknown = i_fluid | i_solid

    salt_blocked = compute_salt_blocked(state, kit)
    decay = micro_d_factor(cfg, volume_loss_fraction, kit.dtype, kit.device)

    vel_i = torch.where(i_fluid[..., None], state.vel, 0.0)
    D_s_i = solid_diffusivity(state.is_gb, state.is_precip, cfg, decay)

    def nb(A, fill):
        return kit.neighbors(kit.pad(A, fill))

    ixi, ixi2, ex, ey, vol = kit.slot_coefs[:, :, None, None]
    NT = nb(nt, OUTSIDE)
    valid = (NT != WALL) & (NT != OUTSIDE)
    V_j = vol * valid.to(kit.dtype)

    j_fluid = (NT == FLUID) | (NT == INLET) | (NT == OUTLET) | (NT == FICTITIOUS)
    j_solid = NT == SOLID_MG
    ll = i_fluid & j_fluid                  # liquid-liquid
    ss = i_solid & j_solid                  # skipped (pd_ard_implicit.cpp)
    iface = (i_fluid & j_solid) | (i_solid & j_fluid)

    D_s_j = solid_diffusivity(nb(state.is_gb, False), nb(state.is_precip, False),
                              cfg, decay)
    solid_D = torch.where(i_solid, D_s_i, D_s_j)
    solid_blocked = torch.where(i_solid, salt_blocked, nb(salt_blocked, False))
    D_iface = torch.where(
        solid_blocked, 0.0,
        2.0 * cfg.D_liquid * solid_D / (cfg.D_liquid + solid_D + 1e-30))
    D_avg = torch.where(ll, cfg.D_liquid, torch.where(iface, D_iface, 0.0))

    # diffusion weight (all bond types), pd_ard_implicit.cpp:274-276
    w_diff = kit.beta_lap * D_avg * ixi2 * V_j
    # advection + per-bond upwind stabilization on LL bonds
    # (pd_ard_implicit.cpp:279-288): w = (w_diff + max(0, w_adv - w_diff)) - w_adv
    v_dot_e = vel_i[..., 0] * ex + vel_i[..., 1] * ey
    w_adv = (kit.alpha / kit.V_H) * v_dot_e * ixi * V_j
    w_stab = torch.clamp(w_adv - w_diff, min=0.0)
    w_ll = (w_diff + w_stab) - w_adv
    w = torch.where(ll, w_ll, w_diff)
    # rows: only unknowns; bonds: skip solid-solid
    W = torch.where(unknown & ~ss, w, 0.0)
    # diag -= w per bond (symmetric), in stencil order
    diag = slot_sum(torch.cat([torch.zeros_like(W[:1]), -W]))
    return ImplicitOperator(W=W.contiguous(), diag=diag, unknown=unknown)


def matvec_M(op: ImplicitOperator, kit: Kit, x: torch.Tensor) -> torch.Tensor:
    """y = M x over unknown rows (zero elsewhere): GMRES's hot op, the
    matvec2d kernel for float32 on the card."""
    step = matvec2d if x.dtype == torch.float32 else matvec2d_plain
    return step(x, op.W, op.diag, op.unknown, kit)


def implicit_step(state: State, op: ImplicitOperator, kit: Kit, dt,
                  tol: float | None = None, restart: int = 50,
                  maxiter: int = 200):
    """Solve (I - dt*M) C_new = C_old with GMRES (pd_ard_implicit.cpp:371-429).

    Returns (new_state, residual as a float). BC rows are identity with
    b = current C (algebraically identical to the reference's RHS split).
    The result is clamped to [0, C_solid_init] on unknown rows only.
    """
    cfg = kit.cfg
    f32 = kit.dtype == torch.float32
    refine = f32
    if tol is None:
        tol = 1e-6 if f32 else 1e-10
    inner_tol = max(tol, 1e-4) if refine else tol
    if f32 and restart == 50:
        # shorter cycles keep the f32 Krylov basis well-conditioned
        restart = 25
    dt = torch.as_tensor(dt, dtype=kit.dtype, device=kit.device)
    C_old = state.C

    def A(x):
        return torch.where(op.unknown, x - dt * matvec_M(op, kit, x), x)

    # truncated-Neumann (polynomial) preconditioner on the Jacobi-scaled
    # system: y_{n+1} = y_n + D^{-1}(x - A y_n), 2 sweeps
    inv_diag = 1.0 / (1.0 - dt * op.diag)

    def jacobi(x):
        return torch.where(op.unknown, x * inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(2):
            y = y + jacobi(x - A(y))
        return y

    # the basis kernels take float32; float64 runs use the plain contractions
    flat = f32
    b = C_old
    x, (res, _) = gmres(A, b, C_old, tol=inner_tol, restart=restart,
                        maxiter=maxiter, M=precond, flat_kernels=flat)

    if refine:
        # Mixed-precision iterative refinement: the f32 residual floors near
        # eps32 * dt * ||M|| ~ 1e-4 at stiff dt, so the residual is formed
        # with the f64 operator and the correction solved in f32; two passes
        # at most (pd_ard_implicit.cpp:399-417 reaches 1e-10 in double).
        if op.W64 is None:
            op.W64 = op.W.to(torch.float64)
        diag64 = op.diag.to(torch.float64)
        dt64 = dt.to(torch.float64)

        def A64(x64):
            Mx = matvec2d_plain(x64, op.W64, diag64, op.unknown, kit)
            return torch.where(op.unknown, x64 - dt64 * Mx, x64)

        b64 = b.to(torch.float64)
        b_norm = max(vector_norm(b64), 1e-300)
        x64 = x.to(torch.float64)
        r64 = b64 - A64(x64)
        res = vector_norm(r64) / b_norm
        for _ in range(2):
            if not res > tol:
                break
            tol_c = min(max(0.5 * tol / max(res, 1e-300), 1e-4), 0.5)
            e, _ = gmres(A, r64.to(kit.dtype), torch.zeros_like(b), tol=tol_c,
                         restart=restart, maxiter=restart * 2, M=precond,
                         flat_kernels=flat)
            x64 = x64 + e.to(torch.float64)
            r64 = b64 - A64(x64)
            res = vector_norm(r64) / b_norm
        x = x64.to(kit.dtype)

    C_new = torch.where(op.unknown, torch.clamp(x, 0.0, cfg.C_solid_init), C_old)
    return replace(state, C=C_new), res


def compute_adaptive_dt(state: State, op: ImplicitOperator, kit: Kit) -> torch.Tensor:
    """Adaptive dt from per-solid time-to-threshold
    (pd_ard_implicit.cpp:438-489); a 0-d tensor of the run dtype."""
    cfg = kit.cfg
    MC = matvec_M(op, kit, state.C)

    solid = state.node_type == SOLID_MG
    eligible = solid & (state.C > cfg.C_thresh) & (MC < 0.0)
    rate = -MC
    t_phase = (state.C - cfg.C_thresh) / torch.clamp(rate, min=1e-30)
    t_phase = torch.where(eligible & (t_phase > 0.0) & (rate >= 1e-30),
                          t_phase, cfg.implicit_dt_max)
    min_t = torch.clamp(t_phase.min(), max=cfg.implicit_dt_max)
    dt = cfg.implicit_dt_fraction * min_t
    dt = torch.clamp(dt, max=cfg.implicit_dt_max)
    return torch.clamp(dt, min=cfg.implicit_dt_max * cfg.implicit_dt_min_frac)
