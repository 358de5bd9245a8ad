"""Explicit PD advection-reaction-diffusion transport (bi-material bonds),
the helpers it shares with the implicit solver, and phase change.

Port of ``pd_mg_pin_corrosion_tpu/ops/ard.py`` (reference
src/pd_ard.cpp): ``compute_salt_blocked``, ``micro_d_factor``,
``compute_dt``, ``ard_step`` and ``apply_phase_change``. The explicit step
runs in 2D, through the ``ard2d`` kernel on CUDA float32 tensors and its
plain twin on the CPU and in float64; 3D explicit transport is not ported
(ROADMAP: "3D explicit transport (no kernel)").
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..fields import State
from ..grid import FLUID, OUTSIDE, SOLID_MG
from ..kernels import ard2d, ard2d_plain
from ..kit import Kit
from .ns import fluid_vmax, vel_magnitude


def compute_salt_blocked(state: State, kit: Kit) -> torch.Tensor:
    """Salt-layer blocking (pd_ard.cpp:58-73 / pd_ard_implicit.cpp:68-87):
    a SOLID node with ANY FLUID neighbour at C >= C_sat has all its
    interface bonds disabled."""
    nt_p = kit.pad(state.node_type, OUTSIDE)
    C_p = kit.pad(state.C, 0.0)
    blocked = torch.zeros(kit.shape, dtype=torch.bool, device=kit.device)
    for s0, s1 in kit.slot_chunks():
        NT = kit.neighbors(nt_p, s0=s0, s1=s1)
        CJ = kit.neighbors(C_p, s0=s0, s1=s1)
        blocked |= ((NT == FLUID) & (CJ >= kit.cfg.C_sat)).any(0)
    return blocked & (state.node_type == SOLID_MG)


def micro_d_factor(cfg, volume_loss_fraction, dtype,
                   device) -> torch.Tensor:
    """Volume-loss scaling of the solid micro-diffusivities: the Hermann et
    al. 2022 Eq. 42 decay 10^(-V_L/corrosion_decay_l) (pd_ard.cpp:75-79)
    times the optional acceleration extension 10^(+V_L/corrosion_accel_l)."""
    vl = torch.as_tensor(volume_loss_fraction, dtype=dtype, device=device)
    factor = torch.ones((), dtype=dtype, device=device)
    if cfg.corrosion_decay_l > 0.0:
        factor = factor * torch.pow(10.0, -vl / cfg.corrosion_decay_l)
    if cfg.corrosion_accel_l > 0.0:
        factor = factor * torch.pow(10.0, vl / cfg.corrosion_accel_l)
    return factor


def solid_diffusivity(is_gb, is_precip, cfg, factor) -> torch.Tensor:
    """Solid-side micro-diffusivity GB > precipitate > grain, times the
    volume-loss factor (a 0-d tensor fixing dtype and device)."""
    D_grain = factor.new_tensor(cfg.D_grain)
    return torch.where(is_gb, cfg.D_gb,
                       torch.where(is_precip, cfg.D_precip, D_grain)) * factor


def compute_dt(state: State, kit: Kit) -> torch.Tensor:
    """Explicit transport CFL (pd_ard.cpp:34-53), a 0-d tensor of the run
    dtype on the device."""
    cfg = kit.cfg
    v_max = fluid_vmax(state, kit)
    D_max = max(cfg.D_liquid, cfg.D_grain, cfg.D_gb)
    D_eff_max = D_max + cfg.alpha_art_diff * v_max * cfg.dx
    # tensor numerators: torch turns scalar / tensor into a reciprocal
    # times the scalar, one rounding more than the reference's division
    dt_diff = v_max.new_tensor(0.25 * cfg.dx * cfg.dx) / (D_eff_max + 1e-30)
    dt_adv = v_max.new_tensor(cfg.dx) / (v_max + 1e-30)
    return cfg.cfl_factor_corr * torch.minimum(dt_diff, dt_adv)


def ard_step(state: State, kit: Kit, dt, volume_loss_fraction=0.0) -> State:
    """One explicit forward-Euler transport step (pd_ard.cpp:55-191). The
    salt-blocking pass, the volume-loss factor, the solid-side
    micro-diffusivity and |v| are formed here, as the JAX package's Pallas
    wrapper forms them in XLA; the bond sums are ``ard2d``'s."""
    if kit.dim != 2:
        raise NotImplementedError(
            "3D explicit transport is not ported (ROADMAP.md, port order: "
            "'3D explicit transport (no kernel)')")
    salt = compute_salt_blocked(state, kit)
    decay = micro_d_factor(kit.cfg, volume_loss_fraction, kit.dtype,
                           kit.device)
    Ds = solid_diffusivity(state.is_gb, state.is_precip, kit.cfg, decay)
    step = ard2d if kit.dtype == torch.float32 else ard2d_plain
    C = step(state.C, state.vel, vel_magnitude(state.vel), state.node_type,
             Ds, salt, dt, kit)
    return replace(state, C=C)


def apply_phase_change(state: State, kit: Kit):
    """Dissolve solid nodes below C_thresh — a device-side remask
    (pd_ard.cpp:193-212). Returns (new_state, n_dissolved as a 0-d tensor)."""
    cfg = kit.cfg
    dissolve = ((state.phase == 0) & (state.node_type == SOLID_MG)
                & (state.C < cfg.C_thresh))
    n = dissolve.sum()
    fluid_t = torch.full_like(state.node_type, FLUID)
    return replace(
        state,
        node_type=torch.where(dissolve, fluid_t, state.node_type),
        phase=torch.where(dissolve, torch.ones_like(state.phase), state.phase),
        D_map=torch.where(dissolve, cfg.D_liquid, state.D_map),
        rho=torch.where(dissolve, cfg.rho_f, state.rho),
        vel=torch.where(dissolve[..., None], 0.0, state.vel),
        C=torch.where(dissolve, cfg.C_thresh, state.C)), n
