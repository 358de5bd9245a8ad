"""Explicit PD advection-reaction-diffusion transport (bi-material bonds),
the helpers it shares with the implicit solver, and phase change.

Port of ``pd_mg_pin_corrosion_tpu/ops/ard.py`` (reference
src/pd_ard.cpp): ``compute_salt_blocked``, ``micro_d_factor``,
``compute_dt``, ``ard_step`` and ``apply_phase_change``. The explicit step
runs through the ``ard2d`` kernel on 2D CUDA float32 tensors and as plain
PyTorch (``explicit_step``) everywhere else: on the CPU, in float64, and in
3D, where the JAX package has no kernel either.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..fields import State
from ..grid import FLUID, OUTSIDE, SOLID_MG, WALL
from ..kernels import ard2d
from ..kernels.ard2d import explicit_update, interface_D, is_liquid
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
    wrapper forms them in XLA; the bond sums are ``ard2d``'s in 2D float32
    and ``explicit_step``'s otherwise."""
    salt = compute_salt_blocked(state, kit)
    decay = micro_d_factor(kit.cfg, volume_loss_fraction, kit.dtype,
                           kit.device)
    Ds = solid_diffusivity(state.is_gb, state.is_precip, kit.cfg, decay)
    step = (ard2d if kit.dim == 2 and kit.dtype == torch.float32
            else explicit_step)
    C = step(state.C, state.vel, vel_magnitude(state.vel), state.node_type,
             Ds, salt, dt, kit)
    return replace(state, C=C)


def explicit_step(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit):
    """C after one explicit transport step, in 2D and 3D; nodes that are
    neither FLUID nor SOLID_MG keep their value. ``dt`` is a float or a 0-d
    tensor. The slot loop of JAX ``ard_step`` over ``kit.slot_chunks``,
    each chunk's terms added to the sums in stencil order. ``ard2d``'s
    plain twin, and the step itself where no kernel runs: float64, and 3D
    (the JAX package has no Pallas kernel there either)."""
    cfg = kit.cfg
    dt = torch.as_tensor(dt, dtype=C.dtype, device=C.device)
    i_fluid = node_type == FLUID
    i_solid = node_type == SOLID_MG
    vel_i = torch.where(i_fluid[..., None], vel, 0.0)
    vmag_i = torch.where(i_fluid, vmag, 0.0)
    pads = dict(nt=kit.pad(node_type, OUTSIDE), C=kit.pad(C, 0.0),
                vmag=kit.pad(vmag, 0.0), Ds=kit.pad(Ds, 0.0),
                salt=kit.pad(salt, False))

    acc = torch.zeros((2,) + kit.shape, dtype=C.dtype, device=C.device)
    for s0, s1 in kit.slot_chunks():
        def nb(key):
            return kit.neighbors(pads[key], s0=s0, s1=s1)

        ixi, ixi2, e, vol = kit.coefs(s0, s1)
        NT = nb("nt")
        # transport bonds exclude WALL and OUTSIDE neighbours (pd_ard.cpp:120)
        V_j = vol * ((NT != WALL) & (NT != OUTSIDE)).to(C.dtype)
        j_fluid = is_liquid(NT)
        j_solid = NT == SOLID_MG
        ll = i_fluid & j_fluid                  # liquid-liquid
        ss = i_solid & j_solid                  # skipped (pd_ard.cpp:134)
        iface = (i_fluid & j_solid) | (i_solid & j_fluid)

        # interface micro-diffusivity from the solid side (pd_ard.cpp:143-161)
        solid_D = torch.where(i_solid, Ds, nb("Ds"))
        solid_blocked = torch.where(i_solid, salt, nb("salt"))
        D_iface = torch.where(solid_blocked, 0.0,
                              interface_D(solid_D, cfg.D_liquid))
        D_avg = torch.where(ll, cfg.D_liquid, torch.where(iface, D_iface, 0.0))
        # artificial diffusion on liquid-liquid bonds (pd_ard.cpp:164-170)
        D_art = torch.where(ll, cfg.alpha_art_diff
                            * torch.maximum(vmag_i, nb("vmag")) * cfg.dx, 0.0)
        bond_on = (~ss).to(C.dtype)
        dC = nb("C") - C
        T_diff = kit.beta_lap * (D_avg + D_art) * dC * ixi2 * V_j * bond_on
        # non-conservative advection, LL bonds only (pd_ard.cpp:178-181)
        v_dot_e = vel_i[..., 0] * e[0]
        for d in range(1, kit.dim):
            v_dot_e = v_dot_e + vel_i[..., d] * e[d]
        T_adv = torch.where(ll, dC * v_dot_e * ixi * V_j, 0.0)
        T = torch.stack([T_diff, T_adv], dim=1)
        for s in range(s1 - s0):
            acc = acc + T[s]   # (diff, adv) in stencil order

    diff, adv = acc
    return explicit_update(C, diff, adv, dt, i_fluid | i_solid, kit)


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
