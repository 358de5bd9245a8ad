"""PD Navier-Stokes: Tait EOS, CFL dt, and the weakly compressible step.

Port of ``pd_mg_pin_corrosion_tpu/ops/ns.py`` (reference src/pd_ns.cpp).
The bond loop itself is ``kernels.ns2d`` / ``kernels.ns3d``: the CUDA
kernel for float32 on the card, its plain twin on the CPU and for float64.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..fields import State
from ..grid import FLUID
from ..kernels import ns2d, ns2d_plain, ns3d, ns3d_plain
from ..kit import Kit


def tait_pressure(rho: torch.Tensor, kit: Kit) -> torch.Tensor:
    """Tait EOS with density-ratio clamp (pd_ns.cpp:36-50)."""
    cfg = kit.cfg
    B = cfg.rho_f * cfg.c0 * cfg.c0 / cfg.gamma_eos
    # times the reciprocal: what XLA makes of the reference's rho / rho_f,
    # and what torch does on CUDA for a tensor / scalar division anyway
    ratio = torch.clamp(rho * (1.0 / cfg.rho_f), 0.5, 2.0)
    return B * (torch.pow(ratio, cfg.gamma_eos) - 1.0)


def vel_magnitude(vel: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((vel * vel).sum(-1))


def fluid_vmax(state: State, kit: Kit) -> torch.Tensor:
    """max |v| over FLUID nodes (pd_ns.cpp:52-62)."""
    fluid = state.node_type == FLUID
    return torch.where(fluid, vel_magnitude(state.vel), 0.0).max()


def compute_dt(state: State, kit: Kit) -> torch.Tensor:
    """CFL timestep (pd_ns.cpp:52-76): min of acoustic, viscous,
    density-diffusive. A 0-d tensor of the run dtype, on the device."""
    cfg = kit.cfg
    v_max = fluid_vmax(state, kit)
    # a tensor numerator: torch turns scalar / tensor into a reciprocal
    # times the scalar, one rounding more than the reference's division
    dt_cfl = v_max.new_tensor(cfg.dx) / (cfg.c0 + v_max + 1e-30)
    nu = cfg.mu_f / cfg.rho_f
    dt_visc = 0.25 * cfg.dx * cfg.dx / (nu + 1e-30)
    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    dt_dens = 0.25 * cfg.dx * cfg.dx / (D_v + 1e-30)
    return cfg.cfl_factor * torch.clamp(dt_cfl, max=min(dt_visc, dt_dens))


def ns_step(state: State, kit: Kit, dt) -> State:
    """One explicit PD-NS step (pd_ns.cpp:78-180).

    Returns a new State with updated rho/vel on FLUID nodes (all other node
    types pass through) and pressure = Tait(rho_in) as computed at step
    entry (pd_ns.cpp:79).
    """
    pressure = tait_pressure(state.rho, kit)
    dt = torch.as_tensor(dt, dtype=kit.dtype, device=kit.device)
    if kit.dim == 2:
        step = ns2d if kit.dtype == torch.float32 else ns2d_plain
    else:
        step = ns3d if kit.dtype == torch.float32 else ns3d_plain
    rho, vel = step(state.rho, state.vel, pressure, state.node_type, dt, kit)
    return replace(state, rho=rho, vel=vel, pressure=pressure)
