"""Boundary conditions as masked-tensor updates.

Port of the functional (non-gs_parity) 2D and 3D paths of
``pd_mg_pin_corrosion_tpu/boundary.py`` (reference src/boundary.cpp).
Neighbour averages are stencil-shift sums over ``kit.neighbors`` with
dynamic node-type masks, taken over slot chunks (``kit.slot_chunks``) so a
3D call never holds a [178, N] stack of the whole grid; all reads come from
the input snapshot (the race-free fixed point of the reference's in-place
sweeps). Each function returns a new State; the tensors it changes are
fresh copies.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from .fields import State
from .grid import FLUID, OUTLET, SOLID_MG
from .kit import Kit


def _band_sums(kit: Kit, values, pred, lo: int, hi: int):
    """Neighbour sums over rows [lo, hi): ([sum_s value_j * pred_j ...],
    count_s pred_j). The INLET/OUTLET ghost layers occupy fixed axial rows
    (kit.inlet_rows / kit.outlet_rows), so these flow-loop BCs only touch a
    thin slab of rows."""
    pads = [kit.pad(f, 0.0) for f in [pred, *values]]
    shape = (hi - lo,) + kit.shape[1:]
    totals = [torch.zeros(shape, dtype=kit.dtype, device=kit.device)
              for _ in pads]
    for s0, s1 in kit.slot_chunks(math.prod(shape)):
        P = kit.neighbors(pads[0], lo, hi, s0, s1)
        totals[0] += P.sum(0)
        for t, vp in zip(totals[1:], pads[1:]):
            t += (kit.neighbors(vp, lo, hi, s0, s1) * P).sum(0)
    return totals[1:], totals[0]


def apply_inlet_bc(state: State, kit: Kit) -> State:
    """Prescribed Poiseuille velocity, rho extrapolated from FLUID
    neighbours, fresh SBF C (boundary.cpp:31-75)."""
    cfg = kit.cfg
    hi = kit.inlet_rows
    if hi == 0:
        return state
    fluid = (state.node_type == FLUID).to(kit.dtype)
    (tot,), cnt = _band_sums(kit, [state.rho], fluid, 0, hi)
    inlet_b = kit.inlet_mask[:hi]

    rho = state.rho.clone()
    rho_avg = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), cfg.rho_f)
    rho[:hi] = torch.where(inlet_b, rho_avg, state.rho[:hi])
    vel = state.vel.clone()
    v_in = torch.zeros_like(vel[:hi])
    v_in[..., kit.axial_comp] = kit.v_pois[:hi]
    vel[:hi] = torch.where(inlet_b[..., None], v_in, state.vel[:hi])
    C = state.C.clone()
    C[:hi] = torch.where(inlet_b, cfg.C_liquid_init, state.C[:hi])
    return replace(state, rho=rho, vel=vel, C=C)


def apply_outlet_bc(state: State, kit: Kit) -> State:
    """Pressure outlet: rho=rho_f (=> p=0), zero-gradient v (axial only) and
    C from FLUID/OUTLET neighbours (boundary.cpp:88-131)."""
    cfg = kit.cfg
    lo, n0 = kit.outlet_rows, kit.shape[0]
    if lo >= n0:
        return state
    ax = kit.axial_comp
    nt = state.node_type
    pred = ((nt == FLUID) | (nt == OUTLET)).to(kit.dtype)
    (v_tot, C_tot), cnt = _band_sums(kit, [state.vel[..., ax], state.C],
                                     pred, lo, n0)
    outlet_b = kit.outlet_mask[lo:]
    safe_cnt = torch.clamp(cnt, min=1.0)
    v_ax = torch.where(cnt > 0, v_tot / safe_cnt, cfg.U_in)
    C_avg = torch.where(cnt > 0, C_tot / safe_cnt, 0.0)

    rho = state.rho.clone()
    rho[lo:] = torch.where(outlet_b, cfg.rho_f, state.rho[lo:])
    vel = state.vel.clone()
    v_out = torch.zeros_like(vel[lo:])
    v_out[..., ax] = v_ax
    vel[lo:] = torch.where(outlet_b[..., None], v_out, state.vel[lo:])
    C = state.C.clone()
    C[lo:] = torch.where(outlet_b, C_avg, state.C[lo:])
    return replace(state, rho=rho, vel=vel, C=C)


def apply_wall_bc(state: State, kit: Kit) -> State:
    """FNM wall mirror (boundary.cpp:143-294): density symmetric, velocity
    antisymmetric (no-slip) from each wall node's static mirror source;
    wall nodes without a source pin vel = 0, rho = rho_f. One flat gather
    (the JAX package's 13 roll groups move the same values)."""
    cfg = kit.cfg
    rho, vel = state.rho, state.vel
    src = kit.mirror_src.reshape(-1)
    rho_m = rho.reshape(-1)[src].view(kit.shape)
    vel_m = vel.reshape(-1, kit.dim)[src].view(vel.shape)

    rho_out = torch.where(kit.mirror_none_mask, cfg.rho_f, rho)
    vel_out = torch.where(kit.mirror_none_mask[..., None], 0.0, vel)
    rho_out = torch.where(kit.mirror_mask, rho_m, rho_out)
    vel_out = torch.where(kit.mirror_mask[..., None], -vel_m, vel_out)
    return replace(state, rho=rho_out, vel=vel_out)


def apply_wall_concentration_bc(state: State, kit: Kit) -> State:
    """Neumann zero-gradient C at tube walls (boundary.cpp:302-321)."""
    fluid = (state.node_type == FLUID).to(kit.dtype)
    (tot,), cnt = _band_sums(kit, [state.C], fluid, 0, kit.shape[0])
    C_avg = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), 0.0)
    return replace(state, C=torch.where(kit.wall_mask, C_avg, state.C))


def smooth_boundary_concentration(state: State, kit: Kit) -> State:
    """Replace C of FLUID nodes within delta of inlet/outlet by the
    interior-side FLUID-neighbour average (boundary.cpp:332-376). The
    interior-side test is static per slot: the sign of its axial offset
    (toward the outlet near the inlet, toward the inlet near the outlet;
    axial-neutral slots never count)."""
    fluid = state.node_type == FLUID
    near_in = kit.near_inlet_mask & fluid
    near_out = kit.near_outlet_mask & fluid
    d_ax = torch.tensor([o[0] for o in kit.offsets], device=kit.device)
    d_ax = d_ax.view((-1,) + (1,) * kit.dim)
    fl_p = kit.pad(fluid.to(kit.dtype), 0.0)
    C_p = kit.pad(state.C, 0.0)
    tot = torch.zeros_like(state.C)
    cnt = torch.zeros_like(state.C)
    for s0, s1 in kit.slot_chunks():
        d = d_ax[s0:s1]
        use = ((d > 0) & near_in) | ((d < 0) & near_out)   # [slots, *shape]
        sel = torch.where(use, kit.neighbors(fl_p, s0=s0, s1=s1), 0.0)
        tot += (kit.neighbors(C_p, s0=s0, s1=s1) * sel).sum(0)
        cnt += sel.sum(0)

    C_sm = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), state.C)
    C = torch.where((near_in | near_out) & (cnt > 0), C_sm, state.C)
    return replace(state, C=C)


def apply_solid_surface_bc(state: State, kit: Kit) -> State:
    """Zero velocity on the Mg pin (boundary.cpp:381-390)."""
    solid = state.node_type == SOLID_MG
    return replace(state, vel=torch.where(solid[..., None], 0.0, state.vel))
