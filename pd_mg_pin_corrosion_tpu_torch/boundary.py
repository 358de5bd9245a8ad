"""Boundary conditions as masked-tensor updates.

Port of ``pd_mg_pin_corrosion_tpu/boundary.py`` (reference
src/boundary.cpp), 2D and 3D. Neighbour averages are stencil-shift sums
over ``kit.neighbors`` with dynamic node-type masks, taken over slot chunks
(``kit.slot_chunks``) so a 3D call never holds a [178, N] stack of the
whole grid; all reads come from the input snapshot (the race-free fixed
point of the reference's in-place sweeps). Under ``gs_parity`` the outlet
BC and the smoothing instead replay the reference's in-place sweeps under
one thread, in node order on the host (``_gs_outlet_bc``, ``_gs_smooth``):
a parity mode that copies the band to the host and back at every call.
Each function returns a new State; the tensors it changes are fresh copies.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from .fields import State
from .grid import FLUID, OUTLET, SOLID_MG
from .kit import Kit


def _band_sums(kit: Kit, values, pred, lo: int, hi: int):
    """Neighbour sums over rows [lo, hi): ([sum_s value_j * pred_j ...],
    count_s pred_j). The INLET/OUTLET ghost layers occupy fixed axial rows
    (kit.inlet_rows / kit.outlet_rows), so these flow-loop BCs only touch a
    thin slab of rows (on a mesh's slab, of its own rows: ``kit.band_rows``)."""
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
    lo, hi = kit.band_rows[0], kit.inlet_rows
    if hi <= lo:
        return state
    fluid = (state.node_type == FLUID).to(kit.dtype)
    (tot,), cnt = _band_sums(kit, [state.rho], fluid, lo, hi)
    inlet_b = kit.inlet_mask[lo:hi]

    rho = state.rho.clone()
    rho_avg = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), cfg.rho_f)
    rho[lo:hi] = torch.where(inlet_b, rho_avg, state.rho[lo:hi])
    vel = state.vel.clone()
    v_in = torch.zeros_like(vel[lo:hi])
    v_in[..., kit.axial_comp] = kit.v_pois[lo:hi]
    vel[lo:hi] = torch.where(inlet_b[..., None], v_in, state.vel[lo:hi])
    C = state.C.clone()
    C[lo:hi] = torch.where(inlet_b, cfg.C_liquid_init, state.C[lo:hi])
    return replace(state, rho=rho, vel=vel, C=C)


def apply_outlet_bc(state: State, kit: Kit) -> State:
    """Pressure outlet: rho=rho_f (=> p=0), zero-gradient v (axial only) and
    C from FLUID/OUTLET neighbours (boundary.cpp:88-131)."""
    cfg = kit.cfg
    if kit.gs is not None:
        return _gs_outlet_bc(state, kit)
    lo, n0 = kit.outlet_rows, kit.band_rows[1]
    if lo >= n0:
        return state
    ax = kit.axial_comp
    nt = state.node_type
    pred = ((nt == FLUID) | (nt == OUTLET)).to(kit.dtype)
    (v_tot, C_tot), cnt = _band_sums(kit, [state.vel[..., ax], state.C],
                                     pred, lo, n0)
    outlet_b = kit.outlet_mask[lo:n0]
    safe_cnt = torch.clamp(cnt, min=1.0)
    v_ax = torch.where(cnt > 0, v_tot / safe_cnt, cfg.U_in)
    C_avg = torch.where(cnt > 0, C_tot / safe_cnt, 0.0)

    rho = state.rho.clone()
    rho[lo:n0] = torch.where(outlet_b, cfg.rho_f, state.rho[lo:n0])
    vel = state.vel.clone()
    v_out = torch.zeros_like(vel[lo:n0])
    v_out[..., ax] = v_ax
    vel[lo:n0] = torch.where(outlet_b[..., None], v_out, state.vel[lo:n0])
    C = state.C.clone()
    C[lo:n0] = torch.where(outlet_b, C_avg, state.C[lo:n0])
    return replace(state, rho=rho, vel=vel, C=C)


def apply_wall_bc(state: State, kit: Kit) -> State:
    """FNM wall mirror (boundary.cpp:143-294): density symmetric, velocity
    antisymmetric (no-slip) from each wall node's static mirror source;
    wall nodes without a source pin vel = 0, rho = rho_f. One flat gather
    (the JAX package's 13 roll groups move the same values). Under
    wall_mirror_subcell (3D) the wall nodes of the primary columns then
    take the bilinear sum of their sources (JAX: the weighted matmul)."""
    cfg = kit.cfg
    rho, vel = state.rho, state.vel
    src = kit.mirror_src.reshape(-1)
    rho_m = rho.reshape(-1)[src].view(kit.shape)
    vel_m = vel.reshape(-1, kit.dim)[src].view(vel.shape)

    rho_out = torch.where(kit.mirror_none_mask, cfg.rho_f, rho)
    vel_out = torch.where(kit.mirror_none_mask[..., None], 0.0, vel)
    rho_out = torch.where(kit.mirror_mask, rho_m, rho_out)
    vel_out = torch.where(kit.mirror_mask[..., None], -vel_m, vel_out)
    if kit.mirror_sub_dst.numel():
        # the terms in the matmul's order: ascending source, then zeros
        src, w = kit.mirror_sub_src, kit.mirror_sub_w
        rf, vf = rho.reshape(-1), vel.reshape(-1, kit.dim)
        r_sub = w[0] * rf[src[0]]
        v_sub = w[0, :, None] * vf[src[0]]
        for k in range(1, src.shape[0]):
            r_sub = r_sub + w[k] * rf[src[k]]
            v_sub = v_sub + w[k, :, None] * vf[src[k]]
        rho_out.view(-1)[kit.mirror_sub_dst] = r_sub
        vel_out.view(-1, kit.dim)[kit.mirror_sub_dst] = -v_sub
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
    if kit.gs is not None:
        return _gs_smooth(state, kit)
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


# ---------------------------------------------------------------------------
# gs_parity: the reference's in-place sweeps under one thread
# ---------------------------------------------------------------------------

def _host_values(t: torch.Tensor, index: torch.Tensor) -> list:
    """t's flat values at ``index`` on the host, as scalars that round as
    t's dtype does: Python floats in float64, numpy float32 scalars in
    float32."""
    a = t.reshape(-1)[index].cpu().numpy()
    return a.tolist() if a.dtype == np.float64 else list(a)


def _scalar(kit: Kit):
    return float if kit.dtype == torch.float64 else np.float32


def _tensor(values, like: torch.Tensor) -> torch.Tensor:
    """Host scalars as a tensor of like's dtype on like's device."""
    return torch.as_tensor(np.asarray(values, str(like.dtype).split(".")[-1]),
                           device=like.device)


def _gs_outlet_bc(state: State, kit: Kit) -> State:
    """Sequential in-place outlet sweep in reference node order
    (boundary.cpp:88-131 under one OpenMP thread; JAX ``_gs_outlet_bc``):
    each OUTLET node's neighbour average reads the values that lower-index
    OUTLET nodes of the same sweep already wrote. The reference's
    arithmetic: sums over the slots in slot order, one add at a time;
    velocity v_tot * (1/count), C C_tot / count; rho = rho_f and the
    non-axial velocity components 0 on every OUTLET node."""
    cfg = kit.cfg
    sw = kit.gs.outlet
    ax = kit.axial_comp
    num = _scalar(kit)
    nt = state.node_type.reshape(-1)[sw.band].tolist()
    C = _host_values(state.C, sw.band)
    v = _host_values(state.vel[..., ax], sw.band)
    for i, js in sw.nodes:
        cnt = 0
        v_tot = C_tot = num(0.0)
        for j in js:
            if nt[j] == FLUID or nt[j] == OUTLET:
                cnt += 1
                v_tot = v_tot + v[j]
                C_tot = C_tot + C[j]
        if cnt:
            v[i] = v_tot * (num(1.0) / num(cnt))
            C[i] = C_tot / num(cnt)
        else:
            v[i] = num(cfg.U_in)
            C[i] = num(0.0)

    v_out = torch.zeros((len(sw.nodes), kit.dim), dtype=state.vel.dtype,
                        device=state.vel.device)
    v_out[:, ax] = _tensor(v, state.vel)[sw.swept]
    vel = state.vel.clone()
    vel.view(-1, kit.dim)[sw.band[sw.swept]] = v_out
    C_out = state.C.clone()
    C_out.view(-1)[sw.band] = _tensor(C, state.C)
    rho = torch.where(kit.outlet_mask, cfg.rho_f, state.rho)
    return replace(state, rho=rho, vel=vel, C=C_out)


def _gs_smooth(state: State, kit: Kit) -> State:
    """Sequential in-place smoothing sweep in reference node order
    (boundary.cpp:332-376 under one thread; JAX ``_gs_smooth``): a FLUID
    node of the near-inlet / near-outlet band takes the average C of its
    FLUID neighbours on the interior side, reading the C that lower-index
    band nodes of the same sweep already wrote."""
    sw = kit.gs.smooth
    num = _scalar(kit)
    nt = state.node_type.reshape(-1)[sw.band].tolist()
    C = _host_values(state.C, sw.band)
    for i, js in sw.nodes:
        cnt = 0
        tot = num(0.0)
        for j in js:
            if nt[j] == FLUID:
                cnt += 1
                tot = tot + C[j]
        if cnt and nt[i] == FLUID:
            C[i] = tot / num(cnt)
    C_out = state.C.clone()
    C_out.view(-1)[sw.band] = _tensor(C, state.C)
    return replace(state, C=C_out)
