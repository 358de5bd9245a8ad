"""Steady-state flow solve, host loop over device steps.

Port of ``solve_steady`` / ``_channel_flow_corrections`` /
``coarse_warm_start`` / ``poiseuille_l2_error`` of
``pd_mg_pin_corrosion_tpu/solvers.py``, keeping
the reference's cadence exactly (src/pd_ns.cpp:182-372): checks on the
first 10 iterations and every 100th, convergence only for iter > 100, the
velocity-blowup guard at 100x U_in, dt refresh every 200 iterations, and an
early exit that keeps the pre-step (BC-applied) buffers. The loop syncs
with the device only on check iterations. The JAX package's 2000-iteration
segments existed for the TPU runtime's execution deadline and do not change
results, so there are none here.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from .dispatch import is_structured, ops_for
from .fields import State
from .grid import FLUID
from .kit import Kit
from .ops.ns import vel_magnitude
from .parallel.sharding import all_reduce


def _channel_flow_corrections(state: State, kit: Kit) -> State:
    """Poiseuille-validation-only corrections (pd_ns.cpp:209-270): zero
    transverse velocity and cross-sectionally averaged density on FLUID
    (averaged over all non-axial array axes: per row in 2D, per z-plane in
    3D)."""
    fluid = state.node_type == FLUID
    vel = state.vel.clone()
    for d in range(kit.dim):
        if d != kit.axial_comp:
            vel[..., d] = torch.where(fluid, 0.0, state.vel[..., d])
    fl = fluid.to(kit.dtype)
    rest = tuple(range(1, kit.dim))
    rho_sum = (state.rho * fl).sum(dim=rest, keepdim=True)
    cnt = fl.sum(dim=rest, keepdim=True)
    rho_avg = torch.where(cnt > 0, rho_sum / torch.clamp(cnt, min=1.0), 0.0)
    rho = torch.where(fluid & (cnt > 0), rho_avg, state.rho)
    return replace(state, vel=vel, rho=rho)


def _pre_bcs(st: State, kit, ops) -> State:
    st = ops.apply_inlet_bc(st, kit)
    st = ops.apply_outlet_bc(st, kit)
    st = ops.apply_wall_bc(st, kit)
    return ops.apply_solid_surface_bc(st, kit)


def _check(st_bc: State, st_new: State, kit):
    """(eps, v_max, rho_min, rho_max, converged-if-past-100, diverged),
    computed on the device in the run dtype and read in ONE transfer.
    Under a mesh the sums of eps and the extremes are reduced over the
    ranks first (the extremes exactly; eps rounds as the ranks' order of
    sums does)."""
    cfg = kit.cfg
    fluid = st_bc.node_type == FLUID
    f2 = fluid[..., None]
    dv = st_new.vel - st_bc.vel
    num = torch.where(f2, dv * dv, 0.0).sum()
    den = torch.where(f2, st_bc.vel * st_bc.vel, 0.0).sum()
    num, den = all_reduce(kit, (num, den))
    eps = torch.where(den > 1e-30,
                      torch.sqrt(num / torch.clamp(den, min=1e-300)),
                      torch.sqrt(num))
    v_max = torch.where(fluid, vel_magnitude(st_new.vel), 0.0).max()
    has_nan = (torch.where(f2, torch.isnan(st_new.vel), False).any()
               | torch.where(fluid, torch.isnan(st_new.rho), False).any())
    rho_fl = torch.where(fluid, st_new.rho, cfg.rho_f)
    v_max, has_nan, rho_max = all_reduce(
        kit, (v_max, has_nan, rho_fl.max()), "max")
    rho_min = all_reduce(kit, rho_fl.min(), "min")
    flags = torch.stack([eps, v_max, rho_min, rho_max,
                         (eps < cfg.flow_conv_tol).to(eps.dtype),
                         (has_nan | (v_max > 100.0 * cfg.U_in)).to(eps.dtype)])
    e, vm, rmin, rmax, conv, div = flags.tolist()
    return e, vm, rmin, rmax, bool(conv), bool(div)


def solve_steady(state: State, kit, verbose: bool = False,
                 max_iters: int | None = None):
    """Run the flow solver to steady state, on a uniform grid's Kit or a
    block-AMR BKit (``dispatch.ops_for``).

    Returns (state, iters, eps, converged, diverged) with Python scalars.
    ``iters`` is the reference's loop variable at exit (the iteration that
    broke, or flow_max_iters + 1 on exhaustion). ``verbose`` prints the
    reference's per-iteration telemetry line (pd_ns.cpp:304-306) at the
    same cadence (first 10 iterations and every output_every_flow). Every
    iteration that does not break refreshes the AMR fictitious nodes
    (pd_ns.cpp:325-328; nothing on a uniform grid).
    """
    cfg = kit.cfg
    ops = ops_for(kit)
    corrections = cfg.channel_flow_corrections and is_structured(kit)
    cap = cfg.flow_max_iters if max_iters is None else max_iters
    verbose = verbose or bool(os.environ.get("PD_TPU_VERBOSE_FLOW"))
    dt = ops.compute_dt_ns(state, kit)
    it, eps, conv, div = 1, 1.0, False, False
    while it <= cap:
        st_bc = _pre_bcs(state, kit, ops)
        st_new = ops.ns_step(st_bc, kit, dt)
        # wall BC on the new buffers (pd_ns.cpp:205)
        st_new = ops.apply_wall_bc(st_new, kit)
        if corrections:
            st_new = _channel_flow_corrections(st_new, kit)

        if it <= 10 or it % 100 == 0:
            eps, v_max, rmin, rmax, eps_ok, div = _check(st_bc, st_new, kit)
            conv = eps_ok and it > 100
            if verbose and (it <= 10 or it % cfg.output_every_flow == 0):
                print(f"  Flow iter {it}: eps={eps:.3e}  v_max={v_max:.4e}  "
                      f"rho=[{rmin:.2f},{rmax:.2f}]  dt={float(dt):.3e}")
            if conv or div:
                # the reference breaks before swapping buffers
                state = st_bc
                break
        state = ops.update_fictitious(st_new, kit)
        if it % 200 == 0:
            dt = ops.compute_dt_ns(state, kit)  # dt refresh (pd_ns.cpp:331-333)
        it += 1

    state = replace(state, pressure=ops.tait_pressure(state.rho, kit))
    return state, it, eps, conv, div


def coarse_warm_start(state: State, grid, kit, cfg):
    """Coarse-grid warm start for the INITIAL steady flow solve
    (cfg.flow_warm_start = coarsening ratio; JAX ``solvers.py:207-271``),
    on a uniform grid or a block-AMR one.

    Solves steady flow on the uniform coarse twin of the same geometry (cfg
    with dx * ratio and no AMR, on the kit's device and dtype), then samples
    its (rho, vel) trilinearly at the node positions (``grid.pos``:
    [..., dim] on a uniform grid, [N, dim] flat on a block-AMR one), in
    float64 on the host
    (``scipy.ndimage.map_coordinates``, order 1, mode "nearest", as the
    reference does), and writes them onto FLUID nodes only, with the
    pressure recomputed. The fine solve's convergence gate is unchanged.

    Returns (state, coarse_iters); (state, 0) unchanged when the coarse
    grid has no SOLID_MG node or the coarse solve diverged.
    """
    import copy

    from scipy.ndimage import map_coordinates

    from .fields import initialize_state
    from .grid import SOLID_MG, build_grid
    from .kit import build_kit

    ratio = int(cfg.flow_warm_start)
    ccfg = copy.copy(cfg)
    ccfg.dx = cfg.dx * ratio
    ccfg.use_amr = 0
    ccfg.flow_warm_start = 0
    ccfg.compute_derived()

    cgrid = build_grid(ccfg)
    # degenerate coarse geometry (e.g. the wire thinner than dx_coarse)
    if not (cgrid.node_type == SOLID_MG).any():
        print("  Warm start skipped: no solid nodes at coarse spacing")
        return state, 0
    ckit = build_kit(cgrid, ccfg, dtype=kit.dtype, device=kit.device)
    cstate = initialize_state(cgrid, ccfg, grains=None, dtype=kit.dtype,
                              device=kit.device)

    cstate, it, eps, conv, div = solve_steady(cstate, ckit)
    if div:
        print("  Warm start skipped: coarse solve diverged")
        return state, 0
    print(f"  Warm start: coarse ({ratio}x dx, {cgrid.N_total} nodes) solve "
          f"{it} iters, eps={eps:.3e}, converged={conv}")

    # trilinear sample of the coarse fields at the fine node positions
    # (host, one-time). Coarse index space: i_d = (pos_d - origin_d) / dx_c;
    # the array layout is [z,] y, x, so the components go in reverse order
    coords = [(grid.pos[..., d] - cgrid.origin[d]) / ccfg.dx
              for d in range(grid.dim)][::-1]

    def interp(a):
        return map_coordinates(a.cpu().numpy().astype(np.float64), coords,
                               order=1, mode="nearest")

    rho_i = interp(cstate.rho)
    vel_i = np.stack([interp(cstate.vel[..., d]) for d in range(grid.dim)],
                     axis=-1)

    def to_run(a):
        return torch.as_tensor(a).to(device=kit.device, dtype=kit.dtype)

    fluid = state.node_type == FLUID
    rho = torch.where(fluid, to_run(rho_i), state.rho)
    vel = torch.where(fluid[..., None], to_run(vel_i), state.vel)
    return replace(state, rho=rho, vel=vel,
                   pressure=ops_for(kit).tait_pressure(rho, kit)), it


def poiseuille_l2_error(state: State, grid, cfg) -> float:
    """Poiseuille validation at the upstream station (pd_ns.cpp:341-368).

    2D only, matching the reference. Returns the relative L2 error, or NaN
    when no sample nodes exist.
    """
    y_check = -cfg.L_upstream / 2.0
    nt = state.node_type.cpu().numpy()
    vel = state.vel.cpu().numpy()
    py = grid.pos[..., 1]
    px = grid.pos[..., 0]

    sel = (nt == FLUID) & (np.abs(py - y_check) <= 0.6 * cfg.dx)
    r_norm = px / cfg.R_tube
    sel &= np.abs(r_norm) <= 1.0
    if not sel.any():
        return float("nan")
    v_ana = 1.5 * cfg.U_in * (1.0 - r_norm[sel] ** 2)
    v_num = vel[..., 1][sel]
    err = np.sqrt(np.sum((v_num - v_ana) ** 2) / np.maximum(np.sum(v_ana**2), 1e-30))
    return float(err)
