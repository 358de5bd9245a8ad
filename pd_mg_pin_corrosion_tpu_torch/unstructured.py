"""Gather backend for unstructured (AMR) grids: ``amr_backend = gather``.

Port of ``pd_mg_pin_corrosion_tpu/unstructured.py``. The grid of
``amr.build_amr_grid`` has no shared stencil, so every bond sum is a gather
``field[nbr_idx]`` -> [N, K] over the fixed-degree padded neighbour arrays
followed by a masked reduction over the K axis. Per-node PD constants
(V_H, beta) come from delta_local as in the reference's AMR branches
(pd_ns.cpp:19-33, pd_ard.cpp:17-31, pd_ard_implicit.cpp:22-37).

The JAX package has no Pallas kernel for this backend, so the flow step,
the BCs, transport and the matvec are plain PyTorch here too; GMRES goes
through ``ops.gmres`` and so, on the card in float32, through the
basis_dots / basis_axpy kernels. A gather is one ``index_select`` over the
flattened [N * K] index. The functions have the signatures of the other
backends; ``dispatch.ops_for`` picks them for a ``UKit``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .amr import AMRGrid
from .amr_blocks import adaptive_dt, idw_overwrite, idw_system
from .config import Config, FrozenConfig
from .fields import State, poiseuille_axial, resolve_device
from .grid import FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL
from .kernels.ard2d import interface_D, is_liquid
from .ops.ard import micro_d_factor, solid_diffusivity
from .ops.ns import tait_pressure, vel_magnitude
# shape-agnostic ops of the uniform grid, the gather backend's in dispatch
from .ops.ard import apply_phase_change  # noqa: F401
from .ops.ard import compute_dt as ard_compute_dt  # noqa: F401
from .ops.ns import compute_dt as compute_dt_ns  # noqa: F401

PI = math.pi


@dataclass(frozen=True, eq=False)
class UKit:
    """The gather backend's device tables."""

    nbr_idx: torch.Tensor        # [N, K] int64 (self where a slot is invalid)
    nbr_dist: torch.Tensor       # [N, K] (1 where invalid)
    nbr_evec: torch.Tensor       # [N, K, dim]
    nbr_vol: torch.Tensor        # [N, K] (0 marks invalid slots)
    # per-bond constants the steps share, as the JAX package forms them
    nbr_e: torch.Tensor          # [dim, N, K] nbr_evec by component
    valid: torch.Tensor          # [N, K] bool: nbr_vol > 0
    inv_xi: torch.Tensor         # [N, K] 1 / nbr_dist
    inv_xi2: torch.Tensor        # [N, K] inv_xi * inv_xi
    w_xi: torch.Tensor           # [N, K] inv_xi * nbr_vol
    w_xi2: torch.Tensor          # [N, K] inv_xi2 * nbr_vol
    V_H_node: torch.Tensor       # [N]
    beta_node: torch.Tensor      # [N]
    delta_node: torch.Tensor     # [N]
    inlet_mask: torch.Tensor     # [N] bool
    outlet_mask: torch.Tensor
    wall_mask: torch.Tensor
    near_inlet_mask: torch.Tensor
    near_outlet_mask: torch.Tensor
    v_pois: torch.Tensor         # [N]
    mirror_flat: torch.Tensor    # [N] int64 (-1 none)
    initial_solid_mask: torch.Tensor
    fict_nodes: torch.Tensor     # [Nf] int64
    fict_src: torch.Tensor       # [Nf, Kf] int64
    fict_w: torch.Tensor         # [Nf, Kf] run dtype

    cfg: FrozenConfig
    dim: int
    N: int
    K: int
    dtype: torch.dtype
    device: torch.device

    @property
    def shape(self):
        return (self.N,)

    @property
    def axial_comp(self) -> int:
        return self.dim - 1

    @property
    def alpha(self) -> float:
        return float(self.dim)


def build_ukit(grid: AMRGrid, cfg: Config, dtype=None,
               device="cuda") -> UKit:
    """The gather kit of ``grid``, on the card unless ``device="cpu"`` (no
    card: DeviceUnavailable)."""
    if dtype is None:
        dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    device = resolve_device(device)

    def dev(a, t=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=t)

    nt = grid.node_type
    d = grid.delta_local
    if cfg.dim == 2:
        V_H = PI * d * d
        beta = 4.0 / (PI * d * d)
    elif cfg.legacy_3d_constants:
        V_H = (4.0 / 3.0) * PI * d**3
        beta = 12.0 / (PI * d * d)  # the reference's broken 3D value
    else:
        V_H = (4.0 / 3.0) * PI * d**3
        beta = 9.0 / (2.0 * PI * d**3)  # corrected (see kit.Kit.beta_lap)

    y = grid.pos[..., grid.axial_axis]
    near_in = (y - (-cfg.L_upstream)) < grid.delta_local
    near_out = ((cfg.L_wire + cfg.L_downstream) - y) < grid.delta_local

    nbr_dist = dev(grid.nbr_dist, dtype)
    nbr_evec = dev(grid.nbr_evec, dtype)
    nbr_vol = dev(grid.nbr_vol, dtype)
    inv_xi = 1.0 / nbr_dist
    inv_xi2 = inv_xi * inv_xi
    return UKit(
        nbr_idx=dev(grid.nbr_idx, torch.int64),
        nbr_dist=nbr_dist, nbr_evec=nbr_evec, nbr_vol=nbr_vol,
        nbr_e=nbr_evec.permute(2, 0, 1).contiguous(), valid=nbr_vol > 0,
        inv_xi=inv_xi, inv_xi2=inv_xi2, w_xi=inv_xi * nbr_vol,
        w_xi2=inv_xi2 * nbr_vol,
        V_H_node=dev(V_H, dtype),
        beta_node=dev(beta, dtype),
        delta_node=dev(d, dtype),
        inlet_mask=dev(nt == INLET),
        outlet_mask=dev(nt == OUTLET),
        wall_mask=dev(nt == WALL),
        near_inlet_mask=dev(near_in),
        near_outlet_mask=dev(near_out),
        v_pois=dev(poiseuille_axial(cfg, grid.pos), dtype),
        mirror_flat=dev(grid.mirror_idx, torch.int64),
        initial_solid_mask=dev(nt == SOLID_MG),
        fict_nodes=dev(grid.fict_nodes, torch.int64),
        fict_src=dev(grid.fict_src, torch.int64),
        fict_w=dev(grid.fict_w, dtype),
        cfg=FrozenConfig(cfg), dim=grid.dim, N=grid.N_total, K=grid.K,
        dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# gather helpers
# ---------------------------------------------------------------------------

def _g(kit: UKit, a: torch.Tensor) -> torch.Tensor:
    """Neighbour values of a field [N] (or of one component, a strided
    view of [N, d]): [N, K]."""
    return a.index_select(0, kit.nbr_idx.reshape(-1)).view(kit.nbr_idx.shape)


def _dot_e(kit: UKit, a) -> torch.Tensor:
    """sum_d a[d] e_d over the bonds, a[d] broadcasting against [N, K]."""
    out = a[0] * kit.nbr_e[0]
    for d in range(1, kit.dim):
        out = out + a[d] * kit.nbr_e[d]
    return out


# ---------------------------------------------------------------------------
# PD-NS (tait_pressure and compute_dt_ns are the uniform grid's: the EOS
# and the finest dx's CFL limit, pd_ns.cpp:36-76)
# ---------------------------------------------------------------------------

def ns_step(state: State, kit: UKit, dt) -> State:
    """Gather-based PD-NS step with per-node AMR constants
    (pd_ns.cpp:78-180): rho and vel change on FLUID nodes only. The terms
    of JAX ``ns_step``, one velocity component at a time."""
    cfg = kit.cfg
    dims = range(kit.dim)
    dt = torch.as_tensor(dt, dtype=kit.dtype, device=kit.device)

    pressure = tait_pressure(state.rho, kit)
    rho_i, vel_i, p_i = state.rho, state.vel, pressure
    rho_j, p_j = _g(kit, rho_i), _g(kit, p_i)                # [N, K]
    v_i = [vel_i[:, d] for d in dims]                          # [N]
    v_j = [_g(kit, v) for v in v_i]                            # [N, K]
    ri = rho_i[:, None]
    rv_i = [(rho_i * v)[:, None] for v in v_i]                 # rho_i v_id
    rv_j = [rho_j * v for v in v_j]                            # rho_j v_jd

    D_v = cfg.eta_density * cfg.c0 * kit.delta_node
    dens_coeff = (kit.beta_node * D_v)[:, None]

    # mass: sum_K (sum_d (rho_j v_jd - rho_i v_id) e_d) / xi V, and the
    # density diffusion
    flux = _dot_e(kit, [rv_j[d] - rv_i[d] for d in dims])
    mass_conv = (flux * kit.inv_xi * kit.nbr_vol).sum(-1)
    mass_diff = (dens_coeff * (rho_j - ri) * kit.inv_xi2
                 * kit.nbr_vol).sum(-1)

    # momentum: convection sum_dp (rho_j v_jd v_jdp - rho_i v_id v_idp)
    # e_dp, pressure and viscosity, per component d
    dp = (p_j - p_i[:, None]) * kit.inv_xi * kit.nbr_vol
    mom = []
    for d in dims:
        conv = _dot_e(kit, [rv_j[d] * v_j[q] - rv_i[d] * v_i[q][:, None]
                            for q in dims])
        mom_conv = (conv * kit.w_xi).sum(-1)
        mom_pres = (dp * kit.nbr_e[d]).sum(-1)
        mom_visc = ((v_j[d] - v_i[d][:, None]) * kit.w_xi2).sum(-1)
        mom.append((mom_conv + mom_pres, mom_visc))

    alpha_invVH = kit.alpha * (1.0 / kit.V_H_node)
    rho_new = rho_i + dt * (-alpha_invVH * mass_conv + mass_diff)
    rho_new = torch.clamp(rho_new, 0.5 * cfg.rho_f, 2.0 * cfg.rho_f)
    visc = cfg.mu_f * kit.beta_node
    vel_new = torch.stack(
        [v_i[d] + dt / rho_i * (-alpha_invVH * mom[d][0] + visc * mom[d][1])
         for d in dims], dim=-1)

    fluid = state.node_type == FLUID
    return replace(state, rho=torch.where(fluid, rho_new, rho_i),
                   vel=torch.where(fluid[:, None], vel_new, vel_i),
                   pressure=pressure)


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

def _nbr_sel(kit: UKit, pred: torch.Tensor) -> torch.Tensor:
    """[N, K] 1 where the slot is valid and pred holds at its neighbour."""
    return _g(kit, pred.to(kit.dtype)) * kit.valid


def _nbr_avg(kit: UKit, sel, value, empty) -> torch.Tensor:
    """The average of ``value`` over the neighbours ``sel`` selects;
    ``empty`` where there is none."""
    tot = (_g(kit, value) * sel).sum(-1)
    cnt = sel.sum(-1)
    return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), empty)


def apply_inlet_bc(state: State, kit: UKit) -> State:
    cfg = kit.cfg
    inlet = kit.inlet_mask
    v_in = torch.zeros_like(state.vel)
    v_in[:, kit.axial_comp] = kit.v_pois
    vel = torch.where(inlet[:, None], v_in, state.vel)
    sel = _nbr_sel(kit, state.node_type == FLUID)
    rho = torch.where(inlet, _nbr_avg(kit, sel, state.rho, cfg.rho_f),
                      state.rho)
    C = torch.where(inlet, cfg.C_liquid_init, state.C)
    return replace(state, vel=vel, rho=rho, C=C)


def apply_outlet_bc(state: State, kit: UKit) -> State:
    cfg = kit.cfg
    outlet = kit.outlet_mask
    ax = kit.axial_comp
    rho = torch.where(outlet, cfg.rho_f, state.rho)
    sel = _nbr_sel(kit, (state.node_type == FLUID)
                   | (state.node_type == OUTLET))
    v_out = torch.zeros_like(state.vel)
    v_out[:, ax] = _nbr_avg(kit, sel, state.vel[:, ax], cfg.U_in)
    vel = torch.where(outlet[:, None], v_out, state.vel)
    C = torch.where(outlet, _nbr_avg(kit, sel, state.C, 0.0), state.C)
    return replace(state, rho=rho, vel=vel, C=C)


def apply_wall_bc(state: State, kit: UKit) -> State:
    """FNM mirror: rho copied from, vel reflected off, the wall node's
    mirror source (rho_f and 0 where it has none)."""
    cfg = kit.cfg
    wall = kit.wall_mask
    has = kit.mirror_flat >= 0
    gidx = torch.clamp(kit.mirror_flat, min=0)
    rho_w = torch.where(has, state.rho.index_select(0, gidx), cfg.rho_f)
    vel_w = torch.where(has[:, None], -state.vel.index_select(0, gidx), 0.0)
    return replace(state, rho=torch.where(wall, rho_w, state.rho),
                   vel=torch.where(wall[:, None], vel_w, state.vel))


def apply_wall_concentration_bc(state: State, kit: UKit) -> State:
    sel = _nbr_sel(kit, state.node_type == FLUID)
    C = torch.where(kit.wall_mask, _nbr_avg(kit, sel, state.C, 0.0), state.C)
    return replace(state, C=C)


def smooth_boundary_concentration(state: State, kit: UKit) -> State:
    """Interior-side fluid-neighbour average near inlet/outlet with per-node
    delta (boundary.cpp:332-376). The interior side is the sign of the
    bond's axial unit-vector component (y_j - y_i = e_ax * xi)."""
    fluid = state.node_type == FLUID
    near_in = kit.near_inlet_mask & fluid
    near_out = kit.near_outlet_mask & fluid
    e_ax = kit.nbr_e[kit.axial_comp]
    side = (near_in[:, None] & (e_ax > 0)) | (near_out[:, None] & (e_ax < 0))
    sel = side.to(kit.dtype) * _nbr_sel(kit, fluid)
    C = torch.where(near_in | near_out, _nbr_avg(kit, sel, state.C, state.C),
                    state.C)
    return replace(state, C=C)


def apply_solid_surface_bc(state: State, kit: UKit) -> State:
    solid = state.node_type == SOLID_MG
    return replace(state, vel=torch.where(solid[:, None], 0.0, state.vel))


def update_fictitious(state: State, kit: UKit) -> State:
    """IDW overwrite of C, rho, pressure and vel on the FICTITIOUS nodes
    (grid.cpp:814-842)."""
    return idw_overwrite(state, kit.fict_nodes, kit.fict_src, kit.fict_w)


# ---------------------------------------------------------------------------
# explicit ARD (ard_compute_dt and apply_phase_change are shape-agnostic:
# the uniform grid's)
# ---------------------------------------------------------------------------

def compute_salt_blocked(state: State, kit: UKit) -> torch.Tensor:
    """A SOLID node with a FLUID neighbour at C >= C_sat."""
    hit = ((_g(kit, state.node_type) == FLUID)
           & (_g(kit, state.C) >= kit.cfg.C_sat) & kit.valid).any(-1)
    return hit & (state.node_type == SOLID_MG)


def _bond_terms(state: State, kit: UKit, decay):
    """The bond classification shared by explicit and implicit transport
    (pd_ard.cpp:117-170, pd_ard_implicit.cpp:196-252): (i_fluid, i_solid,
    valid, ll, ss, D_avg [N, K])."""
    cfg = kit.cfg
    nt = state.node_type
    i_fluid = nt == FLUID
    i_solid = nt == SOLID_MG
    salt_blocked = compute_salt_blocked(state, kit)

    nt_j = _g(kit, nt)
    valid = (nt_j != WALL) & (nt_j != OUTSIDE) & kit.valid
    j_fluid = is_liquid(nt_j)
    j_solid = nt_j == SOLID_MG
    ll = i_fluid[:, None] & j_fluid
    ss = i_solid[:, None] & j_solid
    iface = (i_fluid[:, None] & j_solid) | (i_solid[:, None] & j_fluid)

    D_s = solid_diffusivity(state.is_gb, state.is_precip, cfg, decay)
    solid_D = torch.where(i_solid[:, None], D_s[:, None], _g(kit, D_s))
    solid_blocked = torch.where(i_solid[:, None], salt_blocked[:, None],
                                _g(kit, salt_blocked))
    D_iface = torch.where(solid_blocked, 0.0,
                          interface_D(solid_D, cfg.D_liquid))
    D_avg = torch.where(ll, cfg.D_liquid, torch.where(iface, D_iface, 0.0))
    return i_fluid, i_solid, valid, ll, ss, D_avg


def ard_step(state: State, kit: UKit, dt, volume_loss_fraction=0.0) -> State:
    """One explicit transport step (pd_ard.cpp:55-191)."""
    cfg = kit.cfg
    dt = torch.as_tensor(dt, dtype=kit.dtype, device=kit.device)
    decay = micro_d_factor(cfg, volume_loss_fraction, kit.dtype, kit.device)
    i_fluid, i_solid, valid, ll, ss, D_avg = _bond_terms(state, kit, decay)
    active = i_fluid | i_solid

    C_i = state.C
    C_j = _g(kit, C_i)
    vel_i = torch.where(i_fluid[:, None], state.vel, 0.0)
    vmag = vel_magnitude(state.vel)
    vmag_i = torch.where(i_fluid, vmag, 0.0)

    # artificial diffusion uses the uniform cfg.dx (pd_ard.cpp:166-169)
    D_art = torch.where(ll, cfg.alpha_art_diff * torch.maximum(
        vmag_i[:, None], _g(kit, vmag)) * cfg.dx, 0.0)

    V = kit.nbr_vol * valid
    bond_on = (~ss).to(kit.dtype)

    dC = C_j - C_i[:, None]
    diff_sum = (kit.beta_node[:, None] * (D_avg + D_art) * dC * kit.inv_xi2
                * V * bond_on).sum(-1)
    v_dot_e = _dot_e(kit, [vel_i[:, d, None] for d in range(kit.dim)])
    adv_sum = torch.where(ll, dC * v_dot_e * kit.inv_xi * V, 0.0).sum(-1)
    div_coeff = kit.alpha / kit.V_H_node

    C_new = C_i + dt * (diff_sum - div_coeff * adv_sum)
    C_new = torch.clamp(C_new, min=0.0)
    return replace(state, C=torch.where(active, C_new, C_i))


# ---------------------------------------------------------------------------
# implicit ARD (matrix-free, with fictitious constraint rows)
# ---------------------------------------------------------------------------

@dataclass
class ImplicitOperatorU:
    W: torch.Tensor        # [N, K]
    diag: torch.Tensor     # [N]
    unknown: torch.Tensor  # [N] bool: FLUID | SOLID rows (rows of M)
    fict: torch.Tensor     # [N] bool: the IDW constraint rows


def assemble(state: State, kit: UKit,
             volume_loss_fraction=0.0) -> ImplicitOperatorU:
    """M's bond weights (pd_ard_implicit.cpp:196-252): diffusion, and on
    liquid-liquid bonds upwind-stabilised advection."""
    cfg = kit.cfg
    decay = micro_d_factor(cfg, volume_loss_fraction, kit.dtype, kit.device)
    i_fluid, i_solid, valid, ll, ss, D_avg = _bond_terms(state, kit, decay)
    unknown = i_fluid | i_solid

    V = kit.nbr_vol * valid
    w_diff = kit.beta_node[:, None] * D_avg * kit.inv_xi2 * V

    vel_i = torch.where(i_fluid[:, None], state.vel, 0.0)
    v_dot_e = _dot_e(kit, [vel_i[:, d, None] for d in range(kit.dim)])
    div_coeff = (kit.alpha / kit.V_H_node)[:, None]
    w_adv = div_coeff * v_dot_e * kit.inv_xi * V
    w_stab = torch.clamp(w_adv - w_diff, min=0.0)
    w_ll = (w_diff + w_stab) - w_adv

    w = torch.where(ll, w_ll, w_diff)
    w = torch.where(unknown[:, None] & ~ss, w, 0.0)
    return ImplicitOperatorU(W=w, diag=-w.sum(-1), unknown=unknown,
                             fict=state.node_type == FICTITIOUS)


def matvec_M(op: ImplicitOperatorU, kit: UKit, x: torch.Tensor):
    y = op.diag * x + (op.W * _g(kit, x)).sum(-1)
    return torch.where(op.unknown, y, 0.0)


def _matvec_M64(op: ImplicitOperatorU, kit: UKit, x64: torch.Tensor):
    """M x in float64 over the run-dtype weights (the refinement residual)."""
    y = op.diag.to(torch.float64) * x64 + (
        op.W.to(torch.float64) * _g(kit, x64)).sum(-1)
    return torch.where(op.unknown, y, 0.0)


def linear_system(run, op: ImplicitOperatorU, kit: UKit, restart=50):
    """The AMR step's system with its IDW constraint rows
    (``amr_blocks.idw_system``) over the gather operator; GMRES on the
    basis kernels on the card in float32."""
    return idw_system(run, op, kit, lambda o, x: matvec_M(o, kit, x),
                      lambda o, x64: _matvec_M64(o, kit, x64),
                      (kit.fict_nodes, kit.fict_src, kit.fict_w), restart)


def compute_adaptive_dt(state: State, op: ImplicitOperatorU, kit: UKit):
    """``amr_blocks.adaptive_dt`` under the gather operator; a 0-d tensor."""
    return adaptive_dt(state, matvec_M(op, kit, state.C), kit.cfg)
