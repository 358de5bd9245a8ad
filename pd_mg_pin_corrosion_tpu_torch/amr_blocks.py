"""Structured two-level AMR: each refinement level as a dense block.

Port of ``pd_mg_pin_corrosion_tpu/amr_blocks.py``. Both AMR levels are
regular lattices (fine nodes at dx in a zone around the wire, coarse nodes
at amr_ratio * dx elsewhere) and the reference bonds only same-level pairs
(grid.cpp:732-739), so a run is

  * a FINE block: the fine zone and its fictitious band, a dense lattice
    at dx;
  * a COARSE block: the whole domain at dx_coarse, the deep interior of
    the fine zone OUTSIDE and its thin inner band FICTITIOUS;
  * an IDW exchange (p = 4, grid.cpp:513-605) that overwrites the two
    fictitious bands from the other level's real nodes.

Each block is an ordinary port ``Kit`` and goes through the uniform grid's
ops, and so through the same CUDA kernels (ns2d / ns3d, ard2d, matvec2d /
matvec3d, slots3d_f64); GMRES runs the basis kernels on the flat vector.
State tensors are flat, [fine block raveled | coarse block raveled]; a
block op works on two views of them (contiguous slices, no copy) and one
``torch.cat`` per changed field joins the halves again.

The grid half is a numpy copy of the JAX module's (the port never imports
JAX). ``amr_backend = gather`` is the other AMR backend (``amr.py`` /
``unstructured.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from .config import Config, FrozenConfig
from .fields import State, resolve_device
from .grains import GrainStructure
from .grid import (FICTITIOUS, FLUID, INLET, NODE_TYPE_NAMES, OUTLET,
                   OUTSIDE, SOLID_MG, WALL, Grid, _build_mirror_table,
                   _classify, build_stencil)
from .kit import Kit, build_kit

# ---------------------------------------------------------------------------
# grid construction (host, numpy)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ABGrid:
    """Two structured blocks and their flat concatenation (host numpy).

    The flat layout is [fine.ravel() | coarse.ravel()]; inactive lattice
    sites carry node_type OUTSIDE and are inert in every op, as the uniform
    grid's out-of-tube corners are.
    """

    dim: int
    dx: float
    delta: float
    m: int
    R_wire: float
    L_wire: float
    R_tube: float

    fine_grid: Grid        # the fine block as a structured Grid
    coarse_grid: Grid      # the coarse block as a structured Grid

    # flat arrays (fine first)
    pos: np.ndarray            # [N, dim]
    node_type: np.ndarray      # [N] uint8
    dx_local: np.ndarray       # [N]
    delta_local: np.ndarray    # [N]
    grid_level: np.ndarray     # [N] int32 (0 fine, 1 coarse)

    # IDW exchange in flat indices
    fict_idx: np.ndarray       # [Nf] int32: the fictitious nodes
    fict_src: np.ndarray       # [Nf, K] int32: their real sources (0-padded)
    fict_w: np.ndarray         # [Nf, K] float64: rows sum to 1, 0 where padded

    @property
    def n_fine(self) -> int:
        return self.fine_grid.N_total

    @property
    def N_total(self) -> int:
        return len(self.node_type)

    @property
    def shape(self) -> tuple:
        return (self.N_total,)

    def type_counts(self) -> dict:
        counts = np.bincount(self.node_type, minlength=7)
        return {NODE_TYPE_NAMES[t]: int(counts[t]) for t in range(7)}


def _coarse_cfg(cfg: Config) -> Config:
    """The coarse block's config: dx = dx_coarse, and alpha_art_diff scaled
    by dx / dx_coarse so that D_art = alpha v dx keeps the fine dx, as the
    reference's uniform config dx does on every node (pd_ard.cpp:166-169)."""
    c = copy.copy(cfg)
    c.dx = cfg.dx_coarse
    c.alpha_art_diff = cfg.alpha_art_diff * (cfg.dx / cfg.dx_coarse)
    c.use_amr = 0
    return c.compute_derived()


def _fine_cfg(cfg: Config) -> Config:
    c = copy.copy(cfg)
    c.use_amr = 0
    return c.compute_derived()


def _classify_block(cfg, px, py, pz, m_local, dx_local):
    """Classification at a block's spacing (grid.cpp:302-338)."""
    c = copy.copy(cfg)
    c.dx = dx_local
    c.m_ratio = m_local
    return _classify(c, px, py, pz)


def build_amr_block_grid(cfg: Config) -> ABGrid:
    """The two blocks, the same REAL and FICTITIOUS node sets and IDW
    sources as the reference's AMR grid (grid.cpp:349-654). In 3D the fine
    zone is the cylinder sqrt(x^2 + y^2) <= R_wire + amr_buffer, z in
    [-amr_buffer, L_wire + amr_buffer] (the reference's own 3D AMR tests
    the axial extent against y, grid.cpp:341-347, and never ran)."""
    from scipy.spatial import cKDTree

    dim = cfg.dim
    dx_f, dx_c = cfg.dx, cfg.dx_coarse
    delta_f, delta_c = cfg.delta, cfg.delta_coarse
    m = cfg.m_ratio

    fine_r = cfg.R_wire + cfg.amr_buffer
    fine_z_lo = -cfg.amr_buffer
    fine_z_hi = cfg.L_wire + cfg.amr_buffer
    aux_r = fine_r + delta_f + dx_f
    aux_lo = fine_z_lo - delta_f - dx_f
    aux_hi = fine_z_hi + delta_f + dx_f
    inner_r = fine_r - delta_c - dx_c
    inner_lo = fine_z_lo + delta_c + dx_c
    inner_hi = fine_z_hi - delta_c - dx_c

    z_dom_lo = -cfg.L_upstream - m * dx_c
    z_dom_hi = cfg.L_wire + cfg.L_downstream + m * dx_c
    r_dom_lo = -cfg.R_tube - m * dx_c
    r_dom_hi = cfg.R_tube + m * dx_c

    def axis_points(dx, lo, hi):
        n = int(round((hi - lo) / dx)) + 1
        return lo + np.arange(n) * dx

    def zone(px, py, pz, r, lo, hi):
        """Cross-section radius and axial extent (grid.cpp:341-347,
        corrected in 3D)."""
        if dim == 2:
            return (np.abs(px) <= r) & (py >= lo) & (py <= hi)
        return (np.sqrt(px * px + py * py) <= r) & (pz >= lo) & (pz <= hi)

    # fine block: the part of the global fine lattice that covers the zone
    # and its fictitious band
    xs_f = axis_points(dx_f, r_dom_lo, r_dom_hi)
    zs_f = axis_points(dx_f, z_dom_lo, z_dom_hi)
    fx = xs_f[np.flatnonzero(np.abs(xs_f) <= aux_r)]
    fz = zs_f[np.flatnonzero((zs_f >= aux_lo) & (zs_f <= aux_hi))]
    if dim == 2:
        FX, FY = np.meshgrid(fx, fz)                # [Nyf, Nxf]
        FZ = np.zeros_like(FX)
        pos_fine = np.stack([FX, FY], -1)
    else:
        FZ, FY, FX = np.meshgrid(fz, fx, fx, indexing="ij")  # [Nzf, Nyf, Nxf]
        pos_fine = np.stack([FX, FY, FZ], -1)
    nt_fb = _classify_block(cfg, FX, FY, FZ, m, dx_f)
    in_zone = zone(FX, FY, FZ, fine_r, fine_z_lo, fine_z_hi)
    in_aux = zone(FX, FY, FZ, aux_r, aux_lo, aux_hi)
    # in the zone: REAL (classified); in the band (the zone dilated by
    # delta_f + dx_f, grid.cpp:529-531): FICTITIOUS; the rest inert
    nt_fine = np.where(nt_fb == OUTSIDE, OUTSIDE,
                       np.where(in_zone, nt_fb,
                                np.where(in_aux, FICTITIOUS,
                                         OUTSIDE))).astype(np.uint8)

    # coarse block: the whole domain lattice at dx_c
    xs_c = axis_points(dx_c, r_dom_lo, r_dom_hi)
    zs_c = axis_points(dx_c, z_dom_lo, z_dom_hi)
    if dim == 2:
        CX, CY = np.meshgrid(xs_c, zs_c)
        CZ = np.zeros_like(CX)
        pos_coarse = np.stack([CX, CY], -1)
    else:
        CZ, CY, CX = np.meshgrid(zs_c, xs_c, xs_c, indexing="ij")
        pos_coarse = np.stack([CX, CY, CZ], -1)
    nt_cb = _classify_block(cfg, CX, CY, CZ, m, dx_c)
    in_zone_c = zone(CX, CY, CZ, fine_r, fine_z_lo, fine_z_hi)
    in_inner = zone(CX, CY, CZ, inner_r, inner_lo, inner_hi)
    nt_coarse = np.where(
        nt_cb == OUTSIDE, OUTSIDE,
        np.where(~in_zone_c, nt_cb,                       # real coarse
                 np.where(in_inner, OUTSIDE, FICTITIOUS))  # inert / band
    ).astype(np.uint8)

    n_fine = nt_fine.size

    # IDW tables (p = 4, grid.cpp:513-605)
    pf = pos_fine.reshape(-1, dim)
    pc = pos_coarse.reshape(-1, dim)
    ntf_flat = nt_fine.ravel()
    ntc_flat = nt_coarse.ravel()
    real_fine = np.flatnonzero((ntf_flat != OUTSIDE) & (ntf_flat != FICTITIOUS))
    real_coarse = np.flatnonzero((ntc_flat != OUTSIDE)
                                 & (ntc_flat != FICTITIOUS))
    tree_f = cKDTree(pf[real_fine])
    tree_c = cKDTree(pc[real_coarse])

    rows = []  # (flat index, [flat source indices], [weights])

    def add(flat_idx, p, tree, real_map, pts, offset, radius):
        srcs = tree.query_ball_point(p, radius)
        if not srcs:
            return False
        local = real_map[srcs]
        d2 = np.maximum(((pts[local] - p) ** 2).sum(-1), 1e-30)
        w = 1.0 / (d2 * d2)
        rows.append((flat_idx, local + offset, w / w.sum()))
        return True

    dropped = 0
    # fine fictitious <- coarse REAL within delta_c
    for n in np.flatnonzero(ntf_flat == FICTITIOUS):
        if not add(n, pf[n], tree_c, real_coarse, pc, n_fine, delta_c):
            ntf_flat[n] = OUTSIDE  # a band node with no source is no node
            dropped += 1
    # coarse fictitious <- fine REAL within delta_f
    for n in np.flatnonzero(ntc_flat == FICTITIOUS):
        if not add(n_fine + n, pc[n], tree_f, real_fine, pf, 0, delta_f):
            ntc_flat[n] = OUTSIDE
            dropped += 1

    K = max((len(s) for _, s, _ in rows), default=1)
    fict_idx = np.zeros(len(rows), np.int32)
    fict_src = np.zeros((len(rows), K), np.int32)
    fict_w = np.zeros((len(rows), K))
    for r, (n, s, w) in enumerate(rows):
        fict_idx[r] = n
        fict_src[r, :len(s)] = s
        fict_w[r, :len(w)] = w

    st_f = build_stencil(dx_f, delta_f, m, dim)
    st_c = build_stencil(dx_c, delta_c, m, dim)
    if dim == 2:
        fine_dims = dict(Nx=len(fx), Ny=len(fz), Nz=1,
                         origin=(float(fx[0]), float(fz[0])))
        coarse_dims = dict(Nx=len(xs_c), Ny=len(zs_c), Nz=1,
                           origin=(float(xs_c[0]), float(zs_c[0])))
    else:
        fine_dims = dict(Nx=len(fx), Ny=len(fx), Nz=len(fz),
                         origin=(float(fx[0]), float(fx[0]), float(fz[0])))
        coarse_dims = dict(Nx=len(xs_c), Ny=len(xs_c), Nz=len(zs_c),
                           origin=(float(xs_c[0]), float(xs_c[0]),
                                   float(zs_c[0])))

    ntc_shaped = ntc_flat.reshape(nt_coarse.shape)
    if dim == 2:
        mirror_c = _build_mirror_block(cfg, ntc_shaped, pos_coarse, st_c)
    else:
        # the 3D coarse block is a whole uniform domain lattice (the fine
        # zone's inert interior is far from the tube wall), so the uniform
        # grid's z-invariant mirror builder applies as it is
        mirror_c = _build_mirror_table(
            _coarse_cfg(cfg), ntc_shaped, pos_coarse, coarse_dims["origin"],
            coarse_dims["Nx"], coarse_dims["Ny"], coarse_dims["Nz"], st_c)

    common = dict(dim=dim, m=m, R_wire=cfg.R_wire, L_wire=cfg.L_wire,
                  R_tube=cfg.R_tube)
    fine_grid = Grid(dx=dx_f, delta=delta_f, **common, **fine_dims,
                     node_type=ntf_flat.reshape(nt_fine.shape), pos=pos_fine,
                     stencil=st_f,
                     # no wall in the fine zone
                     mirror_idx=np.full(nt_fine.shape, -1, np.int32))
    coarse_grid = Grid(dx=dx_c, delta=delta_c, **common, **coarse_dims,
                       node_type=ntc_shaped, pos=pos_coarse, stencil=st_c,
                       mirror_idx=mirror_c)

    nf, nc = ntf_flat.size, ntc_flat.size
    blk = ("x".join(str(s) for s in fine_grid.shape) + " + "
           + "x".join(str(s) for s in coarse_grid.shape))
    print(f"AMR(blocks): {real_fine.size} fine, {real_coarse.size} coarse, "
          f"{len(rows)} fictitious nodes; blocks {blk}"
          + (f" ({dropped} sourceless aux dropped)" if dropped else ""))

    return ABGrid(
        dim=dim, dx=dx_f, delta=delta_f, m=m, R_wire=cfg.R_wire,
        L_wire=cfg.L_wire, R_tube=cfg.R_tube,
        fine_grid=fine_grid, coarse_grid=coarse_grid,
        pos=np.concatenate([pf, pc]),
        node_type=np.concatenate([ntf_flat, ntc_flat]),
        dx_local=np.concatenate([np.full(nf, dx_f), np.full(nc, dx_c)]),
        delta_local=np.concatenate([np.full(nf, delta_f),
                                    np.full(nc, delta_c)]),
        grid_level=np.concatenate([np.zeros(nf, np.int32),
                                   np.ones(nc, np.int32)]),
        fict_idx=fict_idx, fict_src=fict_src, fict_w=fict_w)


def _build_mirror_block(cfg, nt, pos, stencil):
    """2D wall FNM mirror with the reference's AMR semantics
    (boundary.cpp:185-203): the accepted-type node of the wall node's
    neighbourhood (on a lattice: its stencil) nearest to the reflected
    point 2 R_tube - |x|; else the FLUID neighbour nearest by bond length."""
    accepted = {FLUID, INLET, OUTLET, SOLID_MG, FICTITIOUS}
    Ny, Nx = nt.shape
    flat_nt = nt.ravel()
    mirror = np.full(nt.size, -1, np.int32)
    offs = np.asarray(stencil.offsets)

    def neighbours(j, i):
        for s in range(len(offs)):
            j2, i2 = j + offs[s, 0], i + offs[s, 1]
            if 0 <= j2 < Ny and 0 <= i2 < Nx:
                yield s, j2, i2

    for n in np.flatnonzero(flat_nt == WALL):
        j, i = divmod(n, Nx)
        x, y = pos[j, i, 0], pos[j, i, 1]
        if x > cfg.R_tube:
            xm = 2.0 * cfg.R_tube - x
        elif x < -cfg.R_tube:
            xm = -2.0 * cfg.R_tube - x
        else:
            xm = None
        best, best_d2 = -1, np.inf
        if xm is not None:
            for _, j2, i2 in neighbours(j, i):
                if flat_nt[j2 * Nx + i2] not in accepted:
                    continue
                d2 = (pos[j2, i2, 0] - xm) ** 2 + (pos[j2, i2, 1] - y) ** 2
                if d2 < best_d2:
                    best_d2, best = d2, j2 * Nx + i2
        if best < 0:
            bd = np.inf
            for s, j2, i2 in neighbours(j, i):
                if flat_nt[j2 * Nx + i2] == FLUID and stencil.dist[s] < bd:
                    bd, best = stencil.dist[s], j2 * Nx + i2
        mirror[n] = best
    return mirror.reshape(nt.shape)


def generate_grains_b(grid: ABGrid, cfg: Config,
                      seed: int = 42) -> GrainStructure:
    """The grain structure of the fine block (all solid lives there) in the
    flat layout: the coarse half carries no grain."""
    from . import grains as grains_mod

    g = grains_mod.generate(grid.fine_grid, cfg, seed=seed)
    nc = grid.N_total - grid.n_fine
    return GrainStructure(
        g.n_grains,
        np.concatenate([g.grain_id.ravel(), np.full(nc, -1, np.int32)]),
        np.concatenate([g.is_grain_boundary.ravel(), np.zeros(nc, bool)]),
        np.concatenate([g.is_precipitate.ravel(), np.zeros(nc, bool)]))


# ---------------------------------------------------------------------------
# kit
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class BKit:
    """Block-AMR kit: a port Kit per block and the IDW exchange tables."""

    fine: Kit
    coarse: Kit
    fict_idx: torch.Tensor            # [Nf] int64 (flat layout)
    fict_src: torch.Tensor            # [Nf, K] int64
    fict_w: torch.Tensor              # [Nf, K] run dtype
    initial_solid_mask: torch.Tensor  # [N] bool

    cfg: FrozenConfig
    n_fine: int
    dtype: torch.dtype
    device: torch.device

    @property
    def dim(self) -> int:
        return self.fine.dim


def build_bkit(grid: ABGrid, cfg: Config, dtype=None,
               device="cuda") -> BKit:
    """The block kit of ``grid``: two Kits (each with its own block cfg) on
    the card unless ``device="cpu"`` (no card: DeviceUnavailable)."""
    if dtype is None:
        dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    device = resolve_device(device)

    def dev(a, t=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=t)

    return BKit(
        fine=build_kit(grid.fine_grid, _fine_cfg(cfg), dtype, device),
        coarse=build_kit(grid.coarse_grid, _coarse_cfg(cfg), dtype, device),
        fict_idx=dev(grid.fict_idx, torch.int64),
        fict_src=dev(grid.fict_src, torch.int64),
        fict_w=dev(grid.fict_w, dtype),
        initial_solid_mask=dev(grid.node_type == SOLID_MG),
        cfg=FrozenConfig(cfg), n_fine=grid.n_fine, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# split / join
# ---------------------------------------------------------------------------


def _split(kit: BKit, a: torch.Tensor):
    """Flat [N, ...] -> (fine [*fshape, ...], coarse [*cshape, ...]): two
    views of a contiguous tensor, which the kernels read in place."""
    a = a.contiguous()
    nf, extra = kit.n_fine, a.shape[1:]
    return (a[:nf].view(kit.fine.shape + extra),
            a[nf:].view(kit.coarse.shape + extra))


def _join(kit: BKit, f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    extra = f.shape[kit.dim:]
    return torch.cat([f.reshape((kit.n_fine,) + extra),
                      c.reshape((-1,) + extra)])


def _split_state(kit: BKit, state: State):
    """(fine block State, coarse block State) of views of the flat state."""
    halves = {f.name: _split(kit, getattr(state, f.name))
              for f in fields(State)}
    return (State(**{k: v[0] for k, v in halves.items()}),
            State(**{k: v[1] for k, v in halves.items()}))


def _per_block(fn_f, fn_c):
    """Lift per-block (state, kit, *args) -> state functions (None: leave
    the block as it is) to the flat layout. A field that neither function
    replaced keeps its flat tensor; the others are joined."""

    def wrapped(state: State, kit: BKit, *args) -> State:
        sf, sc = _split_state(kit, state)
        nf = sf if fn_f is None else fn_f(sf, kit.fine, *args)
        nc = sc if fn_c is None else fn_c(sc, kit.coarse, *args)
        out = {}
        for f in fields(State):
            a, b = getattr(nf, f.name), getattr(nc, f.name)
            out[f.name] = (getattr(state, f.name)
                           if a is getattr(sf, f.name) and b is getattr(sc, f.name)
                           else _join(kit, a, b))
        return State(**out)

    return wrapped


# ---------------------------------------------------------------------------
# physics ops (the block branch of dispatch.ops_for)
# ---------------------------------------------------------------------------


def tait_pressure(rho, kit: BKit):
    from .ops.ns import tait_pressure as tp
    return tp(rho, kit.fine)  # the EOS constants are the same in both blocks


def compute_dt_ns(state: State, kit: BKit):
    """The global CFL dt: the reference's formula (pd_ns.cpp:52-76) takes
    the uniform config dx, the FINE spacing, and the global FLUID v_max."""
    from .ops.ns import compute_dt
    return compute_dt(state, kit.fine)


def ns_step(state: State, kit: BKit, dt) -> State:
    from .ops.ns import ns_step as step
    return _per_block(step, step)(state, kit, dt)


def apply_inlet_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_inlet_bc)(state, kit)


def apply_outlet_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_outlet_bc)(state, kit)


def apply_wall_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_wall_bc)(state, kit)


def apply_wall_concentration_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_wall_concentration_bc)(state, kit)


def smooth_boundary_concentration(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.smooth_boundary_concentration)(state, kit)


def idw_overwrite(state: State, idx, src, w) -> State:
    """C, rho, pressure and vel on the nodes ``idx`` [Nf] overwritten by
    the IDW sum of their sources ``src`` [Nf, K] with weights ``w``: a
    gather of the K sources, their weighted sum, and a scatter."""
    flat = src.reshape(-1)

    def interp(a):
        g = a.index_select(0, flat).view(src.shape + a.shape[1:])
        wa = w.view(w.shape + (1,) * (a.dim() - 1))
        return a.index_copy(0, idx, (g * wa).sum(1).to(a.dtype))

    return replace(state, C=interp(state.C), rho=interp(state.rho),
                   pressure=interp(state.pressure), vel=interp(state.vel))


def update_fictitious(state: State, kit: BKit) -> State:
    """IDW overwrite of C, rho, pressure and vel on the FICTITIOUS nodes
    (grid.cpp:814-842), the only coupling of the two blocks."""
    return idw_overwrite(state, kit.fict_idx, kit.fict_src, kit.fict_w)


def ard_compute_dt(state: State, kit: BKit):
    from .ops.ard import compute_dt
    return compute_dt(state, kit.fine)  # the fine dx governs, as above


def ard_step(state: State, kit: BKit, dt, volume_loss_fraction=0.0) -> State:
    from .ops.ard import ard_step as step
    return _per_block(step, step)(state, kit, dt, volume_loss_fraction)


def apply_phase_change(state: State, kit: BKit):
    from .ops.ard import apply_phase_change as pc
    return pc(state, kit.fine)  # an elementwise remask of the flat state


# ---------------------------------------------------------------------------
# implicit transport
# ---------------------------------------------------------------------------


@dataclass
class ImplicitOperatorB:
    opf: object            # ops.ard_implicit.ImplicitOperator of the fine block
    opc: object            # ... of the coarse block
    unknown: torch.Tensor  # [N] bool: FLUID | SOLID rows
    fict: torch.Tensor     # [N] bool: the IDW constraint rows
    diag: torch.Tensor     # [N] the diagonal of M


def _block_operator(state: State, kit: Kit, volume_loss_fraction):
    """A block's operator: the uniform grid's weights; on the card a 3D
    float32 operator streams them packed and drops the dense W. No bfloat16
    copy: the block step preconditions with the operator itself."""
    from .kernels import pack_stencil
    from .ops.ard_implicit import ImplicitOperator, _dense_operator

    W, diag, unknown = _dense_operator(state, kit, volume_loss_fraction)
    packed = None
    if kit.dim == 3 and kit.dtype == torch.float32 and W.is_cuda:
        packed, W = pack_stencil(W, unknown, kit), None
    return ImplicitOperator(W=W, diag=diag, unknown=unknown, packed=packed)


def assemble(state: State, kit: BKit,
             volume_loss_fraction=0.0) -> ImplicitOperatorB:
    sf, sc = _split_state(kit, state)
    opf = _block_operator(sf, kit.fine, volume_loss_fraction)
    opc = _block_operator(sc, kit.coarse, volume_loss_fraction)
    return ImplicitOperatorB(
        opf=opf, opc=opc, unknown=_join(kit, opf.unknown, opc.unknown),
        fict=state.node_type == FICTITIOUS,
        diag=_join(kit, opf.diag, opc.diag))


def matvec_M(op: ImplicitOperatorB, kit: BKit, x: torch.Tensor):
    """M x per block (matvec2d / matvec3d on the card in float32)."""
    from .ops.ard_implicit import matvec_M as mv
    xf, xc = _split(kit, x)
    return _join(kit, mv(op.opf, kit.fine, xf), mv(op.opc, kit.coarse, xc))


def _matvec_M64(op: ImplicitOperatorB, kit: BKit, x64: torch.Tensor):
    """M x in float64 over the float32 weights, per block (the refinement
    residual)."""
    from .ops.ard_implicit import matvec_M64
    xf, xc = _split(kit, x64)
    return _join(kit, matvec_M64(op.opf, kit.fine, xf),
                 matvec_M64(op.opc, kit.coarse, xc))


def linear_system(run, op: ImplicitOperatorB, kit: BKit, restart=50):
    """``idw_system`` over the blocks' operator (matvec2d / matvec3d on the
    card in float32)."""
    return idw_system(run, op, kit, lambda o, x: matvec_M(o, kit, x),
                      lambda o, x64: _matvec_M64(o, kit, x64),
                      (kit.fict_idx, kit.fict_src, kit.fict_w), restart)


def idw_system(run, op, kit, M, M64, fict, restart: int = 50):
    """The implicit step's system of both AMR backends over the runner
    ``run``'s buffers (``op`` loaded into them, ``run.dt``,
    ``run.inv_diag``): (I - dt M) x = b with identity BC rows and the IDW
    constraint rows x_f - sum_k w_k x_src = 0 (pd_ard_implicit.cpp:371-429,
    500-535); b is C on every row but the constraint rows, where it is 0,
    and the step writes the unknown and the constraint rows. ``M(op, x)``
    is M x in the run dtype and ``M64(op, x64)`` in float64 over the same
    weights, both 0 off the ``op.unknown`` rows; ``fict`` = (idx [Nf], src
    [Nf, K], w [Nf, K]) the constraint rows. Jacobi plus two Neumann
    sweeps through the whole operator precondition it. float32 runs take
    GMRES(25) and the float64 refinement residual (the f32 weights and
    fict_w widened)."""
    from .ops.gmres import System

    f32 = kit.dtype == torch.float32
    if f32:
        restart = min(restart, 25)
    idx, src2, fict_w = fict
    src = src2.reshape(-1)

    def constrain(y, x, w):
        """y with the constraint rows x_f - sum_k w_k x_src."""
        row = x.index_select(0, idx) - (
            x.index_select(0, src).view(w.shape) * w).sum(1)
        return y.index_copy(0, idx, row.to(y.dtype))

    def A(x):
        return constrain(torch.where(op.unknown, x - run.dt * M(op, x), x),
                         x, fict_w)

    def jacobi(x):
        return torch.where(op.unknown, x * run.inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(2):
            y = y + jacobi(x - A(y))
        return y

    def A64(x64):
        y = torch.where(op.unknown, x64 - run.dt.to(torch.float64)
                        * M64(op, x64), x64)
        return constrain(y, x64, fict_w.to(torch.float64))

    return System(A=A, M=precond, A64=A64 if f32 else None,
                  rhs=lambda C: torch.where(op.fict, 0.0, C),
                  solved=lambda: op.unknown | op.fict, unknown=op.unknown,
                  diag=op.diag, restart=restart, flat_kernels=f32)


def compute_adaptive_dt(state: State, op: ImplicitOperatorB, kit: BKit):
    """Adaptive dt over both blocks (``adaptive_dt``); a 0-d tensor."""
    return adaptive_dt(state, matvec_M(op, kit, state.C), kit.cfg)


def adaptive_dt(state: State, MC: torch.Tensor, cfg):
    """The AMR backends' adaptive dt from the SOLID nodes' time to
    threshold under M C = ``MC`` (pd_ard_implicit.cpp:438-489), floored at
    implicit_dt_min_frac of implicit_dt_max; a 0-d tensor."""
    solid = state.node_type == SOLID_MG
    eligible = solid & (state.C > cfg.C_thresh) & (MC < 0.0)
    rate = -MC
    t_phase = (state.C - cfg.C_thresh) / torch.clamp(rate, min=1e-30)
    t_phase = torch.where(eligible & (t_phase > 0.0), t_phase,
                          cfg.implicit_dt_max)
    min_t = torch.clamp(t_phase.min(), max=cfg.implicit_dt_max)
    dt = torch.clamp(cfg.implicit_dt_fraction * min_t, max=cfg.implicit_dt_max)
    return torch.clamp(dt, min=cfg.implicit_dt_max * cfg.implicit_dt_min_frac)
