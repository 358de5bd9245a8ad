"""Device-side simulation kit: static masks, stencil constants, shift ops.

Port of ``pd_mg_pin_corrosion_tpu/kit.py`` (2D and 3D). Every node of the
uniform lattice shares one offset stencil, so a PD bond sum over
neighbours is a sum over S shifted views of a padded dense field
(``pad`` + ``shift``); ``neighbors`` stacks a range of those views into one
[slots, rows, *rest] tensor so the plain PyTorch ops can work on many slots
at once and then accumulate in stencil order. In 3D (S = 178) one such
stack of the whole grid would be too large, so callers walk the stencil in
``slot_chunks``.

Departures from the JAX Kit, all layout-only:

* the FNM wall mirror is one flat gather (``mirror_src``) in 2D and 3D,
  instead of roll-per-offset groups (2D) or one-hot cross-section matmuls
  (3D) — both existed because a gather was slow or crashed on the TPU; the
  values moved are the same. The sub-cell 3D mirror
  (``wall_mirror_subcell``) is up to four weighted gathers per wall node of
  a primary column (``mirror_sub_*``) in place of the weighted matmul;
* the Gauss-Seidel parity tables (``gs``) stay on the host, where the
  sequential sweeps run;
* ``cfg`` is a frozen snapshot, so editing the caller's Config cannot change
  a built Kit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .config import Config, FrozenConfig
from .fields import poiseuille_axial, resolve_device
from .grid import FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL, Grid

PI = math.pi

# Elements (slots x nodes) one stack of slot views (``neighbors``,
# ``gather``) may hold: 2^24 is 64 MB of float32, 15 slots of the
# 1,055,668-node flagship grid. Read at call time, so tests can lower it to
# force several chunks on a small grid.
SLOT_CHUNK_ELEMS = 1 << 24


@dataclass(frozen=True, eq=False)
class Kit:
    # --- device constants ---
    inlet_mask: torch.Tensor         # [*S] bool (static node types)
    outlet_mask: torch.Tensor        # [*S] bool
    wall_mask: torch.Tensor          # [*S] bool
    near_inlet_mask: torch.Tensor    # [*S] bool — within delta of the
    near_outlet_mask: torch.Tensor   #   axial domain ends (boundary.cpp:332-352)
    v_pois: torch.Tensor             # [*S] analytic Poiseuille axial velocity
    initial_solid_mask: torch.Tensor  # [*S] bool — for volume-loss diagnostics
    mirror_mask: torch.Tensor        # [*S] bool — wall nodes with a mirror source
    mirror_src: torch.Tensor         # [*S] int64 flat source index (own index where none)
    mirror_none_mask: torch.Tensor   # [*S] bool — wall nodes with no source
    slot_offsets: torch.Tensor       # [S, dim] int32 ([dk,] dj, di), for the CUDA kernels
    slot_coefs: torch.Tensor         # [3 + dim, S] run dtype (1/xi, 1/xi^2, e_x, e_y[, e_z], vol)
    slot_index: torch.Tensor         # [dim, S] int64 (offset + mext per array axis)
    slot_flat: torch.Tensor          # [S] int64 flat offset of each slot in the padded layout
    # The 3D NS step's act-static form (kernels/ns3d.py), empty in 2D. Its
    # slots run in the JAX Pallas kernel's order: grouped by (dj, di) in
    # order of first appearance, stencil order (dk) within a group.
    ns_slots: torch.Tensor           # [S] int64 slot index, in that order
    ns_offsets: torch.Tensor         # [S, 3] int32 (dk, dj, di), in that order
    ns_coefs: torch.Tensor           # [4, S] run dtype: vol/xi^2, e_x vol/xi, e_y vol/xi, e_z vol/xi
    # (B2, Bx, By, Bz): B2 = sum_s (vol/xi^2) act(.+off_s), B_d = sum_s
    # (e_d vol/xi) act(.+off_s), act = (node_type != OUTSIDE), summed in
    # stencil order in the run dtype (JAX kit._actconv3d_np). act never
    # changes over a run (dissolution turns SOLID into FLUID, both active).
    actconv3d: torch.Tensor          # [4, *S] run dtype
    # wall_mirror_subcell (3D): the wall nodes of the primary mirror columns
    # (JAX _mirror_tables_3d) and their bilinear sources in their own
    # z-plane, up to 4 in ascending flat order (unused terms weigh 0);
    # empty otherwise. The weights are the JAX kit's float32 wm_G entries
    # in the run dtype.
    mirror_sub_dst: torch.Tensor     # [n] int64 flat node index
    mirror_sub_src: torch.Tensor     # [4, n] int64 flat source index
    mirror_sub_w: torch.Tensor       # [4, n] run dtype
    # gs_parity: the sequential sweeps' host tables, None otherwise
    gs: "GsTables | None"

    # --- static metadata ---
    cfg: FrozenConfig
    dim: int
    shape: tuple
    mext: int
    offsets: tuple   # S x dim int tuples, array-axis order
    dist: tuple      # S floats
    evec: tuple      # S x dim float tuples, coordinate order (x, y)
    vol: tuple       # S floats (beta * dx^dim)
    dtype: torch.dtype
    device: torch.device
    # static axial band extents: INLET nodes live in rows [0, inlet_rows),
    # OUTLET nodes in rows [outlet_rows, end) of the leading array axis
    inlet_rows: int
    outlet_rows: int

    # ------------------------------------------------------------------
    @property
    def S(self) -> int:
        return len(self.dist)

    @property
    def axial_comp(self) -> int:
        """Velocity component index of the axial direction."""
        return self.dim - 1

    @property
    def alpha(self) -> float:
        """PD divergence constant alpha = DIM (pd_ns.cpp:8)."""
        return float(self.dim)

    @property
    def V_H(self) -> float:
        """Horizon volume (pd_ns.cpp:10-15)."""
        d = self.cfg.delta
        return PI * d * d if self.dim == 2 else (4.0 / 3.0) * PI * d**3

    @property
    def beta_lap(self) -> float:
        """PD Laplacian constant: 4/(pi*delta^2) in 2D (pd_ns.cpp:12); in
        3D the corrected 9/(2*pi*delta^3), or the reference's
        12/(pi*delta^2) under legacy_3d_constants (JAX kit.py:169-183)."""
        d = self.cfg.delta
        if self.dim == 2:
            return 4.0 / (PI * d * d)
        if self.cfg.legacy_3d_constants:
            return 12.0 / (PI * d * d)
        return 9.0 / (2.0 * PI * d**3)

    # ------------------------------------------------------------------
    def pad(self, A: torch.Tensor, fill) -> torch.Tensor:
        """Pad the spatial axes by mext with a constant fill value
        (trailing component axes, e.g. of velocity, are not padded)."""
        m = self.mext
        # F.pad lists the last axis first
        return F.pad(A, (0, 0) * (A.dim() - self.dim) + (m, m) * self.dim,
                     value=fill)

    def shift(self, Ap: torch.Tensor, s: int) -> torch.Tensor:
        """Slot-s neighbour view of a padded array (a slice, no copy)."""
        m = self.mext
        return Ap[tuple(slice(m + o, m + o + n)
                        for o, n in zip(self.offsets[s], self.shape))]

    def neighbors(self, Ap: torch.Tensor, lo: int = 0, hi: int | None = None,
                  s0: int = 0, s1: int | None = None) -> torch.Tensor:
        """Slot views s0..s1-1 of a padded scalar field, gathered into one
        [s1 - s0, rows, *shape[1:]] tensor over rows [lo, hi) of the
        leading (axial) axis: element [s - s0, r, ...] is
        shift(Ap, s)[lo + r, ...]."""
        hi = self.shape[0] if hi is None else hi
        win = Ap[lo:hi + 2 * self.mext].unfold(0, hi - lo, 1)
        for ax in range(1, self.dim):
            win = win.unfold(ax, self.shape[ax], 1)
        # win: [2m+1] * dim + [rows, *shape[1:]], a view
        return win[tuple(self.slot_index[:, s0:s1])]

    def padded_index(self, flat: torch.Tensor) -> torch.Tensor:
        """The flat indices ``flat`` of the grid, as flat indices of the
        padded layout."""
        out = torch.zeros_like(flat)
        stride = 1
        for n in reversed(self.shape):
            out = out + (flat % n + self.mext) * stride
            flat = flat // n
            stride *= n + 2 * self.mext
        return out

    def gather(self, pidx: torch.Tensor, s0: int, s1: int, *padded):
        """Slot views s0..s1-1 of padded scalar fields at the nodes ``pidx``
        (from ``padded_index``): one [s1 - s0, len(pidx)] tensor per field,
        element [s - s0, q] = shift(Ap, s) at node q."""
        idx = pidx[None, :] + self.slot_flat[s0:s1, None]
        return [Ap.reshape(-1).index_select(0, idx.reshape(-1)).view(idx.shape)
                for Ap in padded]

    def slot_chunks(self, nodes: int | None = None):
        """(s0, s1) ranges covering the stencil in order, each small enough
        that a stack of slot views over ``nodes`` nodes (default: the
        whole grid) holds at most SLOT_CHUNK_ELEMS elements."""
        nodes = max(1, math.prod(self.shape) if nodes is None else nodes)
        step = max(1, SLOT_CHUNK_ELEMS // nodes)
        return [(s0, min(s0 + step, self.S)) for s0 in range(0, self.S, step)]

    def coefs(self, s0: int = 0, s1: int | None = None, dtype=None,
              flat: bool = False):
        """(1/xi, 1/xi^2, [e_x, e_y(, e_z)], vol) of slots s0..s1-1, each
        shaped [slots, 1, ...] to broadcast over the grid, or [slots, 1]
        with ``flat`` (over ``gather``'s node lists)."""
        c = self.slot_coefs[:, s0:s1]
        c = c.view(c.shape + (1,) * (1 if flat else self.dim))
        if dtype is not None:
            c = c.to(dtype)
        return c[0], c[1], list(c[2:2 + self.dim]), c[2 + self.dim]

    def bond_iter(self):
        """Iterate (s, dist, evec, vol) over stencil slots in reference order."""
        return zip(range(self.S), self.dist, self.evec, self.vol)


def slot_sum(T: torch.Tensor) -> torch.Tensor:
    """Sum over the leading slot axis in stencil order (((T0 + T1) + T2)
    ...), the reduction order of the reference's serial bond loop. Several
    [S, ...] term tensors accumulate together as one [S, k, ...] tensor."""
    acc = T[0]
    for s in range(1, T.shape[0]):
        acc = acc + T[s]
    return acc


def build_kit(grid: Grid, cfg: Config, dtype=None, device="cuda") -> Kit:
    """The kit of ``grid`` under ``cfg``, on the card unless
    ``device="cpu"`` (no card: DeviceUnavailable)."""
    if dtype is None:
        dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    device = resolve_device(device)

    def dev(a, t=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=t)

    nt = grid.node_type
    shape = nt.shape
    v_pois = poiseuille_axial(cfg, grid.pos)

    # near-inlet / near-outlet bands for smooth_boundary_concentration
    # (boundary.cpp:337-352). Geometric, static; the dynamic FLUID check is
    # applied at use time.
    y = grid.pos[..., grid.axial_axis]
    near_inlet = (y - (-cfg.L_upstream)) < cfg.delta
    near_outlet = ((cfg.L_wire + cfg.L_downstream) - y) < cfg.delta

    midx = grid.mirror_idx.ravel().astype(np.int64)
    has = midx >= 0
    none_mask = (nt == WALL) & ~has.reshape(shape)
    mirror_src = np.where(has, midx, np.arange(midx.size))

    # axial band extents of the static INLET/OUTLET ghost layers
    rest = tuple(range(1, nt.ndim))
    inlet_any = (nt == INLET).any(axis=rest)
    outlet_any = (nt == OUTLET).any(axis=rest)
    inlet_rows = int(np.flatnonzero(inlet_any).max() + 1) if inlet_any.any() else 0
    outlet_rows = int(np.flatnonzero(outlet_any).min()) if outlet_any.any() else shape[0]

    st = grid.stencil
    # C-order strides of the padded layout
    pshape = [n + 2 * (grid.m + 1) for n in grid.shape]
    pstrides = np.cumprod([1] + pshape[:0:-1])[::-1].astype(np.int64)
    evec = np.asarray(st.evec, np.float64).T                   # [dim, S]
    if grid.dim == 2:
        # the JAX 2D bond loop is unrolled with Python-float constants:
        # 1/xi and 1/xi^2 formed in float64, rounded once to the run dtype
        inv_xi = 1.0 / np.asarray(st.dist, np.float64)
        coefs = dev(np.concatenate([[inv_xi, inv_xi * inv_xi], evec,
                                    [np.asarray(st.vol, np.float64)]]), dtype)
    else:
        # the JAX 3D bond loop scans over slots with the stencil as arrays
        # of the run dtype (Kit.stencil_jnp): 1/xi is divided in that dtype
        xi = dev(np.asarray(st.dist), dtype)
        inv_xi_t = 1.0 / xi
        coefs = torch.cat([torch.stack([inv_xi_t, inv_xi_t * inv_xi_t]),
                           dev(evec, dtype), dev(np.asarray(st.vol), dtype)[None]])

    ns_slots, ns_coefs, actconv = _ns3d_tables(grid, dtype, device)
    sub_dst, sub_src, sub_w = _subcell_mirror(cfg, grid)
    gs = (_gs_tables(nt, np.asarray(st.offsets, np.int64), near_inlet,
                     near_outlet, device) if cfg.gs_parity else None)
    return Kit(
        inlet_mask=dev(nt == INLET),
        outlet_mask=dev(nt == OUTLET),
        wall_mask=dev(nt == WALL),
        near_inlet_mask=dev(near_inlet),
        near_outlet_mask=dev(near_outlet),
        v_pois=dev(v_pois, dtype),
        initial_solid_mask=dev(nt == SOLID_MG),
        mirror_mask=dev(has.reshape(shape)),
        mirror_src=dev(mirror_src.reshape(shape)),
        mirror_none_mask=dev(none_mask),
        slot_offsets=dev(np.asarray(st.offsets, np.int32)),
        slot_coefs=coefs,
        slot_index=dev(np.asarray(st.offsets, np.int64).T + (grid.m + 1)),
        slot_flat=dev(np.asarray(st.offsets, np.int64) @ pstrides),
        ns_slots=dev(ns_slots),
        ns_offsets=dev(np.asarray(st.offsets, np.int32)[ns_slots].reshape(-1, 3)),
        ns_coefs=dev(ns_coefs, dtype),
        actconv3d=actconv,
        mirror_sub_dst=dev(sub_dst),
        mirror_sub_src=dev(sub_src),
        mirror_sub_w=dev(sub_w, dtype),
        gs=gs,
        cfg=FrozenConfig(cfg),
        dim=grid.dim,
        shape=grid.shape,
        mext=grid.m + 1,
        offsets=tuple(tuple(int(v) for v in row) for row in st.offsets),
        dist=tuple(float(v) for v in st.dist),
        evec=tuple(tuple(float(v) for v in row) for row in st.evec),
        vol=tuple(float(v) for v in st.vol),
        dtype=dtype,
        device=device,
        inlet_rows=inlet_rows,
        outlet_rows=outlet_rows,
    )


def _ns3d_tables(grid: Grid, dtype, device):
    """(ns_slots, ns_coefs, actconv3d) of the act-static 3D NS step; empty
    in 2D. Scalar coefficients are formed in float64 and rounded once to
    the run dtype, as the JAX Pallas kernel's constants and
    ``_actconv3d_np`` form them."""
    st = grid.stencil
    if grid.dim != 3:
        return (np.zeros(0, np.int64), np.zeros((4, 0)),
                torch.zeros(0, dtype=dtype, device=device))
    groups: dict = {}
    for s, off in enumerate(st.offsets):
        groups.setdefault((int(off[1]), int(off[2])), []).append(s)
    ns_slots = np.asarray([s for g in groups.values() for s in g], np.int64)
    coefs = np.zeros((4, len(ns_slots)))
    for c, s in enumerate(ns_slots):
        xi, vol = float(st.dist[s]), float(st.vol[s])
        coefs[0, c] = vol / (xi * xi)
        coefs[1:, c] = [float(e) * (vol / xi) for e in st.evec[s]]

    m = grid.m + 1
    act = torch.as_tensor(grid.node_type != OUTSIDE).to(device=device,
                                                         dtype=dtype)
    ap = F.pad(act, (m, m) * 3)
    B = torch.zeros((4,) + grid.shape, dtype=dtype, device=device)
    for s, (dk, dj, di) in enumerate(st.offsets):
        a_s = ap[tuple(slice(m + o, m + o + n)
                       for o, n in zip((dk, dj, di), grid.shape))]
        xi, vol = float(st.dist[s]), float(st.vol[s])
        # coefficient times 0 or 1: exact, so only the sums round
        B[0] += _round(vol / (xi * xi), dtype) * a_s
        for d in range(3):
            e = float(st.evec[s][d])
            if e != 0.0:
                B[1 + d] += _round(e * vol / xi, dtype) * a_s
    return ns_slots, coefs, B


def _round(x: float, dtype) -> float:
    """x rounded to the run dtype, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


# ---------------------------------------------------------------------------
# gs_parity: the reference's in-place sweeps, replayed on the host
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class GsSweep:
    """One Gauss-Seidel sweep's plan. ``band`` holds the flat indices of
    every node the sweep reads or writes (a device tensor); per swept
    node, in the sweep's order, ``nodes`` holds its position in ``band``
    and the band positions of the neighbours it may read, in slot order."""
    band: torch.Tensor     # [n] int64
    swept: torch.Tensor    # [B] int64: band positions of the swept nodes
    nodes: tuple           # ((i, (j, ...)), ...) band positions


@dataclass(frozen=True, eq=False)
class GsTables:
    """The host tables of the gs_parity sweeps (JAX kit._gs_tables, the
    same eight arrays) and the plans built from them."""
    out_idx: np.ndarray       # [B_out] int32 OUTLET nodes, ascending
    out_nbr: np.ndarray       # [B_out, S] int32 flat neighbour (clipped)
    out_valid: np.ndarray     # [B_out, S] bool: in range and not OUTSIDE
    smo_idx: np.ndarray       # [B_smo] int32 smoothing band, ascending
    smo_nbr: np.ndarray       # [B_smo, S] int32
    smo_valid: np.ndarray     # [B_smo, S] bool
    smo_near_in: np.ndarray   # [B_smo] bool
    smo_near_out: np.ndarray  # [B_smo] bool
    outlet: GsSweep           # every valid neighbour
    smooth: GsSweep           # valid neighbours on the interior side


def _gs_tables(nt: np.ndarray, offsets: np.ndarray, near_in: np.ndarray,
               near_out: np.ndarray, device) -> GsTables:
    """Host-side flat-index tables for the Gauss-Seidel parity sweeps (a
    copy of JAX ``kit._gs_tables``).

    Ascending flat order == the reference's node index order (grid.h:58-64:
    j*Nx+i in 2D, k*Nx*Ny+j*Nx+i in 3D, matching this package's C-order
    [axial-first] layout), which is the sequential order of the reference's
    in-place sweeps under one OpenMP thread.
    """
    shape = nt.shape
    shp = np.asarray(shape)
    nt_flat = nt.ravel()

    def nbr_of(flat_idx: np.ndarray):
        coords = np.stack(np.unravel_index(flat_idx, shape), -1)     # [B, nd]
        nc = coords[:, None, :] + offsets[None, :, :]                # [B, S, nd]
        inb = np.all((nc >= 0) & (nc < shp), axis=-1)
        ncc = np.clip(nc, 0, shp - 1)
        flat = np.ravel_multi_index(
            tuple(np.moveaxis(ncc, -1, 0)), shape).astype(np.int32)
        # CSR parity: OUTSIDE nodes are never neighbors (grid.cpp:196-199)
        valid = inb & (nt_flat[flat] != OUTSIDE)
        return flat, valid

    out_idx = np.flatnonzero(nt_flat == OUTLET).astype(np.int32)
    out_nbr, out_valid = nbr_of(out_idx)

    # smoothing band: static geometry; restrict to nodes that can ever be
    # FLUID (WALL/INLET/OUTLET/OUTSIDE never change type)
    smo_mask = (near_in | near_out) & ((nt == FLUID) | (nt == SOLID_MG))
    smo_idx = np.flatnonzero(smo_mask.ravel()).astype(np.int32)
    smo_nbr, smo_valid = nbr_of(smo_idx)
    smo_near_in = near_in.ravel()[smo_idx]
    smo_near_out = near_out.ravel()[smo_idx]

    # the smoothing reads the interior side only, a static test per slot:
    # the outlet band reads slots toward the inlet (negative axial offset),
    # the inlet band slots toward the outlet (boundary.cpp:355-366)
    sgn = offsets[:, 0]
    side = ((smo_near_out[:, None] & (sgn < 0)[None, :])
            | (smo_near_in[:, None] & (sgn > 0)[None, :]))
    return GsTables(
        out_idx, out_nbr, out_valid, smo_idx, smo_nbr, smo_valid,
        smo_near_in, smo_near_out,
        outlet=_gs_sweep(out_idx, out_nbr, out_valid, device),
        smooth=_gs_sweep(smo_idx, smo_nbr, smo_valid & side, device))


def _gs_sweep(idx: np.ndarray, nbr: np.ndarray, use: np.ndarray,
              device) -> GsSweep:
    band = np.unique(np.concatenate([idx, nbr[use]]).astype(np.int64))
    at = {int(q): n for n, q in enumerate(band)}
    nodes = tuple((at[int(i)], tuple(at[int(j)] for j in row[ok]))
                  for i, row, ok in zip(idx, nbr, use))
    return GsSweep(
        band=torch.as_tensor(band).to(device),
        swept=torch.as_tensor([i for i, _ in nodes],
                              dtype=torch.int64).to(device),
        nodes=nodes)


# ---------------------------------------------------------------------------
# wall_mirror_subcell: the bilinear 3D wall mirror
# ---------------------------------------------------------------------------

def _mirror_columns_3d(shape, mirror_idx: np.ndarray,
                       node_type: np.ndarray):
    """The primary columns of the 3D wall mirror (JAX
    ``kit._mirror_tables_3d``): cross-section columns (j, i) whose every
    z-plane's mirror source lies in the same plane at one cross-section
    source, and whose planes without a source are OUTSIDE (ascending flat
    cross-section indices); every other mirrored node keeps its staircase
    source."""
    Nz = shape[0]
    XS = shape[1] * shape[2]
    mi = mirror_idx.reshape(Nz, XS)
    nt = node_type.reshape(Nz, XS)
    has = mi >= 0

    src_k = np.where(has, mi // XS, -1)
    src_q = np.where(has, mi % XS, -1)
    own_k = np.broadcast_to(np.arange(Nz)[:, None], (Nz, XS))

    any_have = has.any(axis=0)
    # reference src column = the first mirror-carrying plane's source
    first_k = np.argmax(has, axis=0)
    ref_q = src_q[first_k, np.arange(XS)]
    in_plane_ok = ((src_k == own_k) | ~has).all(axis=0)
    same_q_ok = ((src_q == ref_q[None, :]) | ~has).all(axis=0)
    dead_ok = (has | (nt == OUTSIDE)).all(axis=0)
    col_invariant = any_have & in_plane_ok & same_q_ok & dead_ok

    return np.flatnonzero(col_invariant).astype(np.int32)


def _subcell_G_3d(cfg, grid: Grid, dst_cols: np.ndarray, XS: int) -> np.ndarray:
    """Weighted cross-section mirror operator for the sub-cell wall mirror
    (a copy of JAX ``kit._subcell_G_3d``): column p of G holds the BILINEAR
    weights of the reflected point 2*R_tube - r on the surrounding lattice
    nodes, instead of a one-hot at the nearest node. Weights are
    z-invariant (geometry only) and float32. Corners outside the accepted
    set (WALL/OUTSIDE) are dropped and the rest renormalized; a column with
    no accepted corner falls back to one-hot at the nearest accepted node
    in-plane."""
    Ny, Nx = grid.shape[1], grid.shape[2]
    dx = grid.dx
    ox, oy = grid.origin[0], grid.origin[1]
    # representative z-plane for accepted-type lookup: the one with the
    # most in-tube (accepted) nodes — robust against axially padded grids
    accepted_types = (FLUID, INLET, OUTLET, SOLID_MG)
    acc3 = np.isin(grid.node_type, accepted_types)
    k_rep = int(np.argmax(acc3.reshape(grid.shape[0], -1).sum(axis=1)))
    acc = acc3[k_rep].ravel()

    P = dst_cols.size
    G = np.zeros((XS, max(P, 1)), np.float32)
    for p, q in enumerate(dst_cols):
        j, i = divmod(int(q), Nx)
        x = ox + i * dx
        y = oy + j * dx
        r = math.sqrt(x * x + y * y)
        r_m = 2.0 * cfg.R_tube - r
        xm = x * r_m / r
        ym = y * r_m / r
        fi = (xm - ox) / dx
        fj = (ym - oy) / dx
        i0 = int(math.floor(fi))
        j0 = int(math.floor(fj))
        tx = fi - i0
        ty = fj - j0
        w = {(j0, i0): (1 - tx) * (1 - ty), (j0, i0 + 1): tx * (1 - ty),
             (j0 + 1, i0): (1 - tx) * ty, (j0 + 1, i0 + 1): tx * ty}
        tot = 0.0
        ent = []
        for (jj, ii), ww in w.items():
            if ww <= 0.0 or not (0 <= jj < Ny and 0 <= ii < Nx):
                continue
            col = jj * Nx + ii
            if not acc[col]:
                continue
            ent.append((col, ww))
            tot += ww
        if tot <= 0.0:
            # degenerate: keep the staircase one-hot source for this column
            # (nearest accepted node in-plane, as in _build_mirror_table)
            best, best_d = -1, np.inf
            for jj in range(max(0, j0 - 1), min(Ny, j0 + 3)):
                for ii in range(max(0, i0 - 1), min(Nx, i0 + 3)):
                    col = jj * Nx + ii
                    if not acc[col]:
                        continue
                    d = (jj - fj) ** 2 + (ii - fi) ** 2
                    if d < best_d:
                        best_d, best = d, col
            if best >= 0:
                G[best, p] = 1.0
            continue
        for col, ww in ent:
            G[col, p] = ww / tot
    return G


def _subcell_mirror(cfg, grid: Grid):
    """(dst [n], src [4, n], w [4, n]) of the sub-cell 3D wall mirror: each
    mirrored node of a primary column reads the nonzero entries of its
    column of G in its own z-plane, in ascending order (G's matmul sums
    over the cross-section in that order); empty unless
    cfg.wall_mirror_subcell in 3D."""
    empty = (np.zeros(0, np.int64), np.zeros((4, 0), np.int64),
             np.zeros((4, 0), np.float32))
    if grid.dim != 3 or not cfg.wall_mirror_subcell:
        return empty
    Nz, XS = grid.shape[0], grid.shape[1] * grid.shape[2]
    dst_cols = _mirror_columns_3d(grid.shape, grid.mirror_idx,
                                  grid.node_type)
    G = _subcell_G_3d(cfg, grid, dst_cols, XS)
    cols = np.zeros((4, dst_cols.size), np.int64)
    wts = np.zeros((4, dst_cols.size), np.float32)
    for p in range(dst_cols.size):
        nz = np.flatnonzero(G[:, p])
        cols[:len(nz), p] = nz
        wts[:len(nz), p] = G[nz, p]
    has = grid.mirror_idx.reshape(Nz, XS)[:, dst_cols] >= 0   # [Nz, P]
    k, p = np.nonzero(has)
    dst = k * XS + dst_cols[p].astype(np.int64)
    # a term of weight 0 reads the node itself
    src = np.where(wts[:, p] != 0, k * XS + cols[:, p], dst)
    return dst, src, wts[:, p]
