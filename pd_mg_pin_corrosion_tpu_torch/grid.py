"""Structured uniform grid: node classification, PD stencil, wall mirrors.

(PyTorch port: a host-only numpy copy of ``pd_mg_pin_corrosion_tpu/grid.py``,
kept here so the port never imports JAX.)

TPU-first redesign of the reference's Grid (src/grid.cpp:29-294). The key
departure from the reference CSR neighbor list: on a uniform lattice every
node shares the *same* offset stencil (the reference computes it once at
src/grid.cpp:160-188 and then materializes per-node CSR rows). We never
materialize per-node neighbor lists at all — each PD bond sum becomes a sum
of S *shifted dense arrays*, which XLA fuses into a single stencil loop on
the VPU. Neighbor validity (domain bounds, OUTSIDE exclusion) is recovered
on the fly by shifting the node_type array with OUTSIDE fill.

Node types match reference src/grid.h:9-17.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .config import Config

PI = math.pi

# NodeType enum values (reference: src/grid.h:9-17)
FLUID = 0
SOLID_MG = 1
WALL = 2
INLET = 3
OUTLET = 4
OUTSIDE = 5
FICTITIOUS = 6

NODE_TYPE_NAMES = ["FLUID", "SOLID_MG", "WALL", "INLET", "OUTLET", "OUTSIDE", "FICTITIOUS"]


@dataclass(frozen=True)
class Stencil:
    """The shared PD offset stencil (reference: src/grid.cpp:160-188).

    ``offsets[s]`` is the integer lattice offset of slot s in array-axis
    order (i.e. (dj, di) in 2D where j indexes the axial/y axis, or
    (dk, dj, di) in 3D), generated in the same nested loop order as the
    reference so that bond summation order is deterministic and identical.
    """

    offsets: np.ndarray  # [S, dim] int, array-axis order (slowest axis first)
    dist: np.ndarray     # [S] bond length r (float64)
    evec: np.ndarray     # [S, dim] unit vector in *coordinate* order (x, y[, z])
    vol: np.ndarray      # [S] beta-corrected partial volume = beta * dx^dim

    @property
    def size(self) -> int:
        return len(self.dist)


def build_stencil(dx: float, delta: float, m: int, dim: int) -> Stencil:
    """All lattice offsets with r <= delta + dx/2, beta partial-volume weights.

    Mirrors reference src/grid.cpp:160-188 (offsets) and :274-288 (beta).
    Loop nesting (dk outer, dj, di inner) matches the reference exactly so
    per-node bond ordering — and hence floating-point summation order — is
    reproduced.
    """
    mext = m + 1
    offsets, dists, evecs, vols = [], [], [], []
    dk_range = range(-mext, mext + 1) if dim == 3 else (0,)
    for dk in dk_range:
        for dj in range(-mext, mext + 1):
            for di in range(-mext, mext + 1):
                if di == 0 and dj == 0 and dk == 0:
                    continue
                if dim == 2:
                    r = math.sqrt(float(di * di + dj * dj)) * dx
                else:
                    r = math.sqrt(float(di * di + dj * dj + dk * dk)) * dx
                if r > delta + 0.5 * dx:
                    continue
                # beta partial-volume correction at the horizon boundary
                if r <= delta - 0.5 * dx:
                    beta = 1.0
                else:
                    beta = (delta + 0.5 * dx - r) / dx
                # unit vector in coordinate order (x, y[, z]); note the
                # reference's Vec is (x, y[, z]) = (di, dj[, dk]) * dx / r
                if dim == 2:
                    ev = (di * dx / r, dj * dx / r)
                    off = (dj, di)  # array axes: (y, x)
                else:
                    ev = (di * dx / r, dj * dx / r, dk * dx / r)
                    off = (dk, dj, di)  # array axes: (z, y, x)
                offsets.append(off)
                dists.append(r)
                evecs.append(ev)
                vols.append(beta * dx**dim)
    return Stencil(
        offsets=np.asarray(offsets, dtype=np.int32),
        dist=np.asarray(dists, dtype=np.float64),
        evec=np.asarray(evecs, dtype=np.float64),
        vol=np.asarray(vols, dtype=np.float64),
    )


@dataclass(frozen=True)
class Grid:
    """Static grid data (host numpy). Device state carries node_type."""

    dim: int
    Nx: int
    Ny: int
    Nz: int
    dx: float
    delta: float
    m: int
    origin: tuple  # (origin_x, origin_y[, origin_z])
    R_wire: float
    L_wire: float
    R_tube: float

    # Arrays in array layout: 2D -> [Ny, Nx]; 3D -> [Nz, Ny, Nx]
    node_type: np.ndarray = field(repr=False)       # uint8, initial classification
    pos: np.ndarray = field(repr=False)             # [..., dim] coordinates (x, y[, z])
    stencil: Stencil = field(repr=False)
    # Wall FNM mirror: flat index of mirror source per node (-1 where N/A)
    mirror_idx: np.ndarray = field(repr=False)      # int32, same spatial shape

    @property
    def shape(self) -> tuple:
        return (self.Nz, self.Ny, self.Nx) if self.dim == 3 else (self.Ny, self.Nx)

    @property
    def N_total(self) -> int:
        return int(np.prod(self.shape))

    @property
    def axial_axis(self) -> int:
        """Index of the axial coordinate in the pos[..., dim] vector."""
        return 1 if self.dim == 2 else 2

    def type_counts(self) -> dict:
        counts = np.bincount(self.node_type.ravel(), minlength=7)
        return {NODE_TYPE_NAMES[t]: int(counts[t]) for t in range(7)}


def _classify(cfg: Config, px, py, pz):
    """Vectorized 7-way node classification (reference: src/grid.cpp:94-147)."""
    dim = cfg.dim
    m, dx = cfg.m_ratio, cfg.dx
    axial = py if dim == 2 else pz
    radial = np.abs(px) if dim == 2 else np.sqrt(px * px + py * py)

    z_phys_min = -cfg.L_upstream
    z_phys_max = cfg.L_wire + cfg.L_downstream
    wall_limit = cfg.R_tube + m * dx + 0.5 * dx

    in_tube = radial <= cfg.R_tube
    in_wall_band = (radial > cfg.R_tube) & (radial <= wall_limit)

    if dim == 2:
        wire = (np.abs(px) <= cfg.R_wire) & (py >= 0.0) & (py <= cfg.L_wire)
    else:
        wire = (px * px + py * py <= cfg.R_wire * cfg.R_wire) & (pz >= 0.0) & (pz <= cfg.L_wire)

    nt = np.full(px.shape, OUTSIDE, dtype=np.uint8)
    upstream = axial < z_phys_min
    downstream = axial > z_phys_max
    interior = ~upstream & ~downstream

    nt[upstream & in_tube] = INLET
    nt[upstream & in_wall_band] = WALL
    nt[downstream & in_tube] = OUTLET
    nt[downstream & in_wall_band] = WALL
    nt[interior & in_tube & wire] = SOLID_MG
    nt[interior & in_tube & ~wire] = FLUID
    nt[interior & in_wall_band] = WALL
    return nt


def build_grid(cfg: Config) -> Grid:
    """Build the uniform structured grid (reference: src/grid.cpp:29-155)."""
    dim, dx, m = cfg.dim, cfg.dx, cfg.m_ratio

    z_min = -cfg.L_upstream - m * dx
    z_max = cfg.L_wire + cfg.L_downstream + m * dx

    if dim == 2:
        r_min = -cfg.R_tube - m * dx
        r_max = cfg.R_tube + m * dx
        Nx = int(round((r_max - r_min) / dx)) + 1
        Ny = int(round((z_max - z_min) / dx)) + 1
        Nz = 1
        origin = (r_min, z_min)
        ii = np.arange(Nx)
        jj = np.arange(Ny)
        px = (origin[0] + ii * dx)[None, :] * np.ones((Ny, 1))
        py = (origin[1] + jj * dx)[:, None] * np.ones((1, Nx))
        pz = np.zeros_like(px)
        pos = np.stack([px, py], axis=-1)
    else:
        xy_min = -cfg.R_tube - m * dx
        xy_max = cfg.R_tube + m * dx
        Nx = int(round((xy_max - xy_min) / dx)) + 1
        Ny = Nx
        Nz = int(round((z_max - z_min) / dx)) + 1
        origin = (xy_min, xy_min, z_min)
        ii = np.arange(Nx)
        jj = np.arange(Ny)
        kk = np.arange(Nz)
        px = np.broadcast_to((origin[0] + ii * dx)[None, None, :], (Nz, Ny, Nx)).copy()
        py = np.broadcast_to((origin[1] + jj * dx)[None, :, None], (Nz, Ny, Nx)).copy()
        pz = np.broadcast_to((origin[2] + kk * dx)[:, None, None], (Nz, Ny, Nx)).copy()
        pos = np.stack([px, py, pz], axis=-1)

    node_type = _classify(cfg, px, py, pz)
    stencil = build_stencil(dx, cfg.delta, m, dim)
    mirror_idx = _build_mirror_table(cfg, node_type, pos, origin, Nx, Ny, Nz, stencil)

    return Grid(
        dim=dim, Nx=Nx, Ny=Ny, Nz=Nz, dx=dx, delta=cfg.delta, m=m,
        origin=origin, R_wire=cfg.R_wire, L_wire=cfg.L_wire, R_tube=cfg.R_tube,
        node_type=node_type, pos=pos, stencil=stencil, mirror_idx=mirror_idx,
    )


def _build_mirror_table(cfg, node_type, pos, origin, Nx, Ny, Nz, stencil) -> np.ndarray:
    """FNM wall-mirror source index per node, flat int32, -1 where unused.

    Host-precomputed equivalent of the reference's per-call mirror search
    (src/boundary.cpp:143-263). Static over the run because (a) WALL nodes
    never change type, (b) the accepted mirror-target set
    {FLUID, INLET, OUTLET, SOLID_MG} is closed under the only type
    transition that exists (SOLID_MG -> FLUID), and (c) the nearest-FLUID
    fallback only triggers for wall nodes whose neighborhoods are far from
    the dissolving wire (the wall annulus is >= R_tube - R_wire - delta away
    from any solid node for all shipped configs).
    """
    dim = cfg.dim
    dx = cfg.dx
    shape = node_type.shape
    flat_nt = node_type.ravel()
    mirror = np.full(node_type.size, -1, dtype=np.int32)

    wall_flat = np.flatnonzero(flat_nt == WALL)
    if wall_flat.size == 0:
        return mirror.reshape(shape)

    # Staleness guard for assumption (c): the table is only static if no WALL
    # node's horizon contains a dissolving (SOLID_MG) node — otherwise the
    # nearest-FLUID fallback could change as the wire dissolves and the
    # reference (which re-searches every call, boundary.cpp:253-263) would
    # diverge from this precomputed table. Checked as S shifted mask-ANDs
    # (a [W, S, nd] candidate-coordinate tensor at 1M nodes costs minutes
    # of host time and ~GBs of intermediates).
    wall_m = node_type == WALL
    solid_m = node_type == SOLID_MG
    stale = False
    if solid_m.any():
        for off in np.asarray(stencil.offsets):
            sl_w = tuple(slice(max(0, -int(o)), shape[a] - max(0, int(o)))
                         for a, o in enumerate(off))
            sl_s = tuple(slice(max(0, int(o)), shape[a] - max(0, -int(o)))
                         for a, o in enumerate(off))
            if np.any(wall_m[sl_w] & solid_m[sl_s]):
                stale = True
                break
    if stale:
        raise ValueError(
            "static wall-mirror table invalid: a WALL node's horizon "
            "intersects the initial solid set (wire too close to the tube "
            "wall: R_tube - R_wire <= delta + dx). The FNM mirror table "
            "would go stale as the wire dissolves.")

    accepted = {FLUID, INLET, OUTLET, SOLID_MG}

    if dim == 2:
        jj, ii = np.unravel_index(wall_flat, shape)
        x = pos[..., 0].ravel()[wall_flat]
        for n, j, i, xv in zip(wall_flat, jj, ii, x):
            if xv > cfg.R_tube:
                x_mirror = 2.0 * cfg.R_tube - xv
            elif xv < -cfg.R_tube:
                x_mirror = -2.0 * cfg.R_tube - xv
            else:
                x_mirror = None
            midx = -1
            if x_mirror is not None:
                i_m = int(round((x_mirror - origin[0]) / dx))
                if 0 <= i_m < Nx:
                    cand = j * Nx + i_m
                    if flat_nt[cand] in accepted:
                        midx = cand
            if midx < 0:
                midx = _nearest_fluid_neighbor(n, shape, flat_nt, stencil)
            mirror[n] = midx
    else:
        # 3D: the mirror map must be identical in every z-plane so the
        # device-side application can be a single cross-section operator
        # batched over the (sharded) z axis (see boundary._wall_mirror).
        # The geometric mirror already is (it depends only on (x, y) and
        # its in-tube target is in the accepted set at every k); the
        # fallback therefore searches the nearest accepted node IN-PLANE
        # (dz = 0) instead of the reference's nearest-FLUID 3D search
        # (boundary.cpp:253-263), which is k-dependent near the axial
        # ghost bands. Fallback nodes are the ~64 stair-case columns whose
        # rounded mirror lands back in the wall band; the deviation only
        # changes which nearby interior value pads those wall nodes.
        # Vectorized per-COLUMN computation (the map is z-invariant): the
        # geometric mirror + accepted check run once per unique (j, i) wall
        # column — evaluated at that column's first z-plane in flat order,
        # exactly like the per-node loop's col_cache did — then broadcast
        # to every wall node. The per-node Python loop was the dominant
        # grid-build cost at production sizes (~200k wall nodes).
        NxNy = Nx * Ny
        kk, jj, ii = np.unravel_index(wall_flat, shape)
        cols_flat = (jj * Nx + ii).astype(np.int64)
        # wall_flat ascending == (k, j, i) lexicographic, so return_index
        # picks the smallest-k occurrence — the loop's first encounter
        ucols, first_idx = np.unique(cols_flat, return_index=True)
        kf = kk[first_idx].astype(np.int64)
        xv = pos[..., 0].ravel()[wall_flat[first_idx]]
        yv = pos[..., 1].ravel()[wall_flat[first_idx]]

        r = np.sqrt(xv * xv + yv * yv)
        geo = (r > cfg.R_tube) & (r > 1e-30)
        r_safe = np.maximum(r, 1e-300)
        r_m = 2.0 * cfg.R_tube - r
        # np.round is round-half-even, same as the scalar round() used before
        i_m = np.round((xv * r_m / r_safe - origin[0]) / dx).astype(np.int64)
        j_m = np.round((yv * r_m / r_safe - origin[1]) / dx).astype(np.int64)
        inb = geo & (i_m >= 0) & (i_m < Nx) & (j_m >= 0) & (j_m < Ny)
        cand = kf * NxNy + j_m * Nx + i_m
        acc_arr = np.asarray(sorted(accepted), dtype=flat_nt.dtype)
        ok = np.zeros(ucols.size, bool)
        ok[inb] = np.isin(flat_nt[cand[inb]], acc_arr)
        q = np.where(ok, j_m * Nx + i_m, -1)

        # nearest accepted node in-plane within the stencil extent — only
        # the few stair-case columns whose rounded mirror lands in the wall
        mext = int(np.max(np.abs(stencil.offsets)))
        for c in np.flatnonzero(~ok):
            k, j, i = int(kf[c]), int(ucols[c]) // Nx, int(ucols[c]) % Nx
            best_d = np.inf
            qc = -1
            for dj2 in range(-mext, mext + 1):
                for di2 in range(-mext, mext + 1):
                    j2, i2 = j + dj2, i + di2
                    if not (0 <= j2 < Ny and 0 <= i2 < Nx):
                        continue
                    d2 = dj2 * dj2 + di2 * di2
                    if d2 == 0 or d2 >= best_d:
                        continue
                    if flat_nt[k * NxNy + j2 * Nx + i2] in accepted:
                        best_d = d2
                        qc = j2 * Nx + i2
            q[c] = qc

        qs = q[np.searchsorted(ucols, cols_flat)]
        mirror[wall_flat] = np.where(
            qs >= 0, kk.astype(np.int64) * NxNy + qs, -1).astype(np.int32)

    return mirror.reshape(shape)


def _nearest_fluid_neighbor(n: int, shape, flat_nt, stencil: Stencil) -> int:
    """Nearest FLUID node within the stencil (reference: src/boundary.cpp:253-263)."""
    idx = np.unravel_index(n, shape)
    best, best_d = -1, np.inf
    for s in range(stencil.size):
        coords = tuple(int(idx[a] + stencil.offsets[s, a]) for a in range(len(shape)))
        if any(c < 0 or c >= shape[a] for a, c in enumerate(coords)):
            continue
        nn = int(np.ravel_multi_index(coords, shape))
        if flat_nt[nn] == FLUID and stencil.dist[s] < best_d:
            best_d = stencil.dist[s]
            best = nn
    return best
