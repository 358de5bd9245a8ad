"""Device-side simulation kit: static masks, stencil constants, shift ops.

Port of the 2D part of ``pd_mg_pin_corrosion_tpu/kit.py``. Every node of
the uniform lattice shares one offset stencil, so a PD bond sum over
neighbours is a sum over S shifted views of a padded dense field
(``pad`` + ``shift``); ``neighbors`` stacks those S views into one
[S, rows, Nx] tensor so the plain PyTorch ops can work on all slots at once
and then accumulate in stencil order.

Departures from the JAX Kit, all layout-only:

* the FNM wall mirror is one flat gather (``mirror_src``) instead of
  roll-per-offset groups — the groups existed because a gather was slow on
  the TPU; the values moved are the same;
* the Gauss-Seidel parity tables, the 3D mirror operators and the 3D
  act-convolutions are not built (this slice runs neither gs_parity nor 3D);
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
from .fields import poiseuille_axial
from .grid import INLET, OUTLET, SOLID_MG, WALL, Grid

PI = math.pi


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
    slot_offsets: torch.Tensor       # [S, 2] int32 (dj, di), for the CUDA kernels
    slot_coefs: torch.Tensor         # [5, S] run dtype (1/xi, 1/xi^2, e_x, e_y, vol)
    slot_index: torch.Tensor         # [2, S] int64 (dj + mext, di + mext)

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
        return PI * d * d

    @property
    def beta_lap(self) -> float:
        """PD Laplacian constant 4/(pi*delta^2) (pd_ns.cpp:12)."""
        d = self.cfg.delta
        return 4.0 / (PI * d * d)

    # ------------------------------------------------------------------
    def pad(self, A: torch.Tensor, fill) -> torch.Tensor:
        """Pad the two spatial axes by mext with a constant fill value
        (trailing component axes, e.g. of velocity, are not padded)."""
        m = self.mext
        if A.dim() == 2:
            return F.pad(A, (m, m, m, m), value=fill)
        # [Ny, Nx, c]: F.pad pads trailing axes first -> skip the last
        return F.pad(A, (0, 0, m, m, m, m), value=fill)

    def shift(self, Ap: torch.Tensor, s: int) -> torch.Tensor:
        """Slot-s neighbour view of a padded array (a slice, no copy)."""
        dj, di = self.offsets[s]
        m = self.mext
        return Ap[m + dj:m + dj + self.shape[0], m + di:m + di + self.shape[1]]

    def neighbors(self, Ap: torch.Tensor, lo: int = 0,
                  hi: int | None = None) -> torch.Tensor:
        """All S slot views of a padded 2D array, gathered into one
        [S, rows, Nx] tensor (rows [lo, hi) of the unpadded grid): element
        [s, j, i] is Ap[m + lo + j + dj_s, m + i + di_s] = shift(Ap, s)."""
        hi = self.shape[0] if hi is None else hi
        win = Ap[lo:hi + 2 * self.mext].unfold(0, hi - lo, 1).unfold(
            1, self.shape[1], 1)            # [2m+1, 2m+1, rows, Nx] view
        return win[self.slot_index[0], self.slot_index[1]]

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


def build_kit(grid: Grid, cfg: Config, dtype=None, device="cpu") -> Kit:
    if grid.dim != 2:
        raise NotImplementedError("the PyTorch port builds 2D kits only "
                                  "(ROADMAP: 3D flagship slice)")
    if dtype is None:
        dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    device = torch.device(device)

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
    inlet_any = (nt == INLET).any(axis=1)
    outlet_any = (nt == OUTLET).any(axis=1)
    inlet_rows = int(np.flatnonzero(inlet_any).max() + 1) if inlet_any.any() else 0
    outlet_rows = int(np.flatnonzero(outlet_any).min()) if outlet_any.any() else shape[0]

    st = grid.stencil
    inv_xi = [1.0 / float(r) for r in st.dist]
    coefs = np.asarray([inv_xi, [v * v for v in inv_xi],
                        [float(e[0]) for e in st.evec],
                        [float(e[1]) for e in st.evec],
                        [float(v) for v in st.vol]], np.float64)

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
        slot_coefs=dev(coefs, dtype),
        slot_index=dev(np.asarray(st.offsets, np.int64).T + (grid.m + 1)),
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
