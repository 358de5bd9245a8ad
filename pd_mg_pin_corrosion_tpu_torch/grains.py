"""Voronoi grain structure, grain boundaries and precipitates (host numpy).

(PyTorch port: a copy of ``pd_mg_pin_corrosion_tpu/grains.py``; the same
host MT19937 stream, so grains are bit-identical to the JAX package's.)

Rewrite of GrainStructure::generate (src/grains.cpp:9-179). Same algorithm:
grain count from mean grain size, seeds drawn uniformly among solid nodes
with a seeded RNG, nearest-seed (Voronoi) assignment, immediate-neighbor GB
detection + dilation, random precipitates in grain interiors with optional
cluster growth.

RNG parity: BIT-EXACT with the g++/libstdc++ reference build. The raw
std::mt19937 stream, libstdc++'s uniform_int_distribution downscaling
rejection, and libstdc++'s std::shuffle (incl. its two-uniform-ints-per-
draw optimization) are all replicated and validated against compiled
probes, so grain_id / GB / precipitate fields match the reference exactly
for the same seed (default 42, grains.cpp:9).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .config import Config
from .grid import SOLID_MG, Grid

PI = math.pi


class _MT19937Stream:
    """Raw mt19937 32-bit stream (same output as std::mt19937) plus the
    libstdc++ uniform_int_distribution downscaling map."""

    def __init__(self, seed: int):
        # numpy's MT19937 with a raw int seed uses a different init than
        # std::mt19937; implement the std init (Knuth) directly.
        mt = np.empty(624, dtype=np.uint64)
        mt[0] = seed
        for i in range(1, 624):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._idx = 624

    def _generate(self):
        mt = self._mt.astype(np.uint64)
        upper = np.uint64(0x80000000)
        lower = np.uint64(0x7FFFFFFF)
        for i in range(624):
            y = (mt[i] & upper) | (mt[(i + 1) % 624] & lower)
            nxt = mt[(i + 397) % 624] ^ (y >> np.uint64(1))
            if y & np.uint64(1):
                nxt ^= np.uint64(0x9908B0DF)
            mt[i] = nxt
        self._mt = mt.astype(np.uint32)
        self._idx = 0

    def next_u32(self) -> int:
        if self._idx >= 624:
            self._generate()
        y = int(self._mt[self._idx])
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def uniform_int(self, b: int) -> int:
        """uniform int in [0, b], bit-exact with libstdc++ (GCC >= 11).

        For a 32-bit generator libstdc++ uses Lemire's nearly-divisionless
        downscaling (uniform_int_dist.h _S_nd: 64-bit product, low-word
        threshold rejection, high word as result) — NOT the classic
        two-division downscaling, which maps ~range/2^32 of draws to a
        neighboring value and silently de-synchronized the precipitate
        shuffle from the reference binary (round-4 diagnostic-parity
        investigation)."""
        urange = b + 1
        if urange >= 2**32:
            return self.next_u32()
        product = self.next_u32() * urange
        low = product & 0xFFFFFFFF
        if low < urange:
            threshold = (2**32 - urange) % urange
            while low < threshold:
                product = self.next_u32() * urange
                low = product & 0xFFFFFFFF
        return product >> 32

    def shuffle(self, arr: np.ndarray) -> None:
        """Bit-exact libstdc++ std::shuffle.

        For n*n <= urng range, libstdc++ draws one uniform int per PAIR of
        swaps (__gen_two_uniform_ints); otherwise it falls back to forward
        Fisher-Yates with one draw per element (bits/stl_algo.h).
        Verified against a compiled g++ probe.
        """
        n = len(arr)
        if n <= 1:
            return
        urngrange = 2**32 - 1
        if urngrange // n >= n:
            i = 1
            if n % 2 == 0:
                j = self.uniform_int(1)
                arr[i], arr[j] = arr[j], arr[i]
                i += 1
            while i < n:
                swap_range = i + 1
                x = self.uniform_int(swap_range * (swap_range + 1) - 1)
                p0, p1 = x // (swap_range + 1), x % (swap_range + 1)
                arr[i], arr[p0] = arr[p0], arr[i]
                i += 1
                if i < n:
                    arr[i], arr[p1] = arr[p1], arr[i]
                    i += 1
        else:
            for i in range(1, n):
                j = self.uniform_int(i)
                arr[i], arr[j] = arr[j], arr[i]


@dataclass
class GrainStructure:
    n_grains: int
    grain_id: np.ndarray          # [*shape] int32, -1 outside solid
    is_grain_boundary: np.ndarray  # [*shape] bool
    is_precipitate: np.ndarray     # [*shape] bool


def generate(grid: Grid, cfg: Config, seed: int = 42) -> GrainStructure:
    shape = grid.shape
    dim = grid.dim
    nt_flat = grid.node_type.ravel()
    pos_flat = grid.pos.reshape(-1, dim)

    grain_id = np.full(nt_flat.size, -1, dtype=np.int32)
    is_gb = np.zeros(nt_flat.size, dtype=bool)
    is_precip = np.zeros(nt_flat.size, dtype=bool)

    solid_nodes = np.flatnonzero(nt_flat == SOLID_MG)
    if solid_nodes.size == 0:
        return GrainStructure(0, grain_id.reshape(shape),
                              is_gb.reshape(shape), is_precip.reshape(shape))

    # grain count from mean grain size (grains.cpp:32-40)
    d = cfg.grain_size_mean
    solid_area = solid_nodes.size * cfg.dx**dim
    grain_area = PI / 4.0 * d * d if dim == 2 else PI / 6.0 * d**3
    n_grains = max(1, int(round(solid_area / grain_area)))

    rng = _MT19937Stream(seed)
    seed_pos = np.empty((n_grains, dim))
    for g in range(n_grains):
        si = solid_nodes[rng.uniform_int(solid_nodes.size - 1)]
        seed_pos[g] = pos_flat[si]

    # nearest-seed Voronoi assignment (grains.cpp:56-70); the native loop
    # when available, chunked numpy otherwise (reference is brute-force
    # O(N_solid * n_grains))
    sp = pos_flat[solid_nodes]
    chunk = 65536
    from . import native
    assigned = native.voronoi_assign(sp, seed_pos)
    if assigned is None:
        assigned = np.empty(solid_nodes.size, dtype=np.int32)
        for lo in range(0, solid_nodes.size, chunk):
            hi = min(lo + chunk, solid_nodes.size)
            d2 = ((sp[lo:hi, None, :] - seed_pos[None, :, :]) ** 2).sum(-1)
            assigned[lo:hi] = np.argmin(d2, axis=1)
    grain_id[solid_nodes] = assigned

    # GB detection over IMMEDIATE neighbors only (grains.cpp:72-88):
    # dist <= sqrt(dim)*dx*1.01
    gb_cutoff = math.sqrt(dim) * cfg.dx * 1.01
    gid = grain_id.reshape(shape)
    solid_mask = (nt_flat == SOLID_MG).reshape(shape)

    if hasattr(grid, "nbr_idx"):
        # unstructured (gather AMR) grid: the padded neighbour arrays
        near = (grid.nbr_dist <= gb_cutoff) & (grid.nbr_vol > 0)
        gid_j = np.where(near, grain_id[grid.nbr_idx], -2)
        solid_j = near & (nt_flat[grid.nbr_idx] == SOLID_MG)
        is_gb = solid_mask & (solid_j & (gid_j != grain_id[:, None])).any(-1)
        for _ in range(cfg.gb_width_cells):
            gb_j = near & is_gb[grid.nbr_idx]
            is_gb = is_gb | (solid_mask & gb_j.any(-1))
    else:
        # structured grid: stencil-shift comparison on the dense array
        st = grid.stencil
        near_slots = [s for s in range(st.size) if st.dist[s] <= gb_cutoff]

        def shift_arr(A, off, fill):
            out = np.full_like(A, fill)
            src = [slice(None)] * A.ndim
            dst = [slice(None)] * A.ndim
            for ax, o in enumerate(off):
                n = A.shape[ax]
                if o >= 0:
                    src[ax] = slice(o, n)
                    dst[ax] = slice(0, n - o)
                else:
                    src[ax] = slice(0, n + o)
                    dst[ax] = slice(-o, n)
            out[tuple(dst)] = A[tuple(src)]
            return out

        gb2 = np.zeros(shape, dtype=bool)
        for s in near_slots:
            gj = shift_arr(gid, st.offsets[s], -2)
            sj = shift_arr(solid_mask, st.offsets[s], False)
            gb2 |= solid_mask & sj & (gj != gid)
        is_gb = gb2

        # GB dilation (grains.cpp:91-107)
        for _ in range(cfg.gb_width_cells):
            grown = is_gb.copy()
            for s in near_slots:
                gbj = shift_arr(is_gb, st.offsets[s], False)
                grown |= solid_mask & gbj
            is_gb = grown

    # precipitates in grain interiors (grains.cpp:119-176)
    is_precip = np.zeros(shape, dtype=bool)
    if cfg.precip_fraction > 0.0:
        interior = solid_nodes[~is_gb.ravel()[solid_nodes]]
        if interior.size > 0:
            cells_per_cluster = 1.0
            if cfg.precip_cluster_cells > 0:
                r = float(cfg.precip_cluster_cells)
                cells_per_cluster = PI * r * r if dim == 2 else (4.0 / 3.0) * PI * r**3
            n_seeds = int(interior.size * cfg.precip_fraction / cells_per_cluster)
            n_seeds = max(1, min(n_seeds, interior.size))

            interior_shuffled = interior.copy()
            rng.shuffle(interior_shuffled)
            seeds = interior_shuffled[:n_seeds]
            flat_precip = is_precip.ravel()
            flat_precip[seeds] = True

            if cfg.precip_cluster_cells > 0:
                cluster_r = cfg.precip_cluster_cells * cfg.dx
                seed_xyz = pos_flat[seeds]
                cand = interior[~flat_precip[interior]]
                for lo in range(0, cand.size, chunk):
                    hi = min(lo + chunk, cand.size)
                    d2 = ((pos_flat[cand[lo:hi], None, :] - seed_xyz[None, :, :]) ** 2).sum(-1)
                    close = (d2 <= cluster_r**2).any(axis=1)
                    flat_precip[cand[lo:hi][close]] = True
            is_precip = flat_precip.reshape(shape)

    n_gb = int(is_gb.ravel()[solid_nodes].sum())
    print(f"Grain generation: {solid_nodes.size} solid nodes, {n_grains} grains; "
          f"GB nodes: {n_gb} ({100.0 * n_gb / solid_nodes.size:.1f}% of solid)")

    return GrainStructure(
        n_grains=n_grains,
        grain_id=grain_id.reshape(shape),
        is_grain_boundary=is_gb,
        is_precipitate=is_precip,
    )
