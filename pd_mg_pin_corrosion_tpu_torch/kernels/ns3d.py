"""ns3d — one explicit 3D PD-NS step: CUDA kernel wrapper and plain twin.

Kernel: ``csrc/ns3d.cu`` (replaces ``pallas_kernels._ns_kernel_3d`` /
``ns_step_pallas_3d`` of the JAX package). Both compute the Pallas kernel's
act-static form of the bond sums: the fields are masked by act =
(node_type != OUTSIDE), each bond adds j-side terms only, in the kernel's
slot order (``kit.ns_slots``), and the i-side terms come in once at the end
through the precomputed pure-act sums ``kit.actconv3d``:

    sum_s c_s act_j (f_j - f_i) = [sum_s c_s (act f)_j] - f_i B[c].

This is not the XLA form's arithmetic (``ops/ns.py`` of the JAX package,
which forms f_j - f_i per bond), and in float32 the two round differently
enough to matter: at config/params_3d.cfg the XLA form's flow stops 100
iterations early and C_max_fluid lands 5.9 % below the banked run, while
this form reproduces its flow solve (PERF.md). ``ns3d_plain`` evaluates
only the FLUID nodes and walks the stencil in slot chunks, so no [178, N]
stack of the whole grid is held; the CPU path and the f64 path use it, and
the card's checks hold the kernel against it. The kernel itself stages
masked planar fields in shared memory and walks the stencil's runs along z
for several nodes a thread; ``ns3d_tables`` builds its slot table and
``ns3d_staged_plain`` is that walk in PyTorch, equal to ``ns3d_plain`` bit
for bit.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import torch

from ..grid import FLUID, OUTSIDE
from ..kit import Kit
from .build import check, load, ptr, stream, use_plain


def _constants(kit: Kit):
    """(dens, a_inv_VH, visc, rho_lo, rho_hi) as Python floats, formed as
    the Pallas kernel forms them."""
    cfg = kit.cfg
    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    return (kit.beta_lap * D_v, kit.alpha / kit.V_H, cfg.mu_f * kit.beta_lap,
            0.5 * cfg.rho_f, 2.0 * cfg.rho_f)


def _masked_planes(rho, vel, p, node_type):
    """(rho, vx, vy, vz, p) with +0 wherever node_type is OUTSIDE: a
    select, so whatever an OUTSIDE node holds (an inf, a nan) is dropped."""
    act = node_type != OUTSIDE
    return [torch.where(act, f, 0.0)
            for f in (rho, vel[..., 0], vel[..., 1], vel[..., 2], p)]


def _bond_terms(R, VX, VY, VZ, P, c2, ex, ey, ez):
    """The 11 terms of a bond (mass conv, mass diff, conv xyz, pres xyz,
    visc xyz), stacked; an exactly-zero e component gives an exact (+-)0."""
    fdj = ((R * VX) * ex + (R * VY) * ey) + (R * VZ) * ez
    return torch.stack([fdj, R * c2, VX * fdj, VY * fdj, VZ * fdj,
                        P * ex, P * ey, P * ez, VX * c2, VY * c2, VZ * c2])


def _finish(acc, rows, rho, vel, p, dt, kit: Kit):
    """The i-side terms and the update of the FLUID nodes ``rows`` (flat
    indices) from their accumulators ``acc`` [11, len(rows)]."""
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    r, pi = rho.reshape(-1)[rows], p.reshape(-1)[rows]
    v = [vel[..., d].reshape(-1)[rows] for d in range(3)]
    B2, Bx, By, Bz = kit.actconv3d.to(rho.dtype).reshape(4, -1)[:, rows]
    F = (r * v[0] * Bx + r * v[1] * By) + r * v[2] * Bz
    mass_conv = acc[0] - F
    mass_diff = acc[1] - r * B2
    rho_new = torch.clamp(r + dt * (-a * mass_conv + dens * mass_diff),
                          rho_lo, rho_hi)
    scale = dt * (1.0 / r)
    vel_new = torch.stack(
        [v[d] + scale * (-a * ((acc[2 + d] - v[d] * F) + (acc[5 + d] - pi * Bd))
                         + visc * (acc[8 + d] - v[d] * B2))
         for d, Bd in enumerate((Bx, By, Bz))], dim=-1)
    rho_out, vel_out = rho.clone(), vel.clone()
    rho_out.view(-1)[rows] = rho_new
    vel_out.view(-1, 3)[rows] = vel_new
    return rho_out, vel_out


def ns3d_plain(rho, vel, p, node_type, dt, kit: Kit):
    """(rho_new, vel_new) of one 3D PD-NS step; every node that is not
    FLUID keeps its input value. ``p`` is Tait(rho); ``dt`` a 0-d tensor."""
    rows = (node_type == FLUID).reshape(-1).nonzero().squeeze(1)
    pidx = kit.padded_index(rows)
    pads = [kit.pad(f, 0.0).reshape(-1)
            for f in _masked_planes(rho, vel, p, node_type)]
    acc = torch.zeros((11, rows.numel()), dtype=rho.dtype, device=rho.device)
    coefs = kit.ns_coefs.to(rho.dtype)
    for s0, s1 in kit.slot_chunks(rows.numel()):
        idx = pidx[None, :] + kit.slot_flat[kit.ns_slots[s0:s1], None]
        T = _bond_terms(*(f[idx] for f in pads), *coefs[:, s0:s1, None])
        for s in range(s1 - s0):
            acc = acc + T[:, s]
    return _finish(acc, rows, rho, vel, p, dt, kit)


# ---------------------------------------------------------------------------
# the staged form the CUDA kernel computes
# ---------------------------------------------------------------------------

HALO = 3   # csrc/ns3d.cu kHalo: the largest |offset| a staged tile covers


@dataclass(frozen=True)
class Ns3dTables:
    """The kernel's slot table for one kit and one tile layout."""
    # [S] int32: (dk + HALO) plane + (dj + HALO) pitch + di + HALO
    offsets: torch.Tensor
    # [S, 4] float32: kit.ns_coefs, a slot's four side by side
    coefs: torch.Tensor
    # [nruns, 2] int32: (first slot, length)
    runs: torch.Tensor


def ns3d_tables(kit: Kit, pitch: int, plane: int) -> Ns3dTables:
    """The slot table of csrc/ns3d.cu for a tile whose rows lie ``pitch``
    floats apart and whose z planes ``plane`` floats: per slot (in
    kit.ns_slots order) its offset in the tile, counted from a node's own
    position less the halo, and its four coefficients; and the runs, the
    maximal stretches of slots with one (dj, di) and consecutive dk, which
    the kernel walks along z."""
    offs = kit.ns_offsets.cpu().to(torch.int64)
    if offs.numel() == 0 or int(offs.abs().max()) > HALO:
        raise ValueError(f"ns3d: the kernel stages a halo of {HALO} nodes; "
                         f"this kit's stencil reaches further (m_ratio > 3) "
                         f"or is not 3D")
    tile = ((offs + HALO) * torch.tensor([plane, pitch, 1])).sum(1)
    step = offs[1:] - offs[:-1]
    new_run = torch.cat([torch.tensor([True]),
                         (step != torch.tensor([1, 0, 0])).any(1)])
    first = new_run.nonzero().squeeze(1)
    length = torch.diff(first, append=torch.tensor([offs.shape[0]]))
    dev = kit.device
    return Ns3dTables(
        tile.to(torch.int32).to(dev),
        kit.ns_coefs.to(torch.float32).T.contiguous().to(dev),
        torch.stack([first, length], 1).to(torch.int32).to(dev))


def ns3d_staged_plain(rho, vel, p, node_type, dt, kit: Kit, R: int = 4):
    """ns3d_plain's result by the CUDA kernel's walk, in PyTorch: the five
    fields masked by a select and zero-padded by the halo (one tile that
    holds the whole grid), the kernel's table (``ns3d_tables``), and a
    thread per (y, x) column and R consecutive z that walks every run along
    z: element e of the run's column serves node q under slot first + e -
    q. Each node still adds its terms in slot order, so the result equals
    ns3d_plain's bit for bit."""
    nz, ny, nx = kit.shape
    nzr = -(-nz // R) * R                        # z planes the threads own
    pitch, plane = nx + 2 * HALO, (nx + 2 * HALO) * (ny + 2 * HALO)
    tab = ns3d_tables(kit, pitch, plane)
    tiles = [torch.nn.functional.pad(f, (HALO, HALO, HALO, HALO, HALO,
                                         HALO + nzr - nz)).reshape(-1)
             for f in _masked_planes(rho, vel, p, node_type)]
    fluid = torch.nn.functional.pad(node_type == FLUID,
                                    (0, 0, 0, 0, 0, nzr - nz))
    # threads with a FLUID node among their R: (z thread, y, x) and the tile
    # index of their first node less the halo
    tz, ty, tx = fluid.view(nzr // R, R, ny, nx).any(1).nonzero(as_tuple=True)
    own = tz * R * plane + ty * pitch + tx
    acc = torch.zeros((R, 11, own.numel()), dtype=rho.dtype, device=rho.device)
    for first, length in tab.runs.tolist():
        col = own + tab.offsets[first]
        span = torch.arange(length + R - 1, device=own.device)[:, None] * plane
        seg = [f[col[None, :] + span] for f in tiles]
        for t in range(length):
            c = tab.coefs[first + t]
            for q in range(R):
                acc[q] = acc[q] + _bond_terms(*(f[t + q] for f in seg), *c)
    # the threads' FLUID nodes, as flat indices of the grid
    q = torch.arange(R, device=own.device)[:, None]
    k = tz[None, :] * R + q
    mine = fluid[k, ty[None, :], tx[None, :]]
    rows = ((k * ny + ty) * nx + tx)[mine]
    return _finish(acc.permute(1, 0, 2)[:, mine], rows, rho, vel, p, dt, kit)


@dataclass(frozen=True)
class Ns3dGeometry:
    """The compiled kernel's tile (csrc/ns3d.cu pd_ns3d_geometry)."""
    tx: int
    ty: int
    tz: int
    r: int
    halo: int
    pitch: int
    plane: int
    threads: int
    staged: int        # elements a block stages per field (tile and halo)
    tile_bytes: int    # shared memory of the five staged fields


def ns3d_geometry(lib=None) -> Ns3dGeometry:
    out = (ctypes.c_int * 10)()
    (lib or load().lib).pd_ns3d_geometry(ctypes.byref(out))
    return Ns3dGeometry(*out)


# {kit: Ns3dTables} for the loaded library's tile
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def ns3d_staging(kit: Kit, node_type, geo: Ns3dGeometry | None = None):
    """What a launch of the kernel stages on this grid: (tiles, tiles with
    a FLUID node, bytes staged from memory, halo factor). A tile with a
    FLUID node stages ``geo.staged`` positions of 5 floats and a node_type
    byte; the halo factor is staged positions per node of those tiles."""
    geo = geo or ns3d_geometry()
    pad = [-n % t for n, t in zip(kit.shape, (geo.tz, geo.ty, geo.tx))]
    fl = torch.nn.functional.pad(node_type == FLUID,
                                 (0, pad[2], 0, pad[1], 0, pad[0]))
    gz, gy, gx = (n // t for n, t in zip(fl.shape, (geo.tz, geo.ty, geo.tx)))
    busy = int(fl.view(gz, geo.tz, gy, geo.ty, gx, geo.tx).permute(
        0, 2, 4, 1, 3, 5).reshape(gz * gy * gx, -1).any(1).sum())
    return (gz * gy * gx, busy, busy * geo.staged * 21,
            geo.staged / (geo.tx * geo.ty * geo.tz))


def ns3d(rho, vel, p, node_type, dt, kit: Kit):
    """ns3d_plain's contract: the kernel on CUDA float32 tensors, the plain
    version on CPU tensors."""
    if use_plain("ns3d", rho, vel, p, node_type, dt):
        return ns3d_plain(rho, vel, p, node_type, dt, kit)
    if node_type.dtype != torch.uint8 or dt.numel() != 1:
        raise TypeError("ns3d: node_type must be uint8 and dt a scalar")
    nz, ny, nx = kit.shape
    if (rho.shape != kit.shape or vel.shape != kit.shape + (3,)
            or p.shape != kit.shape):
        raise ValueError(f"ns3d: shapes {rho.shape}, {vel.shape}, {p.shape} "
                         f"do not match the grid {kit.shape}")
    lib = load().lib
    tab = _tables.get(kit)
    if tab is None:
        geo = ns3d_geometry(lib)
        tab = _tables[kit] = ns3d_tables(kit, geo.pitch, geo.plane)
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    rc = lib.pd_ns3d(
        ptr(rho), ptr(vel), ptr(p), ptr(node_type), ptr(dt), ptr(tab.offsets),
        ptr(tab.coefs), ptr(tab.runs), ptr(kit.actconv3d), kit.S,
        tab.runs.shape[0], nz, ny, nx, dens, a, visc, rho_lo, rho_hi,
        ptr(rho_out), ptr(vel_out), rho.device.index, stream(rho))
    check(rc, "ns3d")
    ns3d.launches += 1
    return rho_out, vel_out


ns3d.launches = 0
