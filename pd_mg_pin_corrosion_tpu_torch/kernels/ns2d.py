"""ns2d — one explicit 2D PD-NS step: CUDA kernel wrapper and plain twin.

Kernel: ``csrc/ns2d.cu`` (replaces ``pallas_kernels._ns_kernel`` /
``ns_step_pallas`` of the JAX package). ``ns2d_plain`` is the same math in
plain PyTorch, the per-element arithmetic of ``ops/ns.py`` ``ns_step`` of
the JAX package with slot sums taken in stencil order; the CPU path and the
f64 path use it, and the card's checks hold the kernel against it. The
kernel stages masked planar fields of a tile in shared memory and walks the
stencil's runs along x for several nodes a thread; ``ns2d_tables`` builds
its slot table and ``ns2d_staged_plain`` is that walk in PyTorch, equal to
``ns2d_plain`` bit for bit for finite inputs.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..grid import FLUID, OUTSIDE
from ..kit import Kit, slot_sum
from .build import check, load, ptr, stream, use_plain


def _constants(kit: Kit):
    """(dens, a_inv_VH, visc, rho_lo, rho_hi) as Python floats."""
    cfg = kit.cfg
    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    return (kit.beta_lap * D_v, kit.alpha * (1.0 / kit.V_H),
            cfg.mu_f * kit.beta_lap, 0.5 * cfg.rho_f, 2.0 * cfg.rho_f)


def ns2d_plain(rho, vel, p, node_type, dt, kit: Kit):
    """(rho_new, vel_new) of one PD-NS step; every node that is not FLUID
    keeps its input value. ``p`` is Tait(rho); ``dt`` a 0-d tensor. Only
    the FLUID nodes are computed, over [S, n] gathers of their neighbour
    values (``kit.gather``)."""
    dens = _constants(kit)[0]
    ixi, ixi2, (ex, ey), vol = kit.coefs(dtype=rho.dtype, flat=True)

    flat = (node_type == FLUID).reshape(-1).nonzero().squeeze(1)
    vx, vy = vel[..., 0], vel[..., 1]
    mx, my = rho * vx, rho * vy
    act = (node_type != OUTSIDE).to(rho.dtype)
    fields = (act, mx, my, vx, vy, p, rho)
    # [S, n] neighbour values, 0 outside the grid
    A, MX, MY, VX, VY, P, R = kit.gather(
        kit.padded_index(flat), 0, kit.S, *(kit.pad(f, 0.0) for f in fields))
    mx, my, vx, vy, p, rho_c = (f.reshape(-1)[flat] for f in fields[1:])
    qxx, qxy, qyx, qyy = mx * vx, mx * vy, my * vx, my * vy

    V = vol * A
    # an exactly-zero e component contributes an exact (+-)0 to each sum
    flux = (MX - mx) * ex + (MY - my) * ey
    cx = (MX * VX - qxx) * ex + (MX * VY - qxy) * ey
    cy = (MY * VX - qyx) * ex + (MY * VY - qyy) * ey
    dp = P - p
    # per-bond terms of the 8 accumulators, written straight into one
    # [8, S, n] buffer and summed over slots together
    T = torch.empty((8,) + V.shape, dtype=rho.dtype, device=rho.device)
    for k, term in enumerate((flux * ixi, dens * (R - rho_c) * ixi2,
                              cx * ixi, cy * ixi, dp * ex * ixi,
                              dp * ey * ixi, (VX - vx) * ixi2,
                              (VY - vy) * ixi2)):
        torch.mul(term, V, out=T[k])
    rho_new, vx_new, vy_new = _update(rho_c, vx, vy,
                                      slot_sum(T.transpose(0, 1)), dt, kit)

    rho_out = rho.clone()
    rho_out.view(-1)[flat] = rho_new
    vel_out = vel.clone()
    vel_out.view(-1, 2)[flat] = torch.stack([vx_new, vy_new], dim=-1)
    return rho_out, vel_out


def _update(r, vx, vy, acc, dt, kit: Kit):
    """(rho, vx, vy) of updated nodes from their values and their eight
    accumulators, in ns2d_plain's operations."""
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    (mass_conv, mass_diff, conv_x, conv_y, pres_x, pres_y, visc_x,
     visc_y) = acc
    rho_new = torch.clamp(r + dt * (-a * mass_conv + mass_diff), rho_lo,
                          rho_hi)
    scale = dt * (1.0 / r)
    return (rho_new,
            vx + scale * ((-a * conv_x - a * pres_x) + visc * visc_x),
            vy + scale * ((-a * conv_y - a * pres_y) + visc * visc_y))


# ---------------------------------------------------------------------------
# the staged form the CUDA kernel computes
# ---------------------------------------------------------------------------

HALO = 3   # csrc/ns2d.cu kHalo: the largest |offset| a staged tile covers


@dataclass(frozen=True)
class Ns2dTables:
    """The kernel's slot table for one kit and one tile pitch."""
    # [S] int32: (dj + HALO) pitch + di + HALO
    offsets: torch.Tensor
    # [S, 8] float32: 1/xi, 1/xi^2, e_x, e_y, vol, then 0 (two float4)
    coefs: torch.Tensor
    # [nruns, 2] int32: (first slot, length)
    runs: torch.Tensor


def ns2d_tables(kit: Kit, pitch: int) -> Ns2dTables:
    """The slot table of csrc/ns2d.cu for a tile whose rows lie ``pitch``
    floats apart: per slot (in stencil order) its offset in the tile,
    counted from a node's own position less the halo, and its five
    coefficients; and the runs, the maximal stretches of slots with one dj
    and consecutive di, which the kernel walks along x."""
    offs = kit.slot_offsets.cpu().to(torch.int64)
    if kit.dim != 2 or int(offs.abs().max()) > HALO:
        raise ValueError(f"ns2d: the kernel stages a halo of {HALO} nodes; "
                         f"this kit's stencil reaches further (m_ratio > 3) "
                         f"or is not 2D")
    tile = ((offs + HALO) * torch.tensor([pitch, 1])).sum(1)
    step = offs[1:] - offs[:-1]
    new_run = torch.cat([torch.tensor([True]),
                         (step != torch.tensor([0, 1])).any(1)])
    first = new_run.nonzero().squeeze(1)
    length = torch.diff(first, append=torch.tensor([offs.shape[0]]))
    coefs = torch.zeros((kit.S, 8), dtype=torch.float32)
    coefs[:, :5] = kit.slot_coefs.to(torch.float32).T.cpu()
    dev = kit.device
    return Ns2dTables(
        tile.to(torch.int32).to(dev), coefs.to(dev),
        torch.stack([first, length], 1).to(torch.int32).to(dev))


def _masked_planes(rho, vel, p, node_type):
    """(rho, vx, vy, p, act) with +0 wherever node_type is OUTSIDE (a
    select: whatever an OUTSIDE node holds is dropped) and act 1.0
    elsewhere."""
    act = node_type != OUTSIDE
    return [torch.where(act, f, 0.0)
            for f in (rho, vel[..., 0], vel[..., 1], p)] + [act.to(rho.dtype)]


def _products(r, vx, vy):
    """(mx, my, mx vx, mx vy, my vx, my vy), as ns2d_plain forms them."""
    mx, my = r * vx, r * vy
    return mx, my, mx * vx, mx * vy, my * vx, my * vy


def _bond_terms(nb, own, c, dens):
    """The 8 terms of a bond (mass conv, mass diff, conv xy, pres xy, visc
    xy) from the neighbour's (r, vx, vy, p, act, mx, my, qxx, qxy, qyx,
    qyy) and the node's (r, vx, vy, p, mx, my, qxx, qxy, qyx, qyy), with the
    slot's coefficients c (0-d tensors); a term of a zero e component is
    None (csrc/ns2d.cu skips it)."""
    r, vx, vy, p, act, mx, my, qxx, qxy, qyx, qyy = nb
    ri, vxi, vyi, pi, mxi, myi, qxxi, qxyi, qyxi, qyyi = own
    ixi, ixi2, ex, ey, vol = c[:5]
    V = vol * act
    on_x, on_y = bool(ex != 0), bool(ey != 0)
    if on_x and on_y:
        flux = (mx - mxi) * ex + (my - myi) * ey
        tx = (qxx - qxxi) * ex + (qxy - qxyi) * ey
        ty = (qyx - qyxi) * ex + (qyy - qyyi) * ey
    elif on_x:
        flux, tx, ty = (mx - mxi) * ex, (qxx - qxxi) * ex, (qyx - qyxi) * ex
    else:
        flux, tx, ty = (my - myi) * ey, (qxy - qxyi) * ey, (qyy - qyyi) * ey
    dp = p - pi
    return (flux * ixi * V, dens * (r - ri) * ixi2 * V, tx * ixi * V,
            ty * ixi * V, dp * ex * ixi * V if on_x else None,
            dp * ey * ixi * V if on_y else None, (vx - vxi) * ixi2 * V,
            (vy - vyi) * ixi2 * V)


def ns2d_staged_plain(rho, vel, p, node_type, dt, kit: Kit, R: int = 4,
                      tile=None):
    """ns2d_plain's result by the CUDA kernel's walk, in PyTorch: tiles of
    ``tile`` = (ty, tx) nodes (default: one tile that holds the grid; tx a
    multiple of R), each staged with its halo of HALO as five masked
    planes zero-filled off the grid, the kernel's table (``ns2d_tables``),
    and a thread per row and R consecutive x of a tile that walks every
    run along x: element e of the run's row serves node q under slot first
    + e - q. Each node adds its terms in slot order from +0, so the result
    equals ns2d_plain's bit for bit for finite inputs."""
    ny, nx = kit.shape
    ty, tx = tile or (ny, -(-nx // R) * R)
    if tx % R:
        raise ValueError(f"ns2d_staged_plain: tile width {tx} is not a "
                         f"multiple of R={R}")
    gy, gx = -(-ny // ty), -(-nx // tx)
    pitch, rows = tx + 2 * HALO, ty + 2 * HALO
    tab = ns2d_tables(kit, pitch)
    # [tiles, rows * pitch] per staged field
    planes = [F.pad(f, (HALO, HALO + gx * tx - nx, HALO, HALO + gy * ty - ny))
              .unfold(0, rows, ty).unfold(1, pitch, tx).reshape(gy * gx, -1)
              for f in _masked_planes(rho, vel, p, node_type)]
    fluid = F.pad(node_type == FLUID, (0, gx * tx - nx, 0, gy * ty - ny))
    fluid = fluid.view(gy, ty, gx, tx // R, R).permute(0, 2, 1, 3, 4)
    # threads with a FLUID node among their R: (tile, row, x thread), and
    # the tile index of their first node less the halo
    b_y, b_x, row, xt = fluid.any(-1).nonzero(as_tuple=True)
    tile_of = b_y * gx + b_x
    base = row * pitch + xt * R
    centre = base + HALO * (pitch + 1)
    own = []
    for q in range(R):
        r, vx, vy, pq = (f[tile_of, centre + q] for f in planes[:4])
        own.append((r, vx, vy, pq, *_products(r, vx, vy)))
    dens = _constants(kit)[0]
    acc = torch.zeros((R, 8, base.numel()), dtype=rho.dtype,
                      device=rho.device)
    for first, length in tab.runs.tolist():
        col = base[None, :] + tab.offsets[first] + torch.arange(
            length + R - 1, device=base.device)[:, None]
        seg = [f[tile_of[None, :], col] for f in planes]
        nb = [(*(f[e] for f in seg), *_products(seg[0][e], seg[1][e],
                                                  seg[2][e]))
              for e in range(length + R - 1)]
        for t in range(length):
            c = tab.coefs[first + t]
            for q in range(R):
                for k, term in enumerate(_bond_terms(nb[t + q], own[q], c,
                                                     dens)):
                    if term is not None:
                        acc[q, k] = acc[q, k] + term
    # the threads' FLUID nodes, as flat indices of the grid
    q = torch.arange(R, device=base.device)[:, None]
    y = b_y[None, :] * ty + row[None, :]
    x = b_x[None, :] * tx + xt[None, :] * R + q
    mine = fluid[b_y[None, :], b_x[None, :], row[None, :], xt[None, :], q]
    flat = (y * nx + x)[mine]
    r, vx, vy = (torch.stack([o[d] for o in own])[mine] for d in range(3))
    r_new, vx_new, vy_new = _update(r, vx, vy, acc.permute(1, 0, 2)[:, mine],
                                    dt, kit)
    rho_out, vel_out = rho.clone(), vel.clone()
    rho_out.view(-1)[flat] = r_new
    vel_out.view(-1, 2)[flat] = torch.stack([vx_new, vy_new], -1)
    return rho_out, vel_out


@dataclass(frozen=True)
class Ns2dGeometry:
    """The compiled kernel's tile (csrc/ns2d.cu pd_ns2d_geometry)."""
    tx: int
    ty: int
    r: int
    halo: int
    pitch: int
    threads: int
    staged: int        # positions a block stages per field (tile and halo)
    tile_bytes: int    # shared memory of the five staged fields


def ns2d_geometry(lib=None) -> Ns2dGeometry:
    out = (ctypes.c_int * 8)()
    (lib or load().lib).pd_ns2d_geometry(ctypes.byref(out))
    return Ns2dGeometry(*out)


# {kit: Ns2dTables} for the loaded library's tile
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def ns2d_staging(kit: Kit, node_type, geo: Ns2dGeometry | None = None):
    """What a launch of the kernel stages on this grid: (tiles, tiles with
    a FLUID node, bytes staged from memory, halo factor). A tile with a
    FLUID node stages ``geo.staged`` positions of rho, vel[2], p and a
    node_type byte (17 bytes); the halo factor is staged positions per node
    of those tiles."""
    geo = geo or ns2d_geometry()
    tiles, busy = busy_tiles(node_type == FLUID, geo)
    return (tiles, busy, busy * geo.staged * 17,
            geo.staged / (geo.tx * geo.ty))


def busy_tiles(mask, geo: Ns2dGeometry) -> tuple[int, int]:
    """(tiles of a launch on ``geo``'s tile, tiles holding a node of the
    2D bool ``mask``)."""
    ny, nx = mask.shape
    m = F.pad(mask, (0, -nx % geo.tx, 0, -ny % geo.ty))
    gy, gx = m.shape[0] // geo.ty, m.shape[1] // geo.tx
    return gy * gx, int(m.view(gy, geo.ty, gx, geo.tx).any(3).any(1).sum())


def ns2d(rho, vel, p, node_type, dt, kit: Kit):
    """ns2d_plain's contract: the kernel on CUDA float32 tensors, the plain
    version on CPU tensors."""
    if use_plain("ns2d", rho, vel, p, node_type, dt):
        return ns2d_plain(rho, vel, p, node_type, dt, kit)
    if node_type.dtype != torch.uint8 or dt.numel() != 1:
        raise TypeError("ns2d: node_type must be uint8 and dt a scalar")
    ny, nx = kit.shape
    if rho.shape != (ny, nx) or vel.shape != (ny, nx, 2) or p.shape != (ny, nx):
        raise ValueError(f"ns2d: shapes {rho.shape}, {vel.shape}, {p.shape} "
                         f"do not match the grid {kit.shape}")
    lib = load().lib
    tab = _tables.get(kit)
    if tab is None:
        tab = _tables[kit] = ns2d_tables(kit, ns2d_geometry(lib).pitch)
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    rc = lib.pd_ns2d(
        ptr(rho), ptr(vel), ptr(p), ptr(node_type), ptr(dt), ptr(tab.offsets),
        ptr(tab.coefs), ptr(tab.runs), kit.S, tab.runs.shape[0], ny, nx,
        *_constants(kit), ptr(rho_out), ptr(vel_out), rho.device.index,
        stream(rho))
    check(rc, "ns2d")
    ns2d.launches += 1
    return rho_out, vel_out


ns2d.launches = 0
