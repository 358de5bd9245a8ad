"""ard2d — one explicit 2D transport step: CUDA kernel wrapper and plain
twin.

Kernel: ``csrc/ard2d.cu`` (replaces ``pallas_kernels._ard_kernel`` /
``ard_step_pallas`` of the JAX package). ``ard2d_plain`` is the port's
explicit step in plain PyTorch (``ops.ard.explicit_step``): the math of
``ops/ard.py`` ``ard_step`` of the JAX package, operation for operation,
with slot sums taken in stencil order: bi-material bonds (liquid-liquid,
interface, solid-solid skipped), the harmonic-mean interface diffusivity
zeroed by salt blocking, artificial diffusion on liquid-liquid bonds and
non-conservative advection. The per-node inputs the TPU wrapper formed in
XLA are formed by the caller (``ops/ard.ard_step``): |v|, the solid-side
micro-diffusivity Ds and the salt-blocking flags. The kernel stages C, |v|,
the solid side's interface diffusivity and a class byte of a tile in shared
memory and walks the stencil's runs along x for several nodes a thread, on
ns2d's slot table (``ns2d_tables``); ``ard2d_staged_plain`` is that walk in
PyTorch, equal to ``ard2d_plain`` bit for bit for finite inputs.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from ..grid import FICTITIOUS, FLUID, INLET, OUTLET, SOLID_MG
from ..kit import Kit
from .build import check, load, ptr, stream, use_plain
from .ns2d import HALO, Ns2dGeometry, busy_tiles, ns2d_tables


def ard2d_plain(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit):
    """C after one explicit transport step; nodes that are neither FLUID
    nor SOLID_MG keep their value. ``dt`` is a float or a 0-d tensor. The
    kernel's plain twin is the port's dimension-generic explicit step,
    ``ops.ard.explicit_step``."""
    from ..ops.ard import explicit_step
    return explicit_step(C, vel, vmag, node_type, Ds, salt, dt, kit)


def is_liquid(nt):
    """The node types a transport bond treats as liquid."""
    return (nt == FLUID) | (nt == INLET) | (nt == OUTLET) | (nt == FICTITIOUS)


def interface_D(Ds, D_L):
    """The harmonic-mean interface diffusivity of a solid side Ds."""
    return 2.0 * D_L * Ds / (D_L + Ds + 1e-30)


def explicit_update(C, diff, adv, dt, active, kit: Kit):
    """C_new = max(C + dt (diff - alpha/V_H adv), 0) on the ``active``
    nodes, C elsewhere."""
    C_new = C + dt * (diff - (kit.alpha / kit.V_H) * adv)
    C_new = torch.clamp(C_new, min=0.0)  # physical clamp (pd_ard.cpp:188-190)
    return torch.where(active, C_new, C)


# ---------------------------------------------------------------------------
# the staged form the CUDA kernel computes
# ---------------------------------------------------------------------------

def _staged_planes(C, vmag, node_type, Ds, salt, kit: Kit):
    """The kernel's staged fields: C (+0 at off positions: WALL, OUTSIDE),
    |v| (raw at liquid positions, +0 elsewhere), Dsol (the interface
    diffusivity of an unblocked SOLID position, +0 elsewhere) and the
    liquid class as 1.0 / 0.0."""
    liq, sol = is_liquid(node_type), node_type == SOLID_MG
    dsol = torch.where(sol & ~salt, interface_D(Ds, kit.cfg.D_liquid), 0.0)
    return [torch.where(liq | sol, C, 0.0), torch.where(liq, vmag, 0.0),
            dsol, liq.to(C.dtype)]


def ard2d_staged_plain(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit,
                       R: int = 4, tile=None):
    """ard2d_plain's result by the CUDA kernel's walk, in PyTorch: tiles of
    ``tile`` = (ty, tx) nodes (default: one tile that holds the grid; tx a
    multiple of R), each staged with its halo of HALO as four planes
    zero-filled off the grid (``_staged_planes``), ns2d's slot table and a
    thread per row and R consecutive x of a tile that walks every run along
    x: element e of the run's row serves node q under slot first + e - q.
    Every bond's class is a select; each node adds its terms in slot order
    from +0, so the result equals ard2d_plain's bit for bit for finite
    inputs."""
    cfg = kit.cfg
    ny, nx = kit.shape
    ty, tx = tile or (ny, -(-nx // R) * R)
    if tx % R:
        raise ValueError(f"ard2d_staged_plain: tile width {tx} is not a "
                         f"multiple of R={R}")
    dt = torch.as_tensor(dt, dtype=C.dtype, device=C.device)
    gy, gx = -(-ny // ty), -(-nx // tx)
    pitch, rows = tx + 2 * HALO, ty + 2 * HALO
    tab = ns2d_tables(kit, pitch)
    planes = [F.pad(f, (HALO, HALO + gx * tx - nx, HALO, HALO + gy * ty - ny))
              .unfold(0, rows, ty).unfold(1, pitch, tx).reshape(gy * gx, -1)
              for f in _staged_planes(C, vmag, node_type, Ds, salt, kit)]

    def per_thread(mask):
        m = F.pad(mask, (0, gx * tx - nx, 0, gy * ty - ny))
        return m.view(gy, ty, gx, tx // R, R).permute(0, 2, 1, 3, 4)
    fluid = per_thread(node_type == FLUID)
    active = per_thread((node_type == FLUID) | (node_type == SOLID_MG))
    vx, vy = (per_thread(vel[..., d]) for d in range(2))
    # threads with an active node among their R: (tile, row, x thread), and
    # the tile index of their first node less the halo
    b_y, b_x, row, xt = active.any(-1).nonzero(as_tuple=True)
    tile_of = b_y * gx + b_x
    base = row * pitch + xt * R
    centre = base + HALO * (pitch + 1)
    own = []
    for q in range(R):
        fi = fluid[b_y, b_x, row, xt, q]
        c, vm, ds = (f[tile_of, centre + q] for f in planes[:3])
        own.append((fi, c, torch.where(fi, vm, 0.0), ds,
                    *(torch.where(fi, v[b_y, b_x, row, xt, q], 0.0)
                      for v in (vx, vy))))
    zero = torch.zeros(base.numel(), dtype=C.dtype, device=C.device)
    diff, adv = [zero] * R, [zero] * R
    for first, length in tab.runs.tolist():
        col = base[None, :] + tab.offsets[first] + torch.arange(
            length + R - 1, device=base.device)[:, None]
        seg = [f[tile_of[None, :], col] for f in planes]
        for t in range(length):
            ixi, ixi2, ex, ey, vol = tab.coefs[first + t, :5]
            for q in range(R):
                fi, c, vm, ds, vxi, vyi = own[q]
                cj, vmj, dsj, lqj = (f[t + q] for f in seg)
                lq = lqj != 0
                d_ll = cfg.D_liquid + cfg.alpha_art_diff * torch.where(
                    vm > vmj, vm, vmj) * cfg.dx
                D = torch.where(lq, torch.where(fi, d_ll, ds),
                                torch.where(fi, dsj, 0.0))
                dC = cj - c
                diff[q] = diff[q] + kit.beta_lap * D * dC * ixi2 * vol
                t_adv = dC * (vxi * ex + vyi * ey) * ixi * vol
                adv[q] = adv[q] + torch.where(fi & lq, t_adv, 0.0)
    # the threads' active nodes, as flat indices of the grid
    q = torch.arange(R, device=base.device)[:, None]
    y = b_y[None, :] * ty + row[None, :]
    x = b_x[None, :] * tx + xt[None, :] * R + q
    mine = active[b_y[None, :], b_x[None, :], row[None, :], xt[None, :], q]
    flat = (y * nx + x)[mine]
    c = torch.stack([o[1] for o in own])[mine]
    out = C.clone()
    out.view(-1)[flat] = explicit_update(
        c, torch.stack(diff)[mine], torch.stack(adv)[mine], dt,
        torch.ones_like(c, dtype=torch.bool), kit)
    return out


def ard2d_geometry(lib=None) -> Ns2dGeometry:
    """The compiled kernel's tile (csrc/ard2d.cu pd_ard2d_geometry), in
    ns2d's layout; ``tile_bytes`` counts the three staged float fields and
    the class bytes."""
    out = (ctypes.c_int * 8)()
    (lib or load().lib).pd_ard2d_geometry(ctypes.byref(out))
    return Ns2dGeometry(*out)


def ard2d_staging(kit: Kit, node_type, geo: Ns2dGeometry | None = None):
    """What a launch of the kernel stages on this grid: (tiles, tiles with
    a FLUID or SOLID_MG node, bytes staged from memory, halo factor). Such a
    tile stages ``geo.staged`` positions of C, |v|, Ds, node_type and salt
    (14 bytes); the halo factor is staged positions per node of the tile."""
    geo = geo or ard2d_geometry()
    tiles, busy = busy_tiles((node_type == FLUID) | (node_type == SOLID_MG),
                             geo)
    return (tiles, busy, busy * geo.staged * 14,
            geo.staged / (geo.tx * geo.ty))


# {kit: Ns2dTables} for the loaded library's tile
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def ard2d(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit):
    """ard2d_plain's contract: the kernel on CUDA float32 tensors, the plain
    version on CPU tensors. ``dt`` is a Python float or a 0-d tensor. The
    kernel reads dt from the device, so a CUDA graph that captures the
    launch reads each replay's dt: a 0-d float32 tensor on C's device is
    passed as it is (the explicit step's graph hands its dt buffer), a
    float is filled into one on the card (no copy from the host)."""
    if use_plain("ard2d", C, vel, vmag, node_type, Ds, salt):
        return ard2d_plain(C, vel, vmag, node_type, Ds, salt, dt, kit)
    ny, nx = kit.shape
    if (kit.dim != 2 or C.shape != (ny, nx) or vel.shape != (ny, nx, 2)
            or vmag.shape != (ny, nx) or Ds.shape != (ny, nx)
            or node_type.shape != (ny, nx) or salt.shape != (ny, nx)):
        raise ValueError(f"ard2d: shapes do not match the 2D grid {kit.shape}")
    if node_type.dtype != torch.uint8 or salt.dtype != torch.bool:
        raise TypeError("ard2d: node_type must be uint8 and salt bool")
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), float(dt), dtype=torch.float32, device=C.device)
    elif (dt.shape != () or dt.dtype != torch.float32
          or dt.device != C.device):
        raise TypeError(f"ard2d: dt must be a float or a 0-d float32 tensor "
                        f"on {C.device}, got {dt.dtype} {tuple(dt.shape)} "
                        f"on {dt.device}")
    lib = load().lib
    tab = _tables.get(kit)
    if tab is None:
        tab = _tables[kit] = ns2d_tables(kit, ard2d_geometry(lib).pitch)
    cfg = kit.cfg
    C_out = torch.empty_like(C)
    rc = lib.pd_ard2d(
        ptr(C), ptr(vel), ptr(vmag), ptr(node_type), ptr(Ds), ptr(salt),
        ptr(dt), ptr(tab.offsets), ptr(tab.coefs), ptr(tab.runs), kit.S,
        tab.runs.shape[0], ny, nx, kit.beta_lap, cfg.D_liquid,
        2.0 * cfg.D_liquid, cfg.alpha_art_diff, cfg.dx, kit.alpha / kit.V_H,
        ptr(C_out), C.device.index, stream(C))
    check(rc, "ard2d")
    ard2d.launches += 1
    return C_out


ard2d.launches = 0
