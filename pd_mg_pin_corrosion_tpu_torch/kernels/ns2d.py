"""ns2d — one explicit 2D PD-NS step: CUDA kernel wrapper and plain twin.

Kernel: ``csrc/ns2d.cu`` (replaces ``pallas_kernels._ns_kernel`` /
``ns_step_pallas`` of the JAX package). ``ns2d_plain`` is the same math in
plain PyTorch, the per-element arithmetic of ``ops/ns.py`` ``ns_step`` of
the JAX package with slot sums taken in stencil order; the CPU path and the
f64 path use it, and the card's checks hold the kernel against it.
"""

from __future__ import annotations

import torch

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
    keeps its input value. ``p`` is Tait(rho); ``dt`` a 0-d tensor."""
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    ixi, ixi2, ex, ey, vol = kit.slot_coefs.to(rho.dtype)[:, :, None, None]

    vx, vy = vel[..., 0], vel[..., 1]
    mx, my = rho * vx, rho * vy
    qxx, qxy, qyx, qyy = mx * vx, mx * vy, my * vx, my * vy

    def nb(A):  # [S, Ny, Nx] neighbour values, 0 outside the grid
        return kit.neighbors(kit.pad(A, 0.0))

    act = (node_type != OUTSIDE).to(rho.dtype)
    V = vol * nb(act)
    MX, MY, VX, VY = nb(mx), nb(my), nb(vx), nb(vy)
    # an exactly-zero e component contributes an exact (+-)0 to each sum
    flux = (MX - mx) * ex + (MY - my) * ey
    cx = (MX * VX - qxx) * ex + (MX * VY - qxy) * ey
    cy = (MY * VX - qyx) * ex + (MY * VY - qyy) * ey
    dp = nb(p) - p
    # per-bond terms of the 8 accumulators, written straight into one
    # [8, S, Ny, Nx] buffer and summed over slots together
    T = torch.empty((8,) + V.shape, dtype=rho.dtype, device=rho.device)
    for k, term in enumerate((flux * ixi, dens * (nb(rho) - rho) * ixi2,
                              cx * ixi, cy * ixi, dp * ex * ixi,
                              dp * ey * ixi, (VX - vx) * ixi2,
                              (VY - vy) * ixi2)):
        torch.mul(term, V, out=T[k])
    (mass_conv, mass_diff, conv_x, conv_y, pres_x, pres_y, visc_x,
     visc_y) = slot_sum(T.transpose(0, 1))

    rho_new = rho + dt * (-a * mass_conv + mass_diff)
    rho_new = torch.clamp(rho_new, rho_lo, rho_hi)
    scale = dt * (1.0 / rho)
    vx_new = vx + scale * ((-a * conv_x - a * pres_x) + visc * visc_x)
    vy_new = vy + scale * ((-a * conv_y - a * pres_y) + visc * visc_y)

    fluid = node_type == FLUID
    rho_out = torch.where(fluid, rho_new, rho)
    vel_out = torch.where(fluid[..., None],
                          torch.stack([vx_new, vy_new], dim=-1), vel)
    return rho_out, vel_out


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
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    rc = load().lib.pd_ns2d(
        ptr(rho), ptr(vel), ptr(p), ptr(node_type), ptr(dt),
        ptr(kit.slot_offsets), ptr(kit.slot_coefs.float()), kit.S, ny, nx,
        dens, a, visc, rho_lo, rho_hi, ptr(rho_out), ptr(vel_out),
        rho.device.index, stream(rho))
    check(rc, "ns2d")
    ns2d.launches += 1
    return rho_out, vel_out


ns2d.launches = 0
