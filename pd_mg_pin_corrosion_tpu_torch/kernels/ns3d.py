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
the card's checks hold the kernel against it.
"""

from __future__ import annotations

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


def ns3d_plain(rho, vel, p, node_type, dt, kit: Kit):
    """(rho_new, vel_new) of one 3D PD-NS step; every node that is not
    FLUID keeps its input value. ``p`` is Tait(rho); ``dt`` a 0-d tensor."""
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    rows = (node_type == FLUID).reshape(-1).nonzero().squeeze(1)
    pidx = kit.padded_index(rows)
    act = (node_type != OUTSIDE).to(rho.dtype)
    vfull = [vel[..., d] for d in range(3)]
    pads = [kit.pad(f * act, 0.0).reshape(-1) for f in [rho, *vfull, p]]

    def at(f):
        return f.reshape(-1)[rows]

    r, pi, v = at(rho), at(p), [at(f) for f in vfull]
    # 11 accumulators: mass conv, mass diff, conv xyz, pres xyz, visc xyz
    acc = torch.zeros((11, rows.numel()), dtype=rho.dtype, device=rho.device)
    coefs = kit.ns_coefs.to(rho.dtype)
    for s0, s1 in kit.slot_chunks(rows.numel()):
        c2, ex, ey, ez = coefs[:, s0:s1, None]
        idx = pidx[None, :] + kit.slot_flat[kit.ns_slots[s0:s1], None]
        R, VX, VY, VZ, P = (f[idx] for f in pads)
        # an exactly-zero e component contributes an exact (+-)0
        fdj = ((R * VX) * ex + (R * VY) * ey) + (R * VZ) * ez
        T = torch.stack([fdj, R * c2, VX * fdj, VY * fdj, VZ * fdj,
                         P * ex, P * ey, P * ez, VX * c2, VY * c2, VZ * c2])
        for s in range(s1 - s0):
            acc = acc + T[:, s]

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
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    rc = load().lib.pd_ns3d(
        ptr(rho), ptr(vel), ptr(p), ptr(node_type), ptr(dt),
        ptr(kit.ns_offsets), ptr(kit.ns_coefs), ptr(kit.actconv3d), kit.S,
        nz, ny, nx, dens, a, visc, rho_lo, rho_hi, ptr(rho_out), ptr(vel_out),
        rho.device.index, stream(rho))
    check(rc, "ns3d")
    ns3d.launches += 1
    return rho_out, vel_out


ns3d.launches = 0
