"""ard2d — one explicit 2D transport step: CUDA kernel wrapper and plain
twin.

Kernel: ``csrc/ard2d.cu`` (replaces ``pallas_kernels._ard_kernel`` /
``ard_step_pallas`` of the JAX package). ``ard2d_plain`` is the math of
``ops/ard.py`` ``ard_step`` of the JAX package, operation for operation,
with slot sums taken in stencil order: bi-material bonds (liquid-liquid,
interface, solid-solid skipped), the harmonic-mean interface diffusivity
zeroed by salt blocking, artificial diffusion on liquid-liquid bonds and
non-conservative advection. The per-node inputs the TPU wrapper formed in
XLA are formed by the caller (``ops/ard.ard_step``): |v|, the solid-side
micro-diffusivity Ds and the salt-blocking flags.
"""

from __future__ import annotations

import torch

from ..grid import (FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG,
                    WALL)
from ..kit import Kit
from .build import check, load, ptr, stream, use_plain


def ard2d_plain(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit):
    """C after one explicit transport step; nodes that are neither FLUID
    nor SOLID_MG keep their value. ``dt`` is a float or a 0-d tensor."""
    cfg = kit.cfg
    dt = torch.as_tensor(dt, dtype=C.dtype, device=C.device)
    i_fluid = node_type == FLUID
    i_solid = node_type == SOLID_MG
    vel_i = torch.where(i_fluid[..., None], vel, 0.0)
    vmag_i = torch.where(i_fluid, vmag, 0.0)
    pads = dict(nt=kit.pad(node_type, OUTSIDE), C=kit.pad(C, 0.0),
                vmag=kit.pad(vmag, 0.0), Ds=kit.pad(Ds, 0.0),
                salt=kit.pad(salt, False))

    acc = torch.zeros((2,) + kit.shape, dtype=C.dtype, device=C.device)
    for s0, s1 in kit.slot_chunks():
        def nb(key):
            return kit.neighbors(pads[key], s0=s0, s1=s1)

        ixi, ixi2, e, vol = kit.coefs(s0, s1)
        NT = nb("nt")
        # transport bonds exclude WALL and OUTSIDE neighbours (pd_ard.cpp:120)
        V_j = vol * ((NT != WALL) & (NT != OUTSIDE)).to(C.dtype)
        j_fluid = ((NT == FLUID) | (NT == INLET) | (NT == OUTLET)
                   | (NT == FICTITIOUS))
        j_solid = NT == SOLID_MG
        ll = i_fluid & j_fluid                  # liquid-liquid
        ss = i_solid & j_solid                  # skipped (pd_ard.cpp:134)
        iface = (i_fluid & j_solid) | (i_solid & j_fluid)

        # interface micro-diffusivity from the solid side (pd_ard.cpp:143-161)
        solid_D = torch.where(i_solid, Ds, nb("Ds"))
        solid_blocked = torch.where(i_solid, salt, nb("salt"))
        D_iface = torch.where(
            solid_blocked, 0.0,
            2.0 * cfg.D_liquid * solid_D / (cfg.D_liquid + solid_D + 1e-30))
        D_avg = torch.where(ll, cfg.D_liquid, torch.where(iface, D_iface, 0.0))
        # artificial diffusion on liquid-liquid bonds (pd_ard.cpp:164-170)
        D_art = torch.where(ll, cfg.alpha_art_diff
                            * torch.maximum(vmag_i, nb("vmag")) * cfg.dx, 0.0)
        bond_on = (~ss).to(C.dtype)
        dC = nb("C") - C
        T_diff = kit.beta_lap * (D_avg + D_art) * dC * ixi2 * V_j * bond_on
        # non-conservative advection, LL bonds only (pd_ard.cpp:178-181)
        v_dot_e = vel_i[..., 0] * e[0]
        for d in range(1, kit.dim):
            v_dot_e = v_dot_e + vel_i[..., d] * e[d]
        T_adv = torch.where(ll, dC * v_dot_e * ixi * V_j, 0.0)
        T = torch.stack([T_diff, T_adv], dim=1)
        for s in range(s1 - s0):
            acc = acc + T[s]   # (diff, adv) in stencil order

    diff, adv = acc
    C_new = C + dt * (diff - (kit.alpha / kit.V_H) * adv)
    C_new = torch.clamp(C_new, min=0.0)  # physical clamp (pd_ard.cpp:188-190)
    return torch.where(i_fluid | i_solid, C_new, C)


def ard2d(C, vel, vmag, node_type, Ds, salt, dt, kit: Kit):
    """ard2d_plain's contract: the kernel on CUDA float32 tensors, the plain
    version on CPU tensors. ``dt`` is a Python float (the explicit step's
    fixed dt) or a 0-d tensor."""
    if use_plain("ard2d", C, vel, vmag, node_type, Ds, salt):
        return ard2d_plain(C, vel, vmag, node_type, Ds, salt, dt, kit)
    ny, nx = kit.shape
    if (kit.dim != 2 or C.shape != (ny, nx) or vel.shape != (ny, nx, 2)
            or vmag.shape != (ny, nx) or Ds.shape != (ny, nx)
            or node_type.shape != (ny, nx) or salt.shape != (ny, nx)):
        raise ValueError(f"ard2d: shapes do not match the 2D grid {kit.shape}")
    if node_type.dtype != torch.uint8 or salt.dtype != torch.bool:
        raise TypeError("ard2d: node_type must be uint8 and salt bool")
    cfg = kit.cfg
    C_out = torch.empty_like(C)
    rc = load().lib.pd_ard2d(
        ptr(C), ptr(vel), ptr(vmag), ptr(node_type), ptr(Ds), ptr(salt),
        float(dt), ptr(kit.slot_offsets), ptr(kit.slot_coefs), kit.S, ny, nx,
        kit.beta_lap, cfg.D_liquid, 2.0 * cfg.D_liquid, cfg.alpha_art_diff,
        cfg.dx, kit.alpha / kit.V_H, ptr(C_out), C.device.index, stream(C))
    check(rc, "ard2d")
    ard2d.launches += 1
    return C_out


ard2d.launches = 0
