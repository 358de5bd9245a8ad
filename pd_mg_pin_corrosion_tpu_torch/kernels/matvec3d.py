"""matvec3d and slots3d_f64 — the 3D implicit-transport stencil sums: CUDA
kernel wrappers and plain twins.

Kernels: ``csrc/matvec3d.cu``.

* ``matvec3d`` replaces ``pallas_kernels._matvec_kernel_3d`` /
  ``matvec_M_pallas_3d_core``: y = diag*x + sum_s W_s*shift_s(x) on unknown
  rows, 0 elsewhere. W is float32 (the operator) or bfloat16 (the copy the
  Neumann preconditioner streams); bf16 weights are widened to float32
  before the multiply.
* ``slots3d_f64`` replaces ``_matvec_kernel_3d_ds`` /
  ``matvec_slots_pallas_3d_ds``: the slot sum sum_s W_s*shift_s(x) alone (no
  diag, no mask) of a float64 x, accumulated in float64, for the residual
  of the f64 refinement. The TPU kernel emulated that accuracy with
  double-single f32 pairs (x as hi/lo); Hopper has native f64, so x
  arrives as one float64 tensor.

The twins evaluate the rows they write (matvec3d: the unknown rows) and
accumulate in stencil order over slot chunks (``kit.slot_chunks``).
"""

from __future__ import annotations

import torch

from ..kit import Kit
from .build import check, load, ptr, stream, use_plain


def _slot_sum(x, W, kit: Kit, rows, y):
    """y + sum_s W_s * shift_s(x) in stencil order at the flat node indices
    ``rows``, W widened to x's dtype."""
    pidx = kit.padded_index(rows)
    xp = kit.pad(x, 0.0)
    Wf = W.reshape(kit.S, -1)
    for s0, s1 in kit.slot_chunks(rows.numel()):
        X, = kit.gather(pidx, s0, s1, xp)
        T = Wf[s0:s1, rows].to(x.dtype) * X
        for s in range(s1 - s0):
            y = y + T[s]
    return y


def matvec3d_plain(x, W, diag, unknown, kit: Kit):
    rows = unknown.reshape(-1).nonzero().squeeze(1)
    y = torch.zeros_like(x)
    y.view(-1)[rows] = _slot_sum(x, W, kit, rows, diag.reshape(-1)[rows]
                                 * x.reshape(-1)[rows])
    return y


def slots3d_f64_plain(x, W, kit: Kit):
    rows = torch.arange(x.numel(), device=x.device)
    return _slot_sum(x, W, kit, rows, torch.zeros_like(x).reshape(-1)).view(
        kit.shape)


def _check_weights(name, W, x, kit: Kit, dtypes):
    if W.device != x.device or W.dtype not in dtypes or not W.is_contiguous():
        raise TypeError(f"{name}: W must be a contiguous {dtypes} tensor on "
                        f"{x.device}, got {W.dtype} on {W.device}")
    if W.shape != (kit.S,) + kit.shape or x.shape != kit.shape:
        raise ValueError(f"{name}: W {tuple(W.shape)} / x {tuple(x.shape)} "
                         f"do not match the grid {kit.shape} and S={kit.S}")


def matvec3d(x, W, diag, unknown, kit: Kit):
    """matvec3d_plain's contract: the kernel on CUDA float32 tensors (W
    float32 or bfloat16), the plain version on CPU tensors. Launches are
    counted per weight type: ``launches`` (float32), ``launches_bf16``."""
    if use_plain("matvec3d", x, diag, unknown):
        return matvec3d_plain(x, W, diag, unknown, kit)
    _check_weights("matvec3d", W, x, kit, (torch.float32, torch.bfloat16))
    if diag.shape != kit.shape or unknown.dtype != torch.bool:
        raise ValueError("matvec3d: diag / unknown do not match the grid")
    y = torch.empty_like(x)
    xp = kit.pad(x, 0.0)
    entry = (load().lib.pd_matvec3d_f32 if W.dtype == torch.float32
             else load().lib.pd_matvec3d_bf16)
    rc = entry(ptr(xp), ptr(W), ptr(diag), ptr(unknown), ptr(kit.slot_flat),
               kit.S, *kit.shape, kit.mext, ptr(y), x.device.index, stream(x))
    check(rc, "matvec3d")
    if W.dtype == torch.float32:
        matvec3d.launches += 1
    else:
        matvec3d.launches_bf16 += 1
    return y


def slots3d_f64(x, W, kit: Kit):
    """slots3d_f64_plain's contract: the kernel for a CUDA float32 W and
    float64 x, the plain version on CPU tensors."""
    if x.device != W.device:
        raise ValueError(f"slots3d_f64: x on {x.device}, W on {W.device}")
    if use_plain("slots3d_f64", W):
        return slots3d_f64_plain(x, W, kit)
    _check_weights("slots3d_f64", W, x, kit, (torch.float32,))
    if x.dtype != torch.float64 or not x.is_contiguous():
        raise TypeError("slots3d_f64: x must be a contiguous float64 tensor")
    y = torch.empty_like(x)
    xp = kit.pad(x, 0.0)
    rc = load().lib.pd_slots3d_f64(ptr(xp), ptr(W), ptr(kit.slot_flat),
                                   kit.S, *kit.shape, kit.mext, ptr(y),
                                   x.device.index, stream(x))
    check(rc, "slots3d_f64")
    slots3d_f64.launches += 1
    return y


matvec3d.launches = 0
matvec3d.launches_bf16 = 0
slots3d_f64.launches = 0
