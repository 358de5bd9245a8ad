"""matvec2d — the implicit-transport stencil matvec: CUDA kernel wrapper
and plain twin.

Kernel: ``csrc/matvec2d.cu`` (replaces ``pallas_kernels._matvec_kernel`` /
``matvec_M_pallas`` of the JAX package). ``matvec2d_plain`` is
``ard_implicit.matvec_M``'s math in plain PyTorch: y = diag*x + sum_s
W_s*shift_s(x) accumulated in stencil order, 0 on rows that are not
unknown. The f64 refinement residual calls it directly in float64.
"""

from __future__ import annotations

import torch

from ..kit import Kit, slot_sum
from .build import check, load, ptr, stream, use_plain


def matvec2d_plain(x, W, diag, unknown, kit: Kit):
    X = kit.neighbors(kit.pad(x, 0.0))
    y = slot_sum(torch.cat([(diag * x)[None], W * X]))
    return torch.where(unknown, y, 0.0)


def matvec2d(x, W, diag, unknown, kit: Kit):
    """matvec2d_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors."""
    if use_plain("matvec2d", x, W, diag, unknown):
        return matvec2d_plain(x, W, diag, unknown, kit)
    ny, nx = kit.shape
    if (x.shape != (ny, nx) or W.shape != (kit.S, ny, nx)
            or diag.shape != (ny, nx) or unknown.dtype != torch.bool):
        raise ValueError("matvec2d: inputs do not match the grid / stencil")
    y = torch.empty_like(x)
    rc = load().lib.pd_matvec2d(
        ptr(x), ptr(W), ptr(diag), ptr(unknown), ptr(kit.slot_offsets),
        kit.S, ny, nx, ptr(y), x.device.index, stream(x))
    check(rc, "matvec2d")
    matvec2d.launches += 1
    return y


matvec2d.launches = 0
