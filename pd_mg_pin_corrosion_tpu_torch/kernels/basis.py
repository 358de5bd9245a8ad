"""basis_dots / basis_axpy — GMRES's whole-basis contractions: CUDA kernel
wrappers and plain twins.

Kernels: ``csrc/basis.cu`` (replace ``pallas_kernels._basis_dots_kernel``
/ ``basis_dots_pallas`` / ``basis_norm_pallas`` and
``_basis_axpy_kernel`` / ``basis_axpy_pallas`` of the JAX package). The
basis is a contiguous [k, N] tensor (rows 0..j of the Krylov basis); the
flat (R, 128) padding of the JAX package existed for the TPU's tiling and
is not needed here.
"""

from __future__ import annotations

import torch

from .build import check, load, ptr, stream, use_plain

_THREADS = 256      # csrc/common.cuh kThreads
_MAX_BLOCKS = 1024  # grid-stride cap: ~4+ elements per thread at N ~ 2e5


def _blocks(n: int) -> int:
    return max(1, min(-(-n // (_THREADS * 4)), _MAX_BLOCKS))


def basis_dots_plain(V, w):
    """c[r] = <V[r], w> for every row: f32 products (for f32 inputs)
    summed in float64."""
    return (V * w).sum(dim=-1, dtype=torch.float64)


def basis_axpy_plain(c, V, w=None):
    """w - sum_r c[r] * V[r] with rows in order and c cast to V's dtype
    (w = None means w = 0)."""
    c = c.to(V.dtype)
    acc = torch.zeros_like(V[0]) if w is None else w
    for r in range(V.shape[0]):
        acc = acc - c[r] * V[r]
    return acc


def basis_dots(V, w):
    """basis_dots_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors. Deterministic (no atomics)."""
    if use_plain("basis_dots", V, w):
        return basis_dots_plain(V, w)
    k, n = V.shape
    if w.shape != (n,):
        raise ValueError(f"basis_dots: w {tuple(w.shape)} vs V {tuple(V.shape)}")
    nblocks = _blocks(n)
    partial = torch.empty(k * nblocks, dtype=torch.float64, device=V.device)
    out = torch.empty(k, dtype=torch.float64, device=V.device)
    rc = load().lib.pd_basis_dots(ptr(V), ptr(w), k, n, nblocks,
                                  ptr(partial), ptr(out), V.device.index,
                                  stream(V))
    check(rc, "basis_dots")
    basis_dots.launches += 1
    return out


def basis_axpy(c, V, w=None):
    """basis_axpy_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors."""
    if use_plain("basis_axpy", V, *(() if w is None else (w,))):
        return basis_axpy_plain(c, V, w)
    k, n = V.shape
    if c.shape != (k,) or c.device != V.device or (
            w is not None and w.shape != (n,)):
        raise ValueError("basis_axpy: c / w do not match V")
    c32 = c.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=V.device)
    rc = load().lib.pd_basis_axpy(ptr(c32), ptr(V),
                                  None if w is None else ptr(w), k, n,
                                  _blocks(n), ptr(out), V.device.index,
                                  stream(V))
    check(rc, "basis_axpy")
    basis_axpy.launches += 1
    return out


basis_dots.launches = 0
basis_axpy.launches = 0
