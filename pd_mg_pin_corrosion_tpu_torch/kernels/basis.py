"""basis_dots / basis_axpy — GMRES's whole-basis contractions: CUDA kernel
wrappers and plain twins.

Kernels: ``csrc/basis.cu`` (replace ``pallas_kernels._basis_dots_kernel``
/ ``basis_dots_pallas`` / ``basis_norm_pallas`` and
``_basis_axpy_kernel`` / ``basis_axpy_pallas`` of the JAX package). The
basis is a [k, N] tensor (rows 0..j of the Krylov basis) whose rows are
contiguous and may lie any number of floats apart (``V.stride(0)``, the
pitch): ``ops.gmres`` allocates it with a pitch that is a multiple of 32
floats, so the axpy kernel reads every row in 16-byte pieces. The flat
(R, 128) padding of the JAX package existed for the TPU's tiling and is not
needed here.
"""

from __future__ import annotations

import functools

import torch

from .build import check, load, ptr, stream, use_plain

_THREADS = 256       # csrc/common.cuh kThreads
_AXPY_THREADS = 128  # basis_axpy's block; each thread owns 4 elements a turn
PITCH_ALIGN = 32     # floats: rows of a pitched basis start on 128 bytes


def pitched_basis(rows: int, n: int, dtype, device) -> torch.Tensor:
    """An uninitialised [rows, n] basis whose rows are contiguous and lie a
    multiple of PITCH_ALIGN elements apart."""
    pitch = -(-n // PITCH_ALIGN) * PITCH_ALIGN
    return torch.empty((rows, pitch), dtype=dtype, device=device)[:, :n]


def _dots_blocks(n: int) -> int:
    """basis_dots' grid: 4 elements per thread, at most 1,024 blocks (the
    second pass adds one f64 partial per block and row)."""
    return max(1, min(-(-n // (_THREADS * 4)), 1024))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _axpy_blocks(n: int, index: int) -> int:
    """basis_axpy's grid: one 4-element piece per thread until every SM
    holds all the threads it can (2,048), a grid-stride loop beyond."""
    full = _sm_count(index) * (2048 // _AXPY_THREADS)
    pieces = -(-n // 4)
    return max(1, min(-(-pieces // _AXPY_THREADS), full))


def _check_basis(name, V):
    """(k, n, pitch) of a basis the kernels take: 2-D, contiguous rows."""
    if V.dim() != 2 or V.stride(1) != 1 or (
            V.shape[0] > 1 and V.stride(0) < V.shape[1]):
        raise ValueError(f"{name}: V must be [k, N] with contiguous rows, "
                         f"got shape {tuple(V.shape)} strides {V.stride()}")
    k, n = V.shape
    return k, n, V.stride(0) if k > 1 else n


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
    if use_plain("basis_dots", V[0], w):
        return basis_dots_plain(V, w)
    k, n, pitch = _check_basis("basis_dots", V)
    if w.shape != (n,):
        raise ValueError(f"basis_dots: w {tuple(w.shape)} vs V {tuple(V.shape)}")
    nblocks = _dots_blocks(n)
    partial = torch.empty(k * nblocks, dtype=torch.float64, device=V.device)
    out = torch.empty(k, dtype=torch.float64, device=V.device)
    rc = load().lib.pd_basis_dots(ptr(V), pitch, ptr(w), k, n, nblocks,
                                  ptr(partial), ptr(out), V.device.index,
                                  stream(V))
    check(rc, "basis_dots")
    basis_dots.launches += 1
    return out


def basis_axpy(c, V, w=None):
    """basis_axpy_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors. The kernel takes c in float64 and rounds
    it to float32 itself (the bits of ``c.to(torch.float32)``)."""
    if use_plain("basis_axpy", V[0], *(() if w is None else (w,))):
        return basis_axpy_plain(c, V, w)
    k, n, pitch = _check_basis("basis_axpy", V)
    if c.shape != (k,) or c.device != V.device or (
            w is not None and w.shape != (n,)):
        raise ValueError("basis_axpy: c / w do not match V")
    # widening is exact, so any other dtype rounds to the same float32
    c64 = c.to(torch.float64).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=V.device)
    rc = load().lib.pd_basis_axpy(ptr(c64), ptr(V), pitch,
                                  None if w is None else ptr(w), k, n,
                                  _axpy_blocks(n, V.device.index),
                                  _AXPY_THREADS, ptr(out), V.device.index,
                                  stream(V))
    check(rc, "basis_axpy")
    basis_axpy.launches += 1
    return out


basis_dots.launches = 0
basis_axpy.launches = 0
