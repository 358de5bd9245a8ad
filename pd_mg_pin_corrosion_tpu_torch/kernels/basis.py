"""basis_dots / basis_axpy — GMRES's whole-basis contractions: CUDA kernel
wrappers and plain twins.

Kernels: ``csrc/basis.cu`` (replace ``pallas_kernels._basis_dots_kernel``
/ ``basis_dots_pallas`` / ``basis_norm_pallas`` and
``_basis_axpy_kernel`` / ``basis_axpy_pallas`` of the JAX package). The
basis is a [k, N] tensor (rows 0..j of the Krylov basis) whose rows are
contiguous and may lie any number of floats apart (``V.stride(0)``, the
pitch): ``ops.gmres`` allocates it with a pitch that is a multiple of 32
floats, so both kernels read every row in 16-byte pieces. The flat
(R, 128) padding of the JAX package existed for the TPU's tiling and is not
needed here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .build import check, load, ptr, stream, use_plain

_DOTS_THREADS = 512  # basis_dots' block: 16 warps
_DOTS_WAVES = 2      # blocks of basis_dots an SM gets at most
_DOTS_ITEMS = 1      # (row, part) items a warp of basis_dots gets, about
_DOTS_MIN_PIECES = 64   # a block of basis_dots owns at least this many
_FINAL_LANES = 16    # csrc/basis.cu kFinalLanes: threads a row of the last sum
_AXPY_THREADS = 128  # basis_axpy's block; each thread owns 4 elements a turn
PITCH_ALIGN = 32     # floats: rows of a pitched basis start on 128 bytes


def pitched_basis(rows: int, n: int, dtype, device) -> torch.Tensor:
    """An uninitialised [rows, n] basis whose rows are contiguous and lie a
    multiple of PITCH_ALIGN elements apart."""
    pitch = -(-n // PITCH_ALIGN) * PITCH_ALIGN
    return torch.empty((rows, pitch), dtype=dtype, device=device)[:, :n]


def dots_grid(k: int, n: int, sms: int) -> tuple[int, int, int]:
    """basis_dots' launch on a card of ``sms`` SMs: (blocks, share, parts).
    The vector is cut into pieces of four elements (the last may be short);
    block b owns the pieces [b * share, (b + 1) * share), and cuts them
    into ``parts`` parts so that each of its warps has about _DOTS_ITEMS
    (row, part) items. _DOTS_WAVES blocks an SM, fewer while a block would
    own less than _DOTS_MIN_PIECES pieces."""
    pieces = -(-n // 4)
    blocks = max(1, min(sms * _DOTS_WAVES, pieces // _DOTS_MIN_PIECES))
    parts = max(1, -(-_DOTS_ITEMS * (_DOTS_THREADS // 32) // k))
    return blocks, -(-pieces // blocks), parts


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


def basis_dots_walk_plain(V, w, sms: int = 132):
    """basis_dots_plain's sums taken in the CUDA kernel's order on a card
    of ``sms`` SMs (csrc/basis.cu dots_kernel): a warp owns one row over
    one part of its block's pieces; lane l adds the four products of the
    part's pieces l, l + 32, ... in order, the warp its lanes by a shuffle
    tree, the block a row's parts in order, and the last block the blocks'
    partials: of the _FINAL_LANES threads that share a row, thread q those
    of blocks q, q + _FINAL_LANES, ... in order, then the tree again. The
    16-byte and the scalar form of the kernel both take this order."""
    k, n = V.shape
    blocks, share, parts = dots_grid(k, n, sms)
    sub = -(-share // parts)
    turns = -(-sub // 32)

    def tree(v):   # [..., 2^m] -> [...]: v += shfl_down(v, off), lane 0
        off = v.shape[-1] // 2
        while off:
            v = v[..., :off] + v[..., off:2 * off]
            off //= 2
        return v[..., 0]

    def in_turn(v):   # [..., m, lanes] -> [..., lanes]: added in order
        acc = torch.zeros_like(v[..., 0, :])
        for t in range(v.shape[-2]):
            acc = acc + v[..., t, :]
        return acc

    prod = (V * w).to(torch.float64)
    # pieces beyond the vector's end, beyond a block's share or a part's
    # end, and a short piece's missing elements, add exact zeros
    prod = F.pad(prod, (0, 4 * blocks * share - n)).view(k, blocks, share, 4)
    prod = F.pad(prod, (0, 0, 0, parts * sub - share)).view(
        k, blocks, parts, sub, 4)
    prod = F.pad(prod, (0, 0, 0, turns * 32 - sub)).view(
        k, blocks, parts, turns, 32, 4)
    # [k, blocks, parts, turns * 4, 32]: a lane's elements in its order
    lane = in_turn(prod.permute(0, 1, 2, 3, 5, 4).reshape(
        k, blocks, parts, turns * 4, 32))
    block = in_turn(tree(lane)[..., None])[..., 0]
    final = F.pad(block, (0, -blocks % _FINAL_LANES)).view(
        k, -1, _FINAL_LANES)
    return tree(in_turn(final))


# (partial, ticket) of basis_dots, one pair per (device, stream): calls on
# one stream run one after the other, so they can share it
_dots_scratch: dict = {}
# (device, stream) pairs whose scratch CUDA graphs read, and the scratch
# such a stream outgrew: kept, since a graph captured before still reads it
_pinned: set = set()
_retired: list = []


def _scratch(device, stream_ptr: int, rows: int, blocks: int):
    key = (device.index, stream_ptr)
    pair = _dots_scratch.get(key)
    if pair is None or pair[0].numel() < rows * blocks:
        if pair is not None and key in _pinned:
            _retired.append(pair)
        ticket = (torch.zeros(1, dtype=torch.int32, device=device)
                  if pair is None else pair[1])
        pair = (torch.empty(max(rows, 32) * blocks, dtype=torch.float64,
                            device=device), ticket)
        _dots_scratch[key] = pair
    return pair


def reserve_dots_scratch(device, stream_ptr: int, rows: int) -> None:
    """Size basis_dots' scratch on the stream ``stream_ptr`` for up to
    ``rows`` rows at any vector length (the most blocks a launch takes on
    this card) and pin it: a graph captured on that stream keeps its
    address, so a later call that needs more (a runner of another kit
    handed the same stream from PyTorch's pool, with a longer basis) gets
    a new scratch and the old one is kept, never freed. The ticket
    resets itself at the end of every call, so replays may follow each
    other."""
    _scratch(device, stream_ptr, rows, _sm_count(device.index) * _DOTS_WAVES)
    _pinned.add((device.index, stream_ptr))


def basis_dots(V, w):
    """basis_dots_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors. One launch; deterministic (no float
    atomics), and the bits depend on neither the pitch nor the pointers'
    alignment."""
    if use_plain("basis_dots", V[0], w):
        return basis_dots_plain(V, w)
    k, n, pitch = _check_basis("basis_dots", V)
    if w.shape != (n,):
        raise ValueError(f"basis_dots: w {tuple(w.shape)} vs V {tuple(V.shape)}")
    blocks, _, parts = dots_grid(k, n, _sm_count(V.device.index))
    st = stream(V)
    partial, ticket = _scratch(V.device, st.value or 0, k, blocks)
    out = torch.empty(k, dtype=torch.float64, device=V.device)
    rc = load().lib.pd_basis_dots(ptr(V), pitch, ptr(w), k, n, blocks,
                                  _DOTS_THREADS, parts, ptr(partial),
                                  ptr(ticket),
                                  ptr(out), V.device.index, st)
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
