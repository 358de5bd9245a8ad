"""matvec3d and slots3d_f64 — the 3D implicit-transport stencil sums: CUDA
kernel wrappers and plain twins.

Kernels: ``csrc/matvec3d.cu``.

* ``matvec3d`` replaces ``pallas_kernels._matvec_kernel_3d`` /
  ``matvec_M_pallas_3d_core``: y = diag*x + sum_s W_s*shift_s(x) on unknown
  rows, 0 elsewhere. W is float32 (the operator) or bfloat16 (the weights
  the Neumann preconditioner streams); bf16 weights are widened to float32
  before the multiply. ``matvec3d_plain`` on the dense [S, Nz, Ny, Nx]
  weights is the twin and the definition. The kernel takes the weights
  packed (``pack_stencil``, a ``PackedStencil``): only the nonzero ones,
  each with its slot number, since about half of a transport operator's
  weights are exact zeros and a skipped term ``acc + 0*x`` leaves the sum
  as it was.
* ``slots3d_f64`` replaces ``_matvec_kernel_3d_ds`` /
  ``matvec_slots_pallas_3d_ds``: the slot sum sum_s W_s*shift_s(x) alone (no
  diag, no mask) of a float64 x over the float32 W, accumulated in
  float64, for the residual of the f64 refinement. The TPU kernel emulated
  that accuracy with double-single f32 pairs (x as hi/lo); Hopper has
  native f64, so x arrives as one float64 tensor. ``slots3d_f64_plain`` on
  the dense weights is the twin; the kernel walks the same packed f32
  weights as matvec3d (``slots3d_f64_packed_plain`` is that walk), which
  gives the dense twin's bits wherever the dense W is zero off the unknown
  rows, as an assembled operator's is.

The dense twins evaluate the rows they write (matvec3d: the unknown rows)
and accumulate in stencil order over slot chunks (``kit.slot_chunks``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

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


SLICE = 32   # rows per slice of the packed layout: one warp
GROUP = 16   # nonzeros of a row per group (the kernel's PD_MATVEC3D_GROUP)


def lane_chunk(dtype, group: int = GROUP) -> int:
    """Values of one row that lie side by side within a group: 16 bytes of
    float32 (a warp's load is then one contiguous 512-byte run), the whole
    group of bfloat16 (32 bytes) and of the slot numbers."""
    return min(group, 4 if dtype.itemsize >= 4 else 16)


@dataclass(frozen=True)
class PackedStencil:
    """The nonzero weights of a [S, N] stencil operator's unknown rows.

    Rows are cut into slices of SLICE consecutive flat nodes; a slice
    stores as many value rows as its fullest row has nonzeros, rounded up
    to a multiple of ``group``. A row's nonzeros (ascending slot) are
    taken in groups of ``group``; a group of the slice's SLICE rows is one
    block of SLICE * group entries, in which a row's entries lie in chunks
    of ``c`` side by side, chunk after chunk: the q-th nonzero of node n
    is entry ``(slice_ptr[n // SLICE] + q - q % group) * SLICE
    + (q % group) // c * (SLICE * c) + (n % SLICE) * c + q % c``, with
    c = ``lane_chunk(values.dtype, group)`` in ``values`` and c = group in
    ``slots``. Padding entries are 0 and no reader uses them."""

    count: torch.Tensor      # [N] int16: nonzeros of each row (0: not unknown)
    slice_ptr: torch.Tensor  # [ceil(N / SLICE) + 1] int32, value rows before
    slots: torch.Tensor      # [SLICE * slice_ptr[-1]] uint8 slot numbers
    values: torch.Tensor     # the same length, float32 or bfloat16
    nnz: int                 # count.sum()
    group: int = GROUP

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def chunk(self) -> int:
        return lane_chunk(self.values.dtype, self.group)

    def to(self, dtype) -> "PackedStencil":
        """The same weights rounded to ``dtype``, in that dtype's layout
        (count, slice_ptr and slots are shared; a nonzero that rounds to 0
        is stored as 0)."""
        new = lane_chunk(dtype, self.group)
        values = self.values.to(dtype)
        if new != self.chunk:
            lane = torch.arange(SLICE, device=self.device)[:, None]
            q = torch.arange(self.group, device=self.device)[None, :]
            src = torch.empty(SLICE * self.group, dtype=torch.int64,
                              device=self.device)
            src[_in_block(lane, q, new).reshape(-1)] = _in_block(
                lane, q, self.chunk).reshape(-1)
            values = values.view(-1, SLICE * self.group)[:, src].reshape(-1)
        return replace(self, values=values)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.count, self.slice_ptr, self.slots, self.values))


def _in_block(lane, q, chunk):
    """Place of a row's q-th entry of a group (q < group) in the group's
    block, the row being lane ``lane`` of its slice."""
    return q // chunk * (SLICE * chunk) + lane * chunk + q % chunk


def _value_index(slice_ptr, nodes, q, group, chunk):
    """Index of the q-th packed entry (q an int or an int64 tensor
    broadcastable against ``nodes``) of each node in ``nodes``."""
    return ((slice_ptr[nodes // SLICE].to(torch.int64) + q - q % group)
            * SLICE + _in_block(nodes % SLICE, q % group, chunk))


def _flat_offsets(kit: Kit):
    """[S] int64: each slot's offset in the flat (unpadded) grid."""
    strides = [math.prod(kit.shape[a + 1:]) for a in range(kit.dim)]
    return kit.slot_offsets.to(torch.int64) @ torch.tensor(
        strides, dtype=torch.int64, device=kit.slot_offsets.device)


def _inside_tables(kit: Kit, device):
    """Per axis a [2 * mext + 1, N] bool table: row d + mext says which
    nodes have their neighbour at offset d along that axis inside the
    grid."""
    flat = torch.arange(math.prod(kit.shape), device=device)
    d = torch.arange(-kit.mext, kit.mext + 1, device=device)[:, None]
    tables = [None] * kit.dim
    for axis in reversed(range(kit.dim)):
        coord = (flat % kit.shape[axis])[None, :] + d
        tables[axis] = (coord >= 0) & (coord < kit.shape[axis])
        flat = flat // kit.shape[axis]
    return tables


def _kept(Wf, unk, kit: Kit, inside, s0: int, s1: int):
    """[s1 - s0, N] bool: the bonds of slots s0..s1-1 the packed form
    keeps: a nonzero weight, on an unknown row, to a neighbour inside the
    grid (outside it x reads as 0, so the term w * 0 changes no sum)."""
    keep = (Wf[s0:s1] != 0) & unk
    for axis, table in enumerate(inside):
        keep &= table[kit.slot_offsets[s0:s1, axis].to(torch.int64)
                      + kit.mext]
    return keep


def pack_stencil(W, unknown, kit: Kit, group: int = GROUP) -> PackedStencil:
    """Pack the dense weights W [S, *shape] of the rows in ``unknown``.
    Walks the stencil in slot chunks (half of ``kit.slot_chunks``' size:
    the index temporaries are 64-bit); reads back two scalars (the stored
    size and the nonzero count). ``group`` other than GROUP is for a
    kernel library built with that PD_MATVEC3D_GROUP."""
    S, N = kit.S, math.prod(kit.shape)
    if S > 256:
        raise ValueError(f"pack_stencil: S={S} slots do not fit one byte")
    Wf, unk = W.reshape(S, N), unknown.reshape(N)
    dev = W.device
    inside = _inside_tables(kit, dev)
    chunks = kit.slot_chunks(2 * N)
    count = torch.zeros(N, dtype=torch.int16, device=dev)
    for s0, s1 in chunks:
        count += _kept(Wf, unk, kit, inside, s0, s1).sum(0, dtype=torch.int16)
    n_slices = -(-N // SLICE)
    lens = torch.nn.functional.pad(count, (0, n_slices * SLICE - N)).view(
        n_slices, SLICE).max(1).values.to(torch.int32)
    lens = (lens + (group - 1)) // group * group
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int32, device=dev)
    slice_ptr[1:] = lens.cumsum(0)
    stored, nnz = (int(v) for v in torch.stack(
        [slice_ptr[-1].to(torch.int64), count.sum(dtype=torch.int64)]).cpu())
    values = torch.zeros(stored * SLICE, dtype=W.dtype, device=dev)
    chunk = lane_chunk(W.dtype, group)
    slots = torch.zeros(stored * SLICE, dtype=torch.uint8, device=dev)
    seen = torch.zeros(N, dtype=torch.int32, device=dev)
    for s0, s1 in chunks:
        nz = _kept(Wf, unk, kit, inside, s0, s1)
        rank = nz.cumsum(0, dtype=torch.int32)     # 1-based within the chunk
        slot, node = nz.nonzero(as_tuple=True)
        q = (seen[node] + rank[slot, node] - 1).to(torch.int64)
        values[_value_index(slice_ptr, node, q, group, chunk)] = Wf[s0:s1][
            slot, node]
        slots[_value_index(slice_ptr, node, q, group, group)] = (
            slot + s0).to(torch.uint8)
        seen += rank[-1]
    return PackedStencil(count=count, slice_ptr=slice_ptr, slots=slots,
                         values=values, nnz=nnz, group=group)


def _entries(packed: PackedStencil, nodes):
    """(node, slot, value) of every packed nonzero of ``nodes``, rows in
    order of q."""
    count = packed.count[nodes].to(torch.int64)
    depth = int(count.max()) if nodes.numel() else 0
    q = torch.arange(depth, device=packed.device)[:, None]
    live = q < count[None, :]
    nodes = nodes[None, :].expand(depth, -1)[live]
    q = q.expand(-1, count.numel())[live]
    at = (packed.slice_ptr, nodes, q, packed.group)
    return (nodes,
            packed.slots[_value_index(*at, packed.group)].to(torch.int64),
            packed.values[_value_index(*at, packed.chunk)])


def unpack_stencil(packed: PackedStencil, kit: Kit):
    """The dense [S, *shape] weights a PackedStencil holds (0 where it
    stores nothing), in the values' dtype; the inverse of ``pack_stencil``
    on unknown rows. One [S, N] stack: for checks on small grids."""
    n = packed.count.numel()
    dense = torch.zeros((kit.S, n), dtype=packed.dtype, device=packed.device)
    node, slot, value = _entries(packed, torch.arange(n, device=packed.device))
    dense[slot, node] = value
    return dense.view((kit.S,) + kit.shape)


def _packed_walk(acc, x, packed: PackedStencil, rows, kit: Kit):
    """acc + each row's stored nonzeros times x at their slots, in stored
    (ascending slot) order, the weights widened to x's dtype: the kernels'
    walk of ``rows`` (flat indices), one nonzero of every row at a time."""
    count = packed.count[rows]
    xf, offsets = x.reshape(-1), _flat_offsets(kit)
    for q in range(int(count.max()) if rows.numel() else 0):
        r = (count > q).nonzero().squeeze(1)
        at = (packed.slice_ptr, rows[r], q, packed.group)
        slot = packed.slots[_value_index(*at, packed.group)].to(torch.int64)
        w = packed.values[_value_index(*at, packed.chunk)]
        acc[r] = acc[r] + w.to(x.dtype) * xf[rows[r] + offsets[slot]]
    return acc


def matvec3d_packed_plain(x, packed: PackedStencil, diag, unknown, kit: Kit):
    """matvec3d_plain's function on the packed weights, walked as the
    kernel walks them: per unknown row its stored nonzeros in order, each
    with the slot stored beside it. Equal to ``matvec3d_plain`` on the
    dense weights bit for bit for finite x."""
    rows = unknown.reshape(-1).nonzero().squeeze(1)
    acc = diag.reshape(-1)[rows] * x.reshape(-1)[rows]
    y = torch.zeros_like(x)
    y.view(-1)[rows] = _packed_walk(acc, x, packed, rows, kit)
    return y


def slots3d_f64_packed_plain(x, packed: PackedStencil, kit: Kit):
    """slots3d_f64_plain's slot sum over the packed weights, as the kernel
    walks it: every row from +0, its stored nonzeros in order; +0 on a row
    with none (every row that is not unknown). Equal to
    ``slots3d_f64_plain`` on a dense W that is zero off the packed rows,
    bit for bit for finite x."""
    rows = (packed.count > 0).nonzero().squeeze(1)
    acc = torch.zeros(rows.numel(), dtype=x.dtype, device=x.device)
    y = torch.zeros_like(x)
    y.view(-1)[rows] = _packed_walk(acc, x, packed, rows, kit)
    return y


def _check_packed(name, W: PackedStencil, x, kit: Kit):
    if (x.shape != kit.shape or W.count.shape != (x.numel(),)
            or W.slots.shape != W.values.shape
            or W.slice_ptr.shape != (-(-x.numel() // SLICE) + 1,)):
        raise ValueError(f"{name}: x / packed weights do not match the grid "
                         f"{kit.shape} and S={kit.S}")


def matvec3d(x, W, diag, unknown, kit: Kit):
    """matvec3d_plain's contract. On CUDA float32 tensors the kernel, which
    takes W as a ``PackedStencil`` (float32 or bfloat16 values) and raises
    on dense weights; on CPU tensors the plain version of whichever form W
    has. Launches are counted per weight type: ``launches`` (float32),
    ``launches_bf16``."""
    is_packed = isinstance(W, PackedStencil)
    if use_plain("matvec3d", x, diag, unknown):
        plain = matvec3d_packed_plain if is_packed else matvec3d_plain
        return plain(x, W, diag, unknown, kit)
    if not is_packed:
        raise TypeError("matvec3d: the CUDA kernel takes packed weights "
                        "(pack_stencil), got a dense tensor")
    if W.device != x.device or W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matvec3d: packed values must be float32 or "
                        f"bfloat16 on {x.device}, got {W.dtype} on {W.device}")
    _check_packed("matvec3d", W, x, kit)
    if diag.shape != kit.shape or unknown.dtype != torch.bool:
        raise ValueError("matvec3d: diag / unknown do not match the grid "
                         f"{kit.shape}")
    y = torch.empty_like(x)
    entry = (load().lib.pd_matvec3d_f32 if W.dtype == torch.float32
             else load().lib.pd_matvec3d_bf16)
    rc = entry(ptr(x), ptr(W.values), ptr(W.slots), ptr(W.count),
               ptr(W.slice_ptr), ptr(diag), ptr(unknown),
               ptr(kit.slot_offsets), kit.S, *kit.shape, W.group, ptr(y),
               x.device.index, stream(x))
    check(rc, "matvec3d")
    if W.dtype == torch.float32:
        matvec3d.launches += 1
    else:
        matvec3d.launches_bf16 += 1
    return y


def slots3d_f64(x, W, kit: Kit):
    """slots3d_f64_plain's contract. On CUDA tensors the kernel, which
    takes a float64 x and the float32 weights as a ``PackedStencil`` (the
    operator's ``packed``) and raises on dense weights; on CPU tensors the
    plain version of whichever form W has."""
    is_packed = isinstance(W, PackedStencil)
    if x.device != W.device:
        raise ValueError(f"slots3d_f64: x on {x.device}, W on {W.device}")
    if use_plain("slots3d_f64", W.values if is_packed else W):
        plain = slots3d_f64_packed_plain if is_packed else slots3d_f64_plain
        return plain(x, W, kit)
    if not is_packed:
        raise TypeError("slots3d_f64: the CUDA kernel takes packed weights "
                        "(pack_stencil), got a dense tensor")
    if x.dtype != torch.float64 or not x.is_contiguous():
        raise TypeError("slots3d_f64: x must be a contiguous float64 tensor")
    _check_packed("slots3d_f64", W, x, kit)
    y = torch.empty_like(x)
    rc = load().lib.pd_slots3d_f64(
        ptr(x), ptr(W.values), ptr(W.slots), ptr(W.count), ptr(W.slice_ptr),
        ptr(kit.slot_offsets), kit.S, *kit.shape, W.group, ptr(y),
        x.device.index, stream(x))
    check(rc, "slots3d_f64")
    slots3d_f64.launches += 1
    return y


matvec3d.launches = 0
matvec3d.launches_bf16 = 0
slots3d_f64.launches = 0
