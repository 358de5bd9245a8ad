"""matvec3d and slots3d_f64 — the 3D implicit-transport stencil sums — and
pack3d, which builds their packed weights: CUDA kernel wrappers and plain
twins.

Kernels: ``csrc/matvec3d.cu``, ``csrc/pack3d.cu``.

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

* ``pack3d`` (``csrc/pack3d.cu``) replaces no TPU kernel: it builds the
  packed operator of a 3D state on the card, each weight formed from the
  per-node fields where it is packed (no dense W), into capacity buffers
  with no host read (the fused coupling cycles) or, in ``pack3d_alloc``,
  into buffers sized by one read (the host loop). ``pack3d_plain``, the
  dense assembly followed by the packing walk, is its twin.

The dense twins evaluate the rows they write (matvec3d: the unknown rows)
and accumulate in stencil order over slot chunks (``kit.slot_chunks``).
"""

from __future__ import annotations

import ctypes
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


def _packed_at(base, q, group: int, lane, chunk: int):
    """Entry of the q-th packed value of lane ``lane`` of a slice whose rows
    start at value row ``base`` (csrc/pack3d.cu ``at``)."""
    return ((base + q - q % group) * SLICE + (q % group) // chunk
            * (SLICE * chunk) + lane * chunk + q % chunk)


def _pack3d_check(kit: Kit, packed, packed16, status):
    n = math.prod(kit.shape)
    n_slices = -(-n // SLICE)
    if (packed.count.shape != (n,) or packed.count.dtype != torch.int16
            or packed.slice_ptr.shape != (n_slices + 1,)
            or packed.slice_ptr.dtype != torch.int32
            or packed.slots.dtype != torch.uint8
            or packed.values.dtype != torch.float32
            or packed16.values.dtype != torch.bfloat16
            or packed16.count is not packed.count
            or packed16.slice_ptr is not packed.slice_ptr
            or packed16.slots is not packed.slots
            or packed.group != GROUP or packed16.group != GROUP
            or status.dtype != torch.int64 or status.numel() < 2):
        raise ValueError("pack3d: a float32 and a bfloat16 PackedStencil "
                         f"of group {GROUP} sharing count, slice_ptr and "
                         "slots of this grid, and an int64 status [2]")
    return n, n_slices


def _pack3d_check_state(state, decay, kit: Kit, diag=None, unknown=None):
    shape = tuple(kit.shape)
    if (kit.dim != 3 or state.node_type.shape != shape
            or state.node_type.dtype != torch.uint8
            or state.vel.shape != shape + (3,)
            or state.vel.dtype != torch.float32
            or state.C.shape != shape or state.C.dtype != torch.float32
            or state.is_gb.shape != shape or state.is_gb.dtype != torch.bool
            or state.is_precip.shape != shape
            or state.is_precip.dtype != torch.bool
            or decay.shape != () or decay.dtype != torch.float32
            or (diag is not None and (diag.shape != shape
                                      or diag.dtype != torch.float32))
            or (unknown is not None and (unknown.shape != shape
                                         or unknown.dtype != torch.bool))):
        raise ValueError("pack3d: a 3D float32 state of the kit's grid "
                         "(node_type uint8, vel [*shape, 3], C, is_gb and "
                         "is_precip bool), a 0-d float32 decay factor, and "
                         "diag float32 and unknown bool of the grid's shape")
    if kit.slot_offsets.device != state.C.device:
        raise ValueError("pack3d: the kit lies on another device")


def _pack_walk(W, unknown, kit: Kit, packed: PackedStencil,
               packed16: PackedStencil, status) -> None:
    """pack3d's packing walk in PyTorch over dense weights W [S, *shape]:
    each row's kept bonds counted slot by slot, each slice's length the
    group-rounded count of its fullest row, the lengths' running sum, then
    every row's kept bonds written at the packed index of their rank and
    zeros up to its slice's length (rows past N included). ``status`` gets
    (nonzeros, overflow)."""
    n, n_slices = _pack3d_check(kit, packed, packed16, status)
    group, dev = packed.group, W.device
    Wf, unk = W.reshape(kit.S, n), unknown.reshape(n)
    inside = _inside_tables(kit, dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(kit.S):
        count += _kept(Wf, unk, kit, inside, s, s + 1)[0]
    packed.count.copy_(count.to(torch.int16))
    lens = torch.nn.functional.pad(count, (0, n_slices * SLICE - n)).view(
        n_slices, SLICE).max(1).values
    lens = (lens + (group - 1)) // group * group
    packed.slice_ptr[0] = 0
    packed.slice_ptr[1:] = lens.cumsum(0)
    status[0] = count.sum()
    capacity = min(t.numel() for t in (packed.slots, packed.values,
                                       packed16.values))
    stored = int(packed.slice_ptr[-1])
    status[1] = int(stored * SLICE > capacity)
    if stored * SLICE > capacity:
        return
    rows = torch.arange(n_slices * SLICE, device=dev)
    lane = rows % SLICE
    base = packed.slice_ptr[rows // SLICE].to(torch.int64)
    q = torch.zeros(n, dtype=torch.int64, device=dev)
    c32, c16 = lane_chunk(torch.float32, group), lane_chunk(torch.bfloat16,
                                                            group)
    for s in range(kit.S):
        node = _kept(Wf, unk, kit, inside, s, s + 1)[0].nonzero().squeeze(1)
        args = (base[node], q[node], group, lane[node])
        packed.slots[_packed_at(*args, group)] = s
        w = Wf[s, node]
        packed.values[_packed_at(*args, c32)] = w
        packed16.values[_packed_at(*args, c16)] = w.to(torch.bfloat16)
        q[node] += 1
    filled = torch.nn.functional.pad(q, (0, n_slices * SLICE - n))
    length = lens[rows // SLICE].to(torch.int64)
    for qq in range(int(length.max()) if rows.numel() else 0):
        pad = rows[(qq >= filled) & (qq < length)]
        args = (base[pad], qq, group, lane[pad])
        packed.slots[_packed_at(*args, group)] = 0
        packed.values[_packed_at(*args, c32)] = 0.0
        packed16.values[_packed_at(*args, c16)] = 0.0


def pack3d_plain(state, decay, kit: Kit, diag, unknown,
                 packed: PackedStencil, packed16: PackedStencil,
                 status) -> None:
    """pack3d's twin: the dense assembly (``ops.ard_implicit``'s
    ``_dense_weights``: the salt-blocking pass and every slot's weight over
    the whole grid) with diag and unknown copied out, then the packing
    walk (``_pack_walk``) of its W."""
    from ..ops.ard_implicit import _dense_weights
    _pack3d_check_state(state, decay, kit, diag, unknown)
    W, d, u = _dense_weights(state, kit, decay)
    diag.copy_(d)
    unknown.copy_(u)
    _pack_walk(W, u, kit, packed, packed16, status)


def _pack3d_consts(kit: Kit):
    """The dense assembly's scalar constants as the kernels take them:
    beta_lap, D_liquid, 2 D_liquid, D_gb, D_precip, D_grain, C_sat, 1e-30
    and alpha / V_H, each a double (the products formed in double, as the
    assembly's Python expressions form them) that ctypes rounds to the
    nearest float32, as PyTorch rounds a Python scalar against a float32
    tensor."""
    cfg = kit.cfg
    return (ctypes.c_float * 9)(
        kit.beta_lap, cfg.D_liquid, 2.0 * cfg.D_liquid, cfg.D_gb,
        cfg.D_precip, cfg.D_grain, cfg.C_sat, 1e-30, kit.alpha / kit.V_H)


def _mask_words(kit: Kit, n_slices: int) -> int:
    """Elements of the kept-bond mask: a 32-bit word per 32 slots of every
    row of every slice."""
    return -(-kit.S // 32) * n_slices * SLICE


def _pack3d_count(state, decay, kit: Kit, diag, unknown, count, slice_ptr,
                  status):
    """Launches 1-3 of csrc/pack3d.cu (pd_pack3d_count): code bytes, diag,
    unknown, count, slice_ptr, the nonzeros in status[0]. Returns the
    scratch the fill reads (code bytes, kept-bond mask, constants)."""
    n = math.prod(kit.shape)
    n_slices = -(-n // SLICE)
    dev = state.C.device
    if not all(t.is_contiguous() for t in (
            state.node_type, state.is_gb, state.is_precip, unknown, count,
            slice_ptr)):
        raise ValueError("pack3d: non-contiguous state or buffers")
    code = torch.empty(n, dtype=torch.uint8, device=dev)
    mask = torch.empty(_mask_words(kit, n_slices), dtype=torch.int32,
                       device=dev)
    lens = torch.empty(n_slices, dtype=torch.int32, device=dev)
    consts = _pack3d_consts(kit)
    rc = load().lib.pd_pack3d_count(
        ptr(state.node_type), ptr(state.vel), ptr(state.C), ptr(state.is_gb),
        ptr(state.is_precip), ptr(decay), ptr(kit.slot_offsets),
        ptr(kit.slot_coefs), kit.S, *kit.shape, consts, ptr(code), ptr(mask),
        ptr(diag), ptr(unknown), ptr(count), ptr(lens), ptr(slice_ptr),
        ptr(status), dev.index, stream(state.C))
    check(rc, "pack3d")
    return code, mask, consts


def _pack3d_fill(state, decay, kit: Kit, scratch, count, slice_ptr, slots,
                 values, values16, status) -> None:
    """Launch 4 of csrc/pack3d.cu (pd_pack3d_fill) into buffers of
    ``min(numel)`` entries, each 16-byte aligned."""
    code, mask, consts = scratch
    bufs = (slots, values, values16)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in bufs):
        raise ValueError("pack3d: packed buffers must be contiguous and "
                         "16-byte aligned")
    rc = load().lib.pd_pack3d_fill(
        ptr(state.vel), ptr(decay), ptr(kit.slot_offsets),
        ptr(kit.slot_coefs), kit.S, *kit.shape, consts, ptr(code), ptr(mask),
        ptr(count), ptr(slice_ptr), min(t.numel() for t in bufs), ptr(slots),
        ptr(values), ptr(values16), ptr(status), state.C.device.index,
        stream(state.C))
    check(rc, "pack3d")


def pack3d(state, decay, kit: Kit, diag, unknown, packed: PackedStencil,
           packed16: PackedStencil, status) -> None:
    """The packed 3D operator of ``state`` (a uniform 3D float32 kit's;
    ``decay`` the 0-d float32 volume-loss factor of
    ``ops.ard.micro_d_factor``) written into ``diag``, ``unknown`` and the
    buffers of ``packed`` (its count, slice_ptr, slots and float32 values)
    and ``packed16`` (the bfloat16 values; count, slice_ptr and slots
    shared with ``packed``), whose values and slots have a fixed capacity,
    with no host read and no dense W: the kernels (csrc/pack3d.cu) on
    CUDA tensors, ``pack3d_plain`` on CPU ones. ``status`` (int64 [2])
    receives the nonzeros and an overflow flag: 1 when the stored entries
    exceed the capacity, and then no value or slot is written. The same
    bytes as the dense assembly (``ops.ard_implicit._dense_operator``)
    followed by ``pack_stencil`` and ``PackedStencil.to(torch.bfloat16)``,
    up to the stored length."""
    if use_plain("pack3d", state.C, state.vel, decay, diag, packed.values,
                 status):
        return pack3d_plain(state, decay, kit, diag, unknown, packed,
                            packed16, status)
    _pack3d_check_state(state, decay, kit, diag, unknown)
    _pack3d_check(kit, packed, packed16, status)
    scratch = _pack3d_count(state, decay, kit, diag, unknown, packed.count,
                            packed.slice_ptr, status)
    _pack3d_fill(state, decay, kit, scratch, packed.count, packed.slice_ptr,
                 packed.slots, packed.values, packed16.values, status)
    pack3d.launches += 1


def pack3d_alloc(state, decay, kit: Kit):
    """pack3d into buffers sized to hold it: (diag, unknown, packed,
    packed16), the packed operator with float32 and bfloat16 values
    sharing count, slice_ptr and slots. On CUDA tensors the kernels with
    one host read between the count and the fill (the stored length and
    the nonzeros, read together); on CPU tensors the dense assembly and
    ``pack_stencil``, the same bytes."""
    if use_plain("pack3d", state.C, state.vel, decay):
        from ..ops.ard_implicit import _dense_weights
        W, diag, unknown = _dense_weights(state, kit, decay)
        packed = pack_stencil(W, unknown, kit)
        return diag, unknown, packed, packed.to(torch.bfloat16)
    _pack3d_check_state(state, decay, kit)
    dev = state.C.device
    n = math.prod(kit.shape)
    diag = torch.empty(kit.shape, dtype=torch.float32, device=dev)
    unknown = torch.empty(kit.shape, dtype=torch.bool, device=dev)
    count = torch.empty(n, dtype=torch.int16, device=dev)
    slice_ptr = torch.empty(-(-n // SLICE) + 1, dtype=torch.int32,
                            device=dev)
    status = torch.zeros(2, dtype=torch.int64, device=dev)
    scratch = _pack3d_count(state, decay, kit, diag, unknown, count,
                            slice_ptr, status)
    stored, nnz = (int(v) for v in torch.stack(
        [slice_ptr[-1].to(torch.int64), status[0]]).cpu())
    slots = torch.empty(stored * SLICE, dtype=torch.uint8, device=dev)
    values = torch.empty(stored * SLICE, dtype=torch.float32, device=dev)
    values16 = torch.empty(stored * SLICE, dtype=torch.bfloat16, device=dev)
    _pack3d_fill(state, decay, kit, scratch, count, slice_ptr, slots, values,
                 values16, status)
    pack3d.launches += 1
    packed = PackedStencil(count=count, slice_ptr=slice_ptr, slots=slots,
                           values=values, nnz=nnz)
    return diag, unknown, packed, replace(packed, values=values16)


def pack3d_dense(W, unknown, kit: Kit, packed: PackedStencil,
                 packed16: PackedStencil, status) -> None:
    """A dense W [S, *shape] float32 of the rows in ``unknown`` packed into
    pack3d's capacity buffers by pack3d's count, scan and fill, the
    weights read from W instead of formed (csrc/pack3d.cu
    pd_pack3d_dense; ``_pack_walk`` on CPU tensors): the route that
    assembled the dense W first, kept as chip_smoke.py's yardstick."""
    if (W.shape != (kit.S,) + tuple(kit.shape) or W.dtype != torch.float32
            or unknown.shape != tuple(kit.shape)
            or unknown.dtype != torch.bool):
        raise ValueError("pack3d_dense: W [S, *shape] float32 and unknown "
                         "bool of the kit's grid")
    if use_plain("pack3d_dense", W, unknown, packed.values, status):
        return _pack_walk(W, unknown, kit, packed, packed16, status)
    _, n_slices = _pack3d_check(kit, packed, packed16, status)
    bufs = (packed.slots, packed.values, packed16.values)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in bufs):
        raise ValueError("pack3d_dense: packed buffers must be contiguous "
                         "and 16-byte aligned")
    mask = torch.empty(_mask_words(kit, n_slices), dtype=torch.int32,
                       device=W.device)
    lens = torch.empty(n_slices, dtype=torch.int32, device=W.device)
    rc = load().lib.pd_pack3d_dense(
        ptr(W), ptr(unknown), ptr(kit.slot_offsets), kit.S, *kit.shape,
        ptr(mask), ptr(packed.count), ptr(lens), ptr(packed.slice_ptr),
        min(t.numel() for t in bufs), *(ptr(t) for t in bufs), ptr(status),
        W.device.index, stream(W))
    check(rc, "pack3d_dense")
    pack3d_dense.launches += 1


pack3d.launches = 0
pack3d_dense.launches = 0
