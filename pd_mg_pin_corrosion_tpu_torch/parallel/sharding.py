"""Axial-slab domain decomposition over ``torch.distributed``.

Port of ``pd_mg_pin_corrosion_tpu/parallel/sharding.py``. Every per-node
field is split along the leading (axial) array axis (y in 2D, z in 3D),
one slab a rank. The PD horizon reaches m rows, so a rank's stencil ops
need only ``mext = m + 1`` rows of each neighbour: the rank's kit describes
its *extended slab* (own rows plus ``h = mext`` halo rows a side), and the
ops exchange those halo rows before they run the single-rank code on it
(``shard_kernels``). The State a rank holds is its own rows. Global scalars
(v_max, the convergence eps, GMRES's dots, the diagnostics) become
all-reduces.

JAX leaves the halos and reductions to XLA's SPMD partitioner; PyTorch has
none, so they are explicit here. Two departures from the JAX module:

* ``make_mesh`` never falls back to other devices: NCCL with fewer cards
  than ranks, or no process group, raises;
* the checkpoint and the snapshots are written by rank 0 from
  ``gather_state``, so a checkpoint is the single-rank file.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields

import numpy as np
import torch
import torch.distributed as dist

from ..fields import State, resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh over the axial axis: this process's rank among ``size``,
    the process group, the transport (``nccl`` or ``gloo``) and the device
    the rank's tensors live on. ``group`` None is a mesh that only slices
    (no exchange may run on it)."""
    rank: int
    size: int
    group: object
    backend: str
    device: torch.device
    # pinned host buffers of the gloo transport, by purpose and size
    buffers: dict = field(default_factory=dict, repr=False)

    @property
    def staged(self) -> bool:
        """Whether halos and reductions travel through host memory: gloo's
        send/recv takes host tensors only."""
        return self.backend == "gloo" and self.device.type == "cuda"


@dataclass(frozen=True, eq=False)
class Slab:
    """One rank's rows of the global grid, carried by its kit."""
    mesh: Mesh
    h: int          # halo rows a side
    row0: int       # global index of the first own row
    rows: int       # own rows
    n_global: int   # rows of the (padded) global grid
    # banded ops whose own-row nodes read no halo row: they run on the
    # extended slab with the halos filled, not exchanged
    local: frozenset

    @property
    def own(self) -> slice:
        """The own rows in the extended slab."""
        return slice(self.h, self.h + self.rows)

    @property
    def global_rows(self) -> slice:
        """The own rows in the global grid."""
        return slice(self.row0, self.row0 + self.rows)


# what the mesh moved in this process since reset_traffic(): halo
# exchanges (one batch_isend_irecv each), the bytes this rank sent in them,
# the host seconds they took (staging included), and all-reduces
TRAFFIC = {"exchanges": 0, "bytes": 0, "seconds": 0.0, "all_reduces": 0}


def reset_traffic() -> None:
    TRAFFIC.update(exchanges=0, bytes=0, seconds=0.0, all_reduces=0)


def make_mesh(n: int | None = None, backend: str | None = None,
              device=None) -> Mesh:
    """The 1-D mesh over the process group of this process.

    ``backend`` (default ``nccl``) must be the initialised group's; without
    one, a torchrun launch (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` in the
    environment) initialises it. ``device`` defaults to ``cuda:<local
    rank>`` under NCCL and to ``cuda`` under gloo (every rank on one card);
    pass ``device="cpu"`` with gloo on the CPU. Raises when NCCL is asked
    for with fewer visible cards than ranks, when there is no group, or
    when ``n`` is not the group's size."""
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend must be nccl or gloo, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                              "MASTER_ADDR")):
            raise RuntimeError(
                "make_mesh: no process group is initialised (launch with "
                "torchrun, or through parallel.launch.spawn)")
        _check_backend(backend, int(os.environ["WORLD_SIZE"]))
        dist.init_process_group(backend, init_method="env://")
    size, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, not {backend}")
    _check_backend(backend, size)
    if n is not None and n != size:
        raise ValueError(f"make_mesh: asked for {n} ranks, the process "
                         f"group has {size}")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local}" if backend == "nccl" else "cuda"
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: NCCL moves CUDA tensors only")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank=rank, size=size, group=dist.group.WORLD,
                backend=backend, device=device)


def _check_backend(backend: str, size: int) -> None:
    if backend != "nccl":
        return
    if not dist.is_nccl_available():
        raise RuntimeError("make_mesh: this PyTorch has no NCCL")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < size:
        raise RuntimeError(
            f"make_mesh: NCCL needs a card a rank, {size} ranks and {cards} "
            f"visible card(s) (NCCL refuses two ranks on one device; use "
            f"backend=\"gloo\" to share one)")


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def rows_of(n_global: int, mesh: Mesh) -> tuple:
    """(row0, rows): this rank's own rows of an n_global-row grid."""
    if n_global % mesh.size:
        raise ValueError(
            f"the grid's {n_global} axial rows do not split into {mesh.size} "
            f"equal slabs (pad it: grid.pad_grid_axial(grid, {mesh.size}))")
    rows = n_global // mesh.size
    return mesh.rank * rows, rows


def shard_state(state: State, mesh: Mesh) -> State:
    """This rank's slab of a global State (host or device tensors), on the
    mesh's device."""
    row0, rows = rows_of(state.rho.shape[0], mesh)
    return State(**{f.name: getattr(state, f.name)[row0:row0 + rows]
                    .to(mesh.device).clone() for f in fields(State)})


def gather_state(state: State, mesh: Mesh) -> State | None:
    """The global State on rank 0 (None on the other ranks), on the
    state's device: one gather of every field's rows."""
    names = [f.name for f in fields(State)]
    parts = gather_rows([getattr(state, k) for k in names], mesh)
    if parts is None:
        return None
    return State(**dict(zip(names, parts)))


def gather_rows(tensors: list, mesh: Mesh) -> list | None:
    """Each tensor's rows from every rank, concatenated in rank order, on
    rank 0 (None elsewhere); the tensors travel as one byte buffer."""
    if mesh.size == 1:
        return list(tensors)
    buf, unpack = pack_bytes(tensors)
    dev = buf.device
    send = buf.cpu() if mesh.staged else buf
    got = ([torch.empty_like(send) for _ in range(mesh.size)]
           if mesh.rank == 0 else None)
    dist.gather(send, got, dst=0, group=mesh.group)
    if mesh.rank != 0:
        return None
    per_rank = [unpack(b.to(dev)) for b in got]
    return [torch.cat([p[i] for p in per_rank]) for i in range(len(tensors))]


def pack_bytes(tensors: list):
    """(buffer, unpack): the tensors' bytes in one uint8 tensor, widest
    element type first (so every field starts aligned for its type), and
    the function that turns such a buffer back into tensors of the same
    shapes and dtypes."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    meta = [(tensors[i].shape, tensors[i].dtype, tensors[i].numel()
             * tensors[i].element_size()) for i in order]
    buf = torch.cat([tensors[i].contiguous().reshape(-1).view(torch.uint8)
                     for i in order])

    def unpack(b):
        out, at = [None] * len(order), 0
        for i, (shape, dtype, nbytes) in zip(order, meta):
            out[i] = b[at:at + nbytes].view(dtype).view(shape)
            at += nbytes
        return out
    return buf, unpack


# ---------------------------------------------------------------------------
# Kit
# ---------------------------------------------------------------------------

def shard_kit(kit, mesh: Mesh):
    """This rank's kit: the global uniform-grid Kit's per-node arrays cut to
    the extended slab (own rows plus h = mext halo rows a side, filled as
    OUTSIDE / 0 / False beyond the domain), its flat gather indices
    remapped into the slab, its axial bands localised, on the mesh's
    device. ``actconv3d`` is sliced from the global precompute: computed
    on a slab it would miss the bonds that cross the slab's ends.

    Raises for what the mesh does not carry: AMR kits, gs_parity,
    flow_warm_start, a slab thinner than its halo, a mirror or sub-cell
    source beyond the halo, and an inlet or outlet band that does not lie
    within one rank's own rows."""
    from ..kit import Kit

    if not isinstance(kit, Kit):
        raise NotImplementedError(
            f"shard_kit: only the uniform grid's Kit is sharded, not "
            f"{type(kit).__name__} (AMR under a mesh is not ported)")
    cfg = kit.cfg
    if kit.gs is not None:
        raise NotImplementedError("shard_kit: gs_parity replays sequential "
                                  "sweeps over the whole band; not sharded")
    if cfg.flow_warm_start:
        raise NotImplementedError("shard_kit: flow_warm_start is not sharded")
    if kit.slab is not None:
        raise ValueError("shard_kit: the kit is already a slab's")
    resolve_device(mesh.device)
    N = kit.shape[0]
    row0, rows = rows_of(N, mesh)
    h = kit.mext
    if rows < h:
        raise ValueError(f"shard_kit: a slab of {rows} rows is thinner than "
                         f"its halo of {h} rows ({N} rows over {mesh.size} "
                         f"ranks)")
    if kit.inlet_rows > rows:
        raise ValueError(f"shard_kit: the inlet band [0, {kit.inlet_rows}) "
                         f"spans more than rank 0's {rows} rows")
    if N - kit.outlet_rows > rows:
        raise ValueError(f"shard_kit: the outlet band [{kit.outlet_rows}, "
                         f"{N}) spans more than the last rank's {rows} rows")
    lo, hi = row0 - h, row0 + rows + h
    ext_rows = rows + 2 * h
    plane = int(np.prod(kit.shape[1:]))
    dev = mesh.device

    def cut(t, fill, axis=0):
        """t's rows [lo, hi) along ``axis``, ``fill`` beyond the domain."""
        t = t.movedim(axis, 0)
        out = torch.full((ext_rows,) + tuple(t.shape[1:]), fill,
                         dtype=t.dtype, device=t.device)
        a, b = max(lo, 0), min(hi, N)
        out[a - lo:b - lo] = t[a:b]
        return out.movedim(0, axis).contiguous().to(dev)

    # the wall mirror: own-row wall nodes keep their source, remapped into
    # the slab; halo rows carry none (their results are dropped)
    src = kit.mirror_src.reshape(-1).cpu().numpy()
    has = kit.mirror_mask.reshape(-1).cpu().numpy()
    dst_row = np.arange(src.size) // plane
    src_row = src // plane
    reach = int(np.abs(src_row - dst_row)[has].max()) if has.any() else 0
    if reach > h:
        raise ValueError(f"shard_kit: a wall-mirror source lies {reach} rows "
                         f"from its node, beyond the halo of {h}")
    ext_idx = np.arange(ext_rows * plane, dtype=np.int64)
    ext_src = ext_idx.copy()
    g = np.arange(max(lo, 0) * plane, min(hi, N) * plane)   # global nodes
    own_g = g[(g // plane >= row0) & (g // plane < row0 + rows)]
    keep = own_g[has[own_g]]
    ext_src[keep - lo * plane] = src[keep] - lo * plane
    own_mask = np.zeros(ext_rows * plane, bool)
    own_mask[h * plane:(h + rows) * plane] = True
    shape_ext = (ext_rows,) + tuple(kit.shape[1:])

    def own_only(t):
        return cut(t, False) & torch.as_tensor(
            own_mask.reshape(shape_ext), device=dev)

    # the sub-cell mirror: own-row destinations, sources in the slab
    sub_dst, sub_src, sub_w = (kit.mirror_sub_dst.cpu(),
                               kit.mirror_sub_src.cpu(),
                               kit.mirror_sub_w.cpu())
    if sub_dst.numel():
        d_row = sub_dst // plane
        mine = (d_row >= row0) & (d_row < row0 + rows)
        sub_dst, sub_src, sub_w = sub_dst[mine], sub_src[:, mine], sub_w[:, mine]
        s_row = sub_src // plane
        if bool(((s_row < lo) | (s_row >= hi)).any()):
            raise ValueError("shard_kit: a wall_mirror_subcell source lies "
                             "beyond the halo")
        sub_dst, sub_src = sub_dst - lo * plane, sub_src - lo * plane

    local = _local_bands(kit, reach, row0, rows, mesh.size)
    if kit.inlet_rows == 0:
        inlet_rows = 0
    else:
        inlet_rows = h + kit.inlet_rows if mesh.rank == 0 else 0
    last = mesh.rank == mesh.size - 1
    outlet_rows = (kit.outlet_rows - lo if last and kit.outlet_rows < N
                   else ext_rows)
    act3d = (cut(kit.actconv3d, 0.0, axis=1) if kit.dim == 3
             else kit.actconv3d.to(dev))
    return dataclasses.replace(
        kit,
        inlet_mask=cut(kit.inlet_mask, False),
        outlet_mask=cut(kit.outlet_mask, False),
        wall_mask=cut(kit.wall_mask, False),
        near_inlet_mask=cut(kit.near_inlet_mask, False),
        near_outlet_mask=cut(kit.near_outlet_mask, False),
        v_pois=cut(kit.v_pois, 0.0),
        initial_solid_mask=cut(kit.initial_solid_mask, False),
        mirror_mask=own_only(kit.mirror_mask),
        mirror_src=torch.as_tensor(ext_src.reshape(shape_ext), device=dev),
        mirror_none_mask=own_only(kit.mirror_none_mask),
        slot_offsets=kit.slot_offsets.to(dev),
        slot_coefs=kit.slot_coefs.to(dev),
        slot_index=kit.slot_index.to(dev),
        slot_flat=kit.slot_flat.to(dev),
        ns_slots=kit.ns_slots.to(dev),
        ns_offsets=kit.ns_offsets.to(dev),
        ns_coefs=kit.ns_coefs.to(dev),
        actconv3d=act3d,
        mirror_sub_dst=sub_dst.to(dev),
        mirror_sub_src=sub_src.to(dev),
        mirror_sub_w=sub_w.to(dev),
        shape=shape_ext,
        device=dev,
        inlet_rows=inlet_rows,
        outlet_rows=outlet_rows,
        slab=Slab(mesh=mesh, h=h, row0=row0, rows=rows, n_global=N,
                  local=local))


def _local_bands(kit, mirror_reach: int, row0: int, rows: int,
                 size: int) -> frozenset:
    """The banded ops ("inlet", "outlet", "smooth", "wall") whose own-row
    nodes, on every rank, read only rows of their own rank or rows beyond
    the domain: those need no halo exchange. Decided from the global
    geometry, so every rank decides alike."""
    N = kit.shape[0]
    reach = max(abs(o[0]) for o in kit.offsets)
    rest = tuple(range(1, kit.dim))
    near = (kit.near_inlet_mask | kit.near_outlet_mask).any(dim=rest)
    bands = {
        "inlet": np.arange(kit.inlet_rows),
        "outlet": np.arange(kit.outlet_rows, N),
        "smooth": np.flatnonzero(near.cpu().numpy()),
    }
    local = {"wall"} if mirror_reach == 0 else set()
    for name, band in bands.items():
        ok = True
        for r in range(size):
            a, b = r * rows, (r + 1) * rows
            mine = band[(band >= a) & (band < b)]
            if mine.size and (max(int(mine.min()) - reach, 0) < a
                              or min(int(mine.max()) + reach, N - 1) >= b):
                ok = False
        if ok:
            local.add(name)
    return frozenset(local)


def own_rows(kit, t: torch.Tensor) -> torch.Tensor:
    """t (a per-node array of the kit's extended slab) cut to the own rows;
    t itself on a kit without a slab."""
    slab = getattr(kit, "slab", None)
    return t if slab is None else t[slab.own]


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def all_reduce(kit, tensors, op: str = "sum"):
    """The tensors reduced over the mesh (``op`` "sum", "max" or "min"),
    each in its own dtype and on its own device; as they are on a kit
    without a slab. One all-reduce in float64 carries them all (int64
    counts and float32 values are exact in it; the sum is then rounded
    once to the field's dtype)."""
    slab = getattr(kit, "slab", None)
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    if slab is None or slab.mesh.size == 1:
        return tensors
    mesh = slab.mesh
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts])
    if mesh.staged:
        flat = flat.cpu()
    if op == "min":
        flat = -flat
    dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    TRAFFIC["all_reduces"] += 1
    if op == "min":
        flat = -flat
    out, at = [], 0
    for t in ts:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(device=t.device,
                                                    dtype=t.dtype))
        at += n
    return out[0] if single else out


def reducer(kit):
    """A float64 sum over the mesh for GMRES's dots and norms (None on a
    kit without a slab: the single rank's path runs unchanged)."""
    slab = getattr(kit, "slab", None)
    if slab is None:
        return None
    return lambda t: all_reduce(kit, t, "sum")
