"""The uniform grid's ops over a mesh: halo exchange, then the single-rank
code on the extended slab.

Port of ``pd_mg_pin_corrosion_tpu/parallel/shard_kernels.py``. There, each
shard runs the single-device Pallas kernel on its slab with ``mext``
halo layers from ``lax.ppermute``; XLA partitions everything else. Here
every op is explicit and follows one pattern: exchange the halo rows of
the fields it reads (``halo_pairs``, one ``batch_isend_irecv`` a call),
run the unchanged single-rank op on the extended slab (the rank's kit
describes it), keep the own rows. A node's arithmetic is then the single
rank's, so the NS step, the matvecs and the BCs give the single rank's
bits; only the sums over the mesh (``sharding.all_reduce``) round
differently.

Under ``gloo`` with CUDA tensors the halo rows travel through pinned host
buffers, because gloo's send/recv takes host tensors only; under ``nccl``
the CUDA tensors go as they are.

Two-level stencils (the salt-blocking mask, itself a stencil of C and the
node types, is read at the neighbours of a bond) exchange twice: the mask
is formed on the own rows, then its halos are exchanged.
"""

from __future__ import annotations

import functools
import time
from dataclasses import fields, replace
from types import SimpleNamespace

import torch
import torch.distributed as dist

from ..fields import State
from ..grid import OUTSIDE
from .sharding import Mesh, all_reduce, own_rows

# fill of a State field beyond the domain's axial ends: the single-rank
# kernels' pad values (node types read OUTSIDE there, fields 0)
_FILL = {"node_type": OUTSIDE}


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def _host(mesh: Mesh, key, nbytes: int) -> torch.Tensor:
    """A pinned host buffer of the gloo transport, kept for the next call."""
    buf = mesh.buffers.get((key, nbytes))
    if buf is None:
        buf = mesh.buffers[(key, nbytes)] = torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=True)
    return buf


def halo_pairs(tensors: list, h: int, mesh: Mesh) -> list:
    """[(lo, hi)] a tensor: lo is the previous rank's last h rows, hi the
    next rank's first h rows, zeros at the domain's ends (JAX
    ``halo_pair``). Every tensor's edge rows travel in one byte buffer a
    direction, in one ``batch_isend_irecv``."""
    from .sharding import TRAFFIC, pack_bytes

    t0 = time.perf_counter()
    r, n = mesh.rank, mesh.size
    down, unpack = pack_bytes([t[:h] for t in tensors])   # to rank r - 1
    up, _ = pack_bytes([t[-h:] for t in tensors])         # to rank r + 1
    nbytes = down.numel()
    dev = down.device
    if mesh.staged:
        send_dn, send_up = _host(mesh, "dn", nbytes), _host(mesh, "up", nbytes)
        recv_lo, recv_hi = _host(mesh, "lo", nbytes), _host(mesh, "hi", nbytes)
        send_dn.copy_(down)
        send_up.copy_(up)
    else:
        send_dn, send_up = down, up
        recv_lo, recv_hi = torch.empty_like(down), torch.empty_like(up)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, send_dn, r - 1, mesh.group),
                dist.P2POp(dist.irecv, recv_lo, r - 1, mesh.group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, send_up, r + 1, mesh.group),
                dist.P2POp(dist.irecv, recv_hi, r + 1, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    zeros = [torch.zeros_like(t[:h]) for t in tensors]
    lo = unpack(recv_lo.to(dev)) if r > 0 else zeros
    hi = unpack(recv_hi.to(dev)) if r < n - 1 else zeros
    TRAFFIC["exchanges"] += 1
    TRAFFIC["bytes"] += nbytes * ((r > 0) + (r < n - 1))
    TRAFFIC["seconds"] += time.perf_counter() - t0
    return list(zip(lo, hi))


def halo_pair(a: torch.Tensor, h: int, mesh: Mesh):
    """(lo, hi) of one tensor (``halo_pairs``)."""
    return halo_pairs([a], h, mesh)[0]


def extend(kit, tensors: list, fills: list, exchange: bool = True) -> list:
    """The tensors (own rows) on the extended slab: the neighbours' rows
    (``exchange``) or ``fill`` (the domain's ends, and every halo row
    without ``exchange``) on each side."""
    slab = kit.slab
    mesh, h = slab.mesh, slab.h
    if exchange:
        pairs = halo_pairs(tensors, h, mesh)
    else:
        pairs = [(None, None)] * len(tensors)
    out = []
    for t, fill, (lo, hi) in zip(tensors, fills, pairs):
        edge = torch.full((h,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
        if lo is None or mesh.rank == 0:
            lo = edge
        if hi is None or mesh.rank == mesh.size - 1:
            hi = edge
        out.append(torch.cat([lo, t, hi]))
    return out


def extend_state(state: State, kit, names, exchange: bool = True) -> State:
    """A State on the extended slab holding the fields ``names`` (None for
    the others: an op that reads one fails loudly)."""
    ext = extend(kit, [getattr(state, k) for k in names],
                 [_FILL.get(k, 0) for k in names], exchange)
    out = {f.name: None for f in fields(State)}
    out.update(zip(names, ext))
    return State(**out)


def _slab_op(fn, reads, writes, band=None):
    """fn(state, kit, ...) run unchanged on the extended slab: the fields
    ``reads`` extended (exchanged, or filled when the op's band reads no
    halo row: ``Slab.local``), the fields ``writes`` kept on the own rows."""
    def op(state, kit, *args, **kw):
        exchange = band is None or band not in kit.slab.local
        out = fn(extend_state(state, kit, reads, exchange), kit, *args, **kw)
        return replace(state, **{k: own_rows(kit, getattr(out, k))
                                 for k in writes})
    op.__name__ = fn.__name__ + "_sharded"
    op.__doc__ = f"{fn.__name__} on the extended slab."
    return op


# ---------------------------------------------------------------------------
# NS
# ---------------------------------------------------------------------------

def _ns_step(state: State, kit, dt) -> State:
    from ..ops.ns import ns_step
    return ns_step(state, kit, dt)


# the unchanged ns2d / ns3d on the extended slab: rho, vel and the node
# types exchanged (act = node_type != OUTSIDE, and p = Tait(rho) is formed
# from the exchanged rho, elementwise, as the single rank forms it)
ns_step_sharded = _slab_op(_ns_step, ("rho", "vel", "node_type"),
                           ("rho", "vel", "pressure"))


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

_ARD_READS = ("C", "vel", "node_type", "is_gb", "is_precip")


def salt_blocked_ext(ext: State, kit) -> torch.Tensor:
    """The salt-blocking mask on the extended slab: formed from the
    extended fields, kept on the own rows (its halo rows would read beyond
    the slab), then its halo rows exchanged."""
    from ..ops.ard import compute_salt_blocked
    salt = own_rows(kit, compute_salt_blocked(ext, kit))
    return extend(kit, [salt], [False])[0]


def ard_step_sharded(state: State, kit, dt, volume_loss_fraction=0.0) -> State:
    """One explicit transport step (``ops.ard.ard_step``: ard2d on the
    extended slab in 2D float32, its plain twin otherwise)."""
    from ..ops.ard import ard_step
    ext = extend_state(state, kit, _ARD_READS)
    out = ard_step(ext, kit, dt, volume_loss_fraction,
                   salt=salt_blocked_ext(ext, kit))
    return replace(state, C=own_rows(kit, out.C))


def apply_phase_change_sharded(state: State, kit):
    """``ops.ard.apply_phase_change`` (elementwise) with its count summed
    over the mesh."""
    from ..ops.ard import apply_phase_change
    state, n = apply_phase_change(state, kit)
    return state, all_reduce(kit, n)


# ---------------------------------------------------------------------------
# Implicit operator
# ---------------------------------------------------------------------------

def assemble_sharded(state: State, kit, volume_loss_fraction=0.0):
    """The implicit operator of the own rows (the mesh twin of
    ``ard_implicit.assemble``): the weights formed on the extended slab
    and zeroed on its halo rows (zero weights, ``unknown`` False, as JAX
    ``matvec_M_sharded`` pads them), then finished as the single rank's
    (3D float32 on the card: packed once a cycle, ``finalize_op_sharded``).
    The returned operator's ``diag`` / ``unknown`` are the own rows, and
    ``ext`` the extended-slab operator the matvecs read."""
    from ..ops import ard_implicit as ai
    ext = extend_state(state, kit, _ARD_READS)
    W, diag, unknown = ai._dense_operator(ext, kit, volume_loss_fraction,
                                          salt=salt_blocked_ext(ext, kit))
    halo = torch.ones(kit.shape[0], dtype=torch.bool, device=kit.device)
    halo[kit.slab.own] = False
    W[:, halo] = 0.0
    diag[halo] = 0.0
    unknown[halo] = False
    op_ext = ai.ImplicitOperator(W=W, diag=diag, unknown=unknown)
    del W
    return finalize_op_sharded(op_ext, kit)


def finalize_op_sharded(op_ext, kit):
    """The sharded operator of an extended-slab one (dense weights,
    finished in place): in 3D float32 the bf16 copy of W and, on the card,
    both packed on the extended slab (JAX ``finalize_op_sharded``: the
    per-shard weight layout), as ``ard_implicit.finish_operator`` does for
    one rank."""
    from ..ops import ard_implicit as ai
    ext = ai.finish_operator(op_ext, kit)
    return ai.ImplicitOperator(W=ext.W, diag=own_rows(kit, ext.diag),
                               unknown=own_rows(kit, ext.unknown),
                               W16=ext.W16, packed=ext.packed, ext=ext)


def matvec_M_sharded(op, kit, x, W=None):
    """M x on the own rows: x's halo rows exchanged, the unchanged matvec
    (matvec2d / matvec3d on the card) on the extended slab."""
    from ..ops.ard_implicit import matvec_M
    x_ext = extend(kit, [x], [0.0])[0]
    return own_rows(kit, matvec_M(op.ext, kit, x_ext, W))


def matvec_M64_sharded(op, kit, x64):
    """The f64 refinement residual's operator: x64's halo rows exchanged
    in float64, the slot sum (slots3d_f64 on the card) on the extended
    slab."""
    from ..ops.ard_implicit import matvec_M64
    x_ext = extend(kit, [x64], [0.0])[0]
    return own_rows(kit, matvec_M64(op.ext, kit, x_ext))


# ---------------------------------------------------------------------------
# The ops namespace of a sharded kit (dispatch.ops_for)
# ---------------------------------------------------------------------------

@functools.cache
def sharded_ops() -> SimpleNamespace:
    from .. import boundary as bc
    from ..ops import ard, ard_implicit as ai, ns

    state_rw = ("rho", "vel", "C", "node_type")
    return SimpleNamespace(
        ns_step=ns_step_sharded,
        compute_dt_ns=ns.compute_dt,   # v_max all-reduced (MAX: exact)
        tait_pressure=ns.tait_pressure,
        apply_inlet_bc=_slab_op(bc.apply_inlet_bc, state_rw,
                                ("rho", "vel", "C"), "inlet"),
        apply_outlet_bc=_slab_op(bc.apply_outlet_bc, state_rw,
                                 ("rho", "vel", "C"), "outlet"),
        apply_wall_bc=_slab_op(bc.apply_wall_bc, ("rho", "vel"),
                               ("rho", "vel"), "wall"),
        apply_wall_concentration_bc=_slab_op(
            bc.apply_wall_concentration_bc, ("C", "node_type"), ("C",)),
        apply_solid_surface_bc=bc.apply_solid_surface_bc,  # elementwise
        smooth_boundary_concentration=_slab_op(
            bc.smooth_boundary_concentration, ("C", "node_type"), ("C",),
            "smooth"),
        update_fictitious=lambda state, kit: state,
        ard_step=ard_step_sharded,
        ard_compute_dt=ard.compute_dt,
        apply_phase_change=apply_phase_change_sharded,
        assemble=ai.assemble,          # assemble_sharded on a slab
        linear_system=ai.linear_system,
        compute_adaptive_dt=ai.compute_adaptive_dt,
    )
