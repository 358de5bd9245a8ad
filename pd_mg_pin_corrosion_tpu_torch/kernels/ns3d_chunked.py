"""ns3d_chunked / ns3d_jstat — the slot-chunked and j-static variants of the
3D PD-NS step: CUDA kernel wrappers and plain twins.

Kernel: ``csrc/ns3d_chunked.cu``, four forms of one template (replaces
``_ns_kernel_chunked`` / ``ns_step_chunked`` and ``_ns_kernel_jstat`` /
``ns_step_jstat`` of ``scripts/exp_ns3d_chunked.py``):

* ``ns3d_chunked(..., factored=False)``: the XLA form, per-bond f_j - f_i;
* ``factored=True``: the momentum-convection factoring;
* ``factored="jconv"``: j-side sums plus the pure-act sums B2, B summed in
  the kernel, the i-side terms once at the end;
* ``ns3d_jstat``: pre-masked fields, the pure-act sums an input
  (``compute_actconv``).

What sets the numbers is the chunking: the (dj, di) slot groups, in
``kit.ns_slots`` order, split into ``nchunk`` contiguous chunks balanced by
slot count (``group_chunks``, the script's ``_group_chunks``). Per chunk
each accumulator starts at zero and sums the chunk's slots in order, and is
then added into the running sum. ``bz`` is the thread block's z extent (the
TPU kernel's VMEM block height) and does not change the numbers. The twins
evaluate the FLUID nodes only, over slot ranges that hold at most
``kit.SLOT_CHUNK_ELEMS`` gathered elements, as ``ns3d_plain`` does.
"""

from __future__ import annotations

import weakref

import torch

from ..grid import FLUID, OUTSIDE
from ..kit import Kit
from .build import check, load, ptr, stream, use_plain
from .ns3d import _constants

FORMS = ("xla", "factored", "jconv", "jstat")
_FACTORED = {False: "xla", True: "factored", "jconv": "jconv"}
_NACC = {"xla": 11, "factored": 11, "jconv": 15, "jstat": 11}
_TABLES: "weakref.WeakKeyDictionary[Kit, dict]" = weakref.WeakKeyDictionary()


def group_chunks(kit: Kit, nchunk: int):
    """Contiguous split of the (dj, di) groups into nchunk chunks, balanced
    by slot count: a list of chunks, each a list of ((dj, di), [(dk, xi, e,
    vol), ...]) (the script's ``_group_chunks``)."""
    groups = {}
    for s, xi, e_ij, vol in kit.bond_iter():
        dk, dj, di = kit.offsets[s]
        groups.setdefault((dj, di), []).append(
            (dk, float(xi), tuple(map(float, e_ij)), float(vol)))
    items = list(groups.items())
    per = sum(len(v) for _, v in items) / nchunk
    chunks, cur, acc = [], [], 0.0
    for it in items:
        cur.append(it)
        acc += len(it[1])
        if acc >= per * (len(chunks) + 1) and len(chunks) < nchunk - 1:
            chunks.append(cur)
            cur = []
    chunks.append(cur)
    assert len(chunks) == nchunk and sum(len(c) for c in chunks) == len(items)
    return chunks


def _tables(kit: Kit, dtype, nchunk: int):
    """(coefs [10, S], chunk_end [nchunk] int32) on the kit's device, in
    kit.ns_slots order. coefs rows: vol, 1/xi, 1/xi^2, e_x, e_y, e_z (the
    XLA form's constants) and vol/xi^2, e_x vol/xi, e_y vol/xi, e_z vol/xi
    (the others'), each formed in float64 and rounded once, as the script's
    Python-float constants are."""
    per_kit = _TABLES.setdefault(kit, {})
    key = (dtype, nchunk)
    if key not in per_kit:
        cols = []
        for s in kit.ns_slots.tolist():
            xi, vol, e = kit.dist[s], kit.vol[s], kit.evec[s]
            inv = 1.0 / xi
            cols.append([vol, inv, inv * inv, *e, vol / (xi * xi),
                         *(ed * (vol / xi) for ed in e)])
        ends, n = [], 0
        for chunk in group_chunks(kit, nchunk):
            n += sum(len(slots) for _, slots in chunk)
            ends.append(n)
        per_kit[key] = (
            torch.tensor(cols, dtype=torch.float64).T.contiguous().to(
                device=kit.device, dtype=dtype),
            torch.tensor(ends, dtype=torch.int32, device=kit.device))
    return per_kit[key]


def compute_actconv(kit: Kit, node_type) -> torch.Tensor:
    """[4, Nz, Ny, Nx] (B2, Bx, By, Bz): the pure-act stencil sums, in
    stencil order in the run dtype (the script's ``compute_actconv``)."""
    act = (node_type != OUTSIDE).to(kit.dtype)
    ap = kit.pad(act, 0.0)
    B2 = torch.zeros(kit.shape, dtype=kit.dtype, device=act.device)
    B = [B2, B2, B2]
    for s, xi, e_ij, vol in kit.bond_iter():
        a_s = kit.shift(ap, s)
        c1 = vol / xi
        B2 = B2 + vol / (xi * xi) * a_s
        for d in range(3):
            if e_ij[d] != 0.0:
                B[d] = B[d] + (e_ij[d] * c1) * a_s
    return torch.stack([B2] + B)


def _terms(form, g, c, r, v, pi):
    """[NACC, slots, rows] per-bond terms of one slot range: g the gathered
    neighbour fields, c the coefficient rows [10, slots, 1], (r, v, pi) the
    centre's rho, vel and p. The script's expressions, zero e components
    included (an exact +-0)."""
    vol, ixi, ixi2, ex, ey, ez, c2, etx, ety, etz = c
    if form == "jstat":   # pre-masked fields, no act
        R, VX, VY, VZ, P = g
    else:
        R, VX, VY, VZ, P, ACT = g
    VJ, e, et = (VX, VY, VZ), (ex, ey, ez), (etx, ety, etz)
    fdj = ((R * VX) * etx + (R * VY) * ety) + (R * VZ) * etz
    if form == "xla":
        V = vol * ACT
        fd = (((R * VX - r * v[0]) * ex + (R * VY - r * v[1]) * ey)
              + (R * VZ - r * v[2]) * ez)
        conv = [(((R * VJ[d] * VX - r * v[d] * v[0]) * ex
                  + (R * VJ[d] * VY - r * v[d] * v[1]) * ey)
                 + (R * VJ[d] * VZ - r * v[d] * v[2]) * ez) * ixi * V
                for d in range(3)]
        return torch.stack([fd * ixi * V, (R - r) * ixi2 * V, *conv,
                            *((P - pi) * e[d] * ixi * V for d in range(3)),
                            *((VJ[d] - v[d]) * ixi2 * V for d in range(3))])
    if form == "factored":
        m = [r * v[d] for d in range(3)]
        fdi = (m[0] * etx + m[1] * ety) + m[2] * etz
        w2 = c2 * ACT
        dpw = (P - pi) * ACT
        return torch.stack([(fdj - fdi) * ACT, (R - r) * w2,
                            *((VJ[d] * fdj - v[d] * fdi) * ACT
                              for d in range(3)),
                            *(dpw * et[d] for d in range(3)),
                            *((VJ[d] - v[d]) * w2 for d in range(3))])
    if form == "jconv":
        w2 = c2 * ACT
        u = [et[d] * ACT for d in range(3)]
        fdjw = fdj * ACT
        return torch.stack([fdjw, R * w2, w2, *u,
                            *(VJ[d] * fdjw for d in range(3)),
                            *(P * u[d] for d in range(3)),
                            *(VJ[d] * w2 for d in range(3))])
    return torch.stack([fdj, R * c2, *(VJ[d] * fdj for d in range(3)),
                        *(P * et[d] for d in range(3)),
                        *(VJ[d] * c2 for d in range(3))])


def _plain(form, rho, vel, p, node_type, dt, kit: Kit, nchunk, actconv):
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    rows = (node_type == FLUID).reshape(-1).nonzero().squeeze(1)
    pidx = kit.padded_index(rows)
    act = (node_type != OUTSIDE).to(rho.dtype)
    fields = [rho, *(vel[..., d] for d in range(3)), p]
    if form == "jstat":
        pads = [kit.pad(f * act, 0.0).reshape(-1) for f in fields]
    else:
        pads = [kit.pad(f, 0.0).reshape(-1) for f in fields + [act]]

    def at(f):
        return f.reshape(-1)[rows]

    r, pi, v = at(rho), at(p), [at(vel[..., d]) for d in range(3)]
    coefs, ends = _tables(kit, rho.dtype, nchunk)
    step = kit.slot_chunks(rows.numel())[0][1]
    acc = torch.zeros((_NACC[form], rows.numel()), dtype=rho.dtype,
                      device=rho.device)
    c0 = 0
    for c1 in ends.tolist():
        part = torch.zeros_like(acc)
        for s0 in range(c0, c1, step):
            s1 = min(s0 + step, c1)
            idx = pidx[None, :] + kit.slot_flat[kit.ns_slots[s0:s1], None]
            T = _terms(form, [f[idx] for f in pads], coefs[:, s0:s1, None],
                       r, v, pi)
            for s in range(s1 - s0):
                part = part + T[:, s]
        acc = acc + part
        c0 = c1

    if form in ("xla", "factored"):
        mc, md = acc[0], acc[1]
        conv, pres, vis = acc[2:5], acc[5:8], acc[8:11]
    else:
        if form == "jconv":
            B2, B = acc[2], acc[3:6]
            conv, pres, vis = acc[6:9], acc[9:12], acc[12:15]
        else:
            B2, *B = actconv.reshape(4, -1)[:, rows]
            conv, pres, vis = acc[2:5], acc[5:8], acc[8:11]
        F = (r * v[0] * B[0] + r * v[1] * B[1]) + r * v[2] * B[2]
        mc, md = acc[0] - F, acc[1] - r * B2
        conv = [conv[d] - v[d] * F for d in range(3)]
        pres = [pres[d] - pi * B[d] for d in range(3)]
        vis = [vis[d] - v[d] * B2 for d in range(3)]
    rho_new = torch.clamp(r + dt * (-a * mc + dens * md), rho_lo, rho_hi)
    scale = dt * (1.0 / r)
    vel_new = torch.stack([v[d] + scale * (-a * (conv[d] + pres[d])
                                           + visc * vis[d])
                           for d in range(3)], dim=-1)
    rho_out, vel_out = rho.clone(), vel.clone()
    rho_out.view(-1)[rows] = rho_new
    vel_out.view(-1, 3)[rows] = vel_new
    return rho_out, vel_out


def ns3d_chunked_plain(rho, vel, p, node_type, dt, kit: Kit, nchunk=6,
                       factored=True):
    """(rho_new, vel_new) of one 3D PD-NS step in the chunked form chosen
    by ``factored`` (False, True or "jconv"); every node that is not FLUID
    keeps its input value. ``p`` is Tait(rho); ``dt`` a 0-d tensor."""
    return _plain(_FACTORED[factored], rho, vel, p, node_type, dt, kit,
                  nchunk, None)


def ns3d_jstat_plain(rho, vel, p, node_type, dt, kit: Kit, actconv,
                     nchunk=6):
    """ns3d_chunked_plain's contract in the j-static form, with the
    pure-act sums ``actconv`` (``compute_actconv``) as an input."""
    return _plain("jstat", rho, vel, p, node_type, dt, kit, nchunk, actconv)


def _launch(form, rho, vel, p, node_type, dt, kit: Kit, nchunk, bz,
            actconv):
    if node_type.dtype != torch.uint8 or dt.numel() != 1:
        raise TypeError(f"ns3d_{form}: node_type must be uint8 and dt a scalar")
    if (kit.dim != 3 or rho.shape != kit.shape
            or vel.shape != kit.shape + (3,) or p.shape != kit.shape
            or (actconv is not None and actconv.shape != (4,) + kit.shape)):
        raise ValueError(f"ns3d_{form}: shapes do not match the grid "
                         f"{kit.shape}")
    if not (1 <= bz <= 64 and 256 % bz == 0) or not 1 <= nchunk <= 64:
        raise ValueError(f"ns3d_{form}: bz must divide 256 and be <= 64, "
                         f"nchunk in 1..64 (got {bz}, {nchunk})")
    dens, a, visc, rho_lo, rho_hi = _constants(kit)
    coefs, ends = _tables(kit, torch.float32, nchunk)
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    nz, ny, nx = kit.shape
    rc = load().lib.pd_ns3d_chunked(
        FORMS.index(form), ptr(rho), ptr(vel), ptr(p), ptr(node_type),
        None if actconv is None else ptr(actconv), ptr(dt),
        ptr(kit.ns_offsets), ptr(coefs), ptr(ends), nchunk, kit.S, nz, ny, nx,
        bz, dens, a, visc, rho_lo, rho_hi, ptr(rho_out), ptr(vel_out),
        rho.device.index, stream(rho))
    check(rc, f"ns3d_{form}")
    return rho_out, vel_out


def ns3d_chunked(rho, vel, p, node_type, dt, kit: Kit, nchunk=6, bz=16,
                 factored=True):
    """ns3d_chunked_plain's contract: the kernel on CUDA float32 tensors,
    the plain version on CPU tensors. Launches are counted per form, in
    ``launches_xla``, ``launches_factored`` and ``launches_jconv``."""
    form = _FACTORED[factored]
    if use_plain("ns3d_chunked", rho, vel, p, node_type, dt):
        return _plain(form, rho, vel, p, node_type, dt, kit, nchunk, None)
    out = _launch(form, rho, vel, p, node_type, dt, kit, nchunk, bz, None)
    name = f"launches_{form}"
    setattr(ns3d_chunked, name, getattr(ns3d_chunked, name) + 1)
    return out


def ns3d_jstat(rho, vel, p, node_type, dt, kit: Kit, actconv, nchunk=6,
               bz=16):
    """ns3d_jstat_plain's contract: the kernel on CUDA float32 tensors, the
    plain version on CPU tensors."""
    if use_plain("ns3d_jstat", rho, vel, p, node_type, dt, actconv):
        return _plain("jstat", rho, vel, p, node_type, dt, kit, nchunk,
                      actconv)
    out = _launch("jstat", rho, vel, p, node_type, dt, kit, nchunk, bz,
                  actconv)
    ns3d_jstat.launches += 1
    return out


ns3d_chunked.launches_xla = 0
ns3d_chunked.launches_factored = 0
ns3d_chunked.launches_jconv = 0
ns3d_jstat.launches = 0
