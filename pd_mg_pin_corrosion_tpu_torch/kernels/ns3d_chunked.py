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
then added into the running sum. ``bz`` (8, 16 or 32) is the z extent of
the kernel's staged tile (the TPU kernel's VMEM block height) and does not
change the numbers. The twins evaluate the FLUID nodes only, over slot
ranges that hold at most ``kit.SLOT_CHUNK_ELEMS`` gathered elements, as
``ns3d_plain`` does. The kernel stages masked planar tiles (and act) in
shared memory and walks the stencil's runs along z for several nodes a
thread, ns3d's design; ``ns3d_chunked_tables`` builds its slot table and
``ns3d_chunked_staged_plain`` is that walk in PyTorch, equal to each form's
twin bit for bit for finite inputs.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import torch

from ..grid import FLUID, OUTSIDE
from ..kit import Kit
from .build import check, load, ptr, stream, use_plain
from .ns3d import HALO, Ns3dGeometry, _constants, ns3d_tables

FORMS = ("xla", "factored", "jconv", "jstat")
# the z extents of the kernel's staged tile (the ladder's BZ rungs)
BZ_RUNGS = (8, 16, 32)
_FACTORED = {False: "xla", True: "factored", "jconv": "jconv"}
_NACC = {"xla": 11, "factored": 11, "jconv": 15, "jstat": 11}
_TABLES: "weakref.WeakKeyDictionary[Kit, dict]" = weakref.WeakKeyDictionary()
# {kit: {(form, bz, nchunk): Ns3dChunkedTables}} for the loaded library
_STAGED: "weakref.WeakKeyDictionary[Kit, dict]" = weakref.WeakKeyDictionary()


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
    return _finish(form, acc, rows, rho, vel, p, dt, kit, actconv)


def _finish(form, acc, rows, rho, vel, p, dt, kit: Kit, actconv):
    """The update of the FLUID nodes ``rows`` (flat indices) from their
    accumulators ``acc`` [NACC, len(rows)]: the i-side terms of the j-side
    forms, the clamp, the copy-through of every other node."""
    dens, a, visc, rho_lo, rho_hi = _constants(kit)

    def at(f):
        return f.reshape(-1)[rows]

    r, pi, v = at(rho), at(p), [at(vel[..., d]) for d in range(3)]
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


# ---------------------------------------------------------------------------
# the staged form the CUDA kernel computes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ns3dChunkedTables:
    """The kernel's slot table for one kit, form, chunking and tile."""
    # [S] int32: (dk + HALO) plane + (dj + HALO) pitch + di + HALO
    offsets: torch.Tensor
    # [S, 4] float32: vol/xi^2, e vol/xi (the XLA form [S, 8]: 1/xi,
    # 1/xi^2, e_x, e_y, e_z, vol, 0, 0)
    coefs: torch.Tensor
    # [nruns, 2] int32: (first slot, length)
    runs: torch.Tensor
    # [nchunk] int32: the run after each chunk's last
    chunk_end: torch.Tensor


def ns3d_chunked_tables(kit: Kit, form: str, nchunk: int, pitch: int,
                        plane: int) -> Ns3dChunkedTables:
    """The slot table of csrc/ns3d_chunked.cu for one form and chunking on
    a tile whose rows lie ``pitch`` floats apart and whose z planes
    ``plane``: ns3d's offsets and runs (``ns3d_tables``; it refuses a
    stencil wider than the halo), the form's coefficients from
    ``_tables`` (each rounded once from float64), and each chunk's end as
    a run index: a chunk is a run of whole (dj, di) groups, so each chunk
    ends where a run does."""
    base = ns3d_tables(kit, pitch, plane)
    rows, ends = _tables(kit, torch.float32, nchunk)
    rows = rows.cpu()
    if form == "xla":
        coefs = torch.zeros((kit.S, 8), dtype=torch.float32)
        coefs[:, :6] = rows[[1, 2, 3, 4, 5, 0]].T
    else:
        coefs = rows[6:10].T.contiguous()
    first = base.runs[:, 0].cpu().tolist() + [kit.S]
    try:
        chunk_end = [first.index(e) for e in ends.tolist()]
    except ValueError:
        raise ValueError("ns3d_chunked: a chunk ends inside a run of the "
                         "slot table") from None
    dev = kit.device
    return Ns3dChunkedTables(base.offsets, coefs.to(dev), base.runs,
                             torch.tensor(chunk_end, dtype=torch.int32,
                                          device=dev))


def _staged_terms(form, g, c, r, v, pi):
    """[NACC, rows] terms of one bond in the kernel's operations: the twin's
    (``_terms``) on the masked fields and act, but jconv's fdj act, R w2 and
    P u taken as fdj, R c2 and P e vol/xi (equal at act 1, +-0 like them at
    act 0 on masked fields)."""
    if form != "jconv":
        return _terms(form, g if form != "jstat" else g[:5], c, r, v, pi)
    R, VX, VY, VZ, P, ACT = g
    c2, et = c[6], c[7:10]
    VJ = (VX, VY, VZ)
    fdj = ((R * VX) * et[0] + (R * VY) * et[1]) + (R * VZ) * et[2]
    return torch.stack([fdj, R * c2, c2 * ACT, *(et[d] * ACT for d in range(3)),
                        *(VJ[d] * fdj for d in range(3)),
                        *(P * et[d] for d in range(3)),
                        *(VJ[d] * c2 for d in range(3))])


def ns3d_chunked_staged_plain(form, rho, vel, p, node_type, dt, kit: Kit,
                              nchunk=6, actconv=None, R: int = 2, tile=None):
    """The result of the twin of ``form`` ("xla", "factored", "jconv" or
    "jstat"; jstat takes ``actconv``) by the CUDA kernel's walk, in PyTorch:
    tiles of ``tile`` = (tz, ty, tx) nodes (default: one tile that holds the
    grid; tz a multiple of R), each staged with its halo of HALO as five
    fields masked by a select on node_type and the act plane, zero-filled
    off the grid; the kernel's table (``ns3d_chunked_tables``); and a
    thread per (y, x) column and R consecutive z of a tile that walks every
    run along z, chunk by chunk: element e of the run's column serves node
    q under slot first + e - q, each chunk's partial sums start at 0 and
    are added into the running sums after its last run. Each node adds its
    terms in slot order, so the result equals the form's twin bit for bit
    for finite inputs."""
    nz, ny, nx = kit.shape
    tz, ty, tx = tile or (-(-nz // R) * R, ny, nx)
    if tz % R:
        raise ValueError(f"ns3d_chunked_staged_plain: tile depth {tz} is not "
                         f"a multiple of R={R}")
    gz, gy, gx = -(-nz // tz), -(-ny // ty), -(-nx // tx)
    ez, ey, ex = tz + 2 * HALO, ty + 2 * HALO, tx + 2 * HALO
    pitch, plane = ex, ex * ey
    tab = ns3d_chunked_tables(kit, form, nchunk, pitch, plane)
    act = node_type != OUTSIDE
    fields = [torch.where(act, f, 0.0) for f in
              (rho, vel[..., 0], vel[..., 1], vel[..., 2], p)]
    pad = (HALO, HALO + gx * tx - nx, HALO, HALO + gy * ty - ny, HALO,
           HALO + gz * tz - nz)
    planes = [torch.nn.functional.pad(f, pad).unfold(0, ez, tz)
              .unfold(1, ey, ty).unfold(2, ex, tx).reshape(gz * gy * gx, -1)
              for f in fields + [act.to(rho.dtype)]]
    fluid = torch.nn.functional.pad(node_type == FLUID, (
        0, gx * tx - nx, 0, gy * ty - ny, 0, gz * tz - nz)).view(
            gz, tz // R, R, gy, ty, gx, tx).permute(0, 3, 5, 1, 4, 6, 2)
    # threads with a FLUID node among their R: (tile, z thread, y, x), and
    # the tile index of their first node less the halo
    b_z, b_y, b_x, zt, y, x = fluid.any(-1).nonzero(as_tuple=True)
    tile_of = (b_z * gy + b_y) * gx + b_x
    base = zt * R * plane + y * pitch + x
    centre = base + HALO * (plane + pitch + 1)
    own = []
    for q in range(R):
        r, vx, vy, vz, pq = (f[tile_of, centre + q * plane]
                             for f in planes[:5])
        own.append((r, [vx, vy, vz], pq))
    coefs = _tables(kit, rho.dtype, nchunk)[0]
    zero = torch.zeros((_NACC[form], base.numel()), dtype=rho.dtype,
                       device=rho.device)
    acc, run = [zero] * R, 0
    runs = tab.runs.tolist()
    for end in tab.chunk_end.tolist():
        part = [zero] * R
        for first, length in runs[run:end]:
            col = base[None, :] + tab.offsets[first] + torch.arange(
                length + R - 1, device=base.device)[:, None] * plane
            seg = [f[tile_of[None, :], col] for f in planes]
            for t in range(length):
                c = coefs[:, first + t]
                for q in range(R):
                    part[q] = part[q] + _staged_terms(
                        form, [f[t + q] for f in seg], c, *own[q])
        acc = [a + b for a, b in zip(acc, part)]
        run = end
    # the threads' FLUID nodes, as flat indices of the grid
    q = torch.arange(R, device=base.device)[:, None]
    k = b_z[None, :] * tz + zt[None, :] * R + q
    mine = fluid[b_z[None, :], b_y[None, :], b_x[None, :], zt[None, :],
                 y[None, :], x[None, :], q]
    rows = ((k * ny + b_y[None, :] * ty + y[None, :]) * nx
            + b_x[None, :] * tx + x[None, :])[mine]
    return _finish(form, torch.stack(acc).permute(1, 0, 2)[:, mine], rows,
                   rho, vel, p, dt, kit, actconv)


def ns3d_chunked_geometry(form: str, bz: int, lib=None) -> Ns3dGeometry:
    """The compiled kernel's tile of ``form`` at the rung ``bz``
    (csrc/ns3d_chunked.cu pd_ns3d_chunked_geometry); ``tile_bytes`` counts
    the five staged fields and the act bytes."""
    if form not in FORMS or bz not in BZ_RUNGS:
        raise ValueError(f"ns3d_chunked: no kernel for form {form!r} at BZ "
                         f"{bz} (BZ is one of {BZ_RUNGS})")
    out = (ctypes.c_int * 10)()
    rc = (lib or load().lib).pd_ns3d_chunked_geometry(
        FORMS.index(form), bz, ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"ns3d_chunked: the library has no kernel for form "
                         f"{form!r} at BZ {bz}")
    return Ns3dGeometry(*out)


def _launch(form, rho, vel, p, node_type, dt, kit: Kit, nchunk, bz,
            actconv):
    if node_type.dtype != torch.uint8 or dt.numel() != 1:
        raise TypeError(f"ns3d_{form}: node_type must be uint8 and dt a scalar")
    if (kit.dim != 3 or rho.shape != kit.shape
            or vel.shape != kit.shape + (3,) or p.shape != kit.shape
            or (actconv is not None and actconv.shape != (4,) + kit.shape)):
        raise ValueError(f"ns3d_{form}: shapes do not match the grid "
                         f"{kit.shape}")
    if bz not in BZ_RUNGS or not 1 <= nchunk <= 64:
        raise ValueError(f"ns3d_{form}: bz must be one of {BZ_RUNGS}, "
                         f"nchunk in 1..64 (got {bz}, {nchunk})")
    lib = load().lib
    per_kit = _STAGED.setdefault(kit, {})
    key = (form, bz, nchunk)
    if key not in per_kit:
        geo = ns3d_chunked_geometry(form, bz, lib)
        per_kit[key] = ns3d_chunked_tables(kit, form, nchunk, geo.pitch,
                                           geo.plane)
    tab = per_kit[key]
    rho_out = torch.empty_like(rho)
    vel_out = torch.empty_like(vel)
    nz, ny, nx = kit.shape
    rc = lib.pd_ns3d_chunked(
        FORMS.index(form), ptr(rho), ptr(vel), ptr(p), ptr(node_type),
        None if actconv is None else ptr(actconv), ptr(dt), ptr(tab.offsets),
        ptr(tab.coefs), ptr(tab.runs), ptr(tab.chunk_end), nchunk, kit.S,
        tab.runs.shape[0], nz, ny, nx, bz, *_constants(kit), ptr(rho_out),
        ptr(vel_out), rho.device.index, stream(rho))
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
