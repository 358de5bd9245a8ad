"""Restarted GMRES (right-preconditioned, CGS2 Arnoldi, Givens QR).

Port of ``pd_mg_pin_corrosion_tpu/ops/gmres.py``. Same algorithm and
exits: GMRES(m) with classical Gram-Schmidt fully reorthogonalized (CGS2,
coefficients beyond the current step masked out), Givens QR of the
Hessenberg matrix updated per step so a cycle exits at the first step whose
least-squares residual meets the target, monotone restarts (a cycle that
raised the true residual is discarded), Eigen's maxiter/restart cycle
count, and float64 Gram-Schmidt scalars over float32 Krylov vectors.

The JAX package runs the whole solve on the device: one Arnoldi step is
the body of a ``lax.while_loop`` (its ``ops/gmres.py:136-226``), the
restart cycles a second one, the f64 refinement of an implicit step
``lax.cond``s around them. Here too every decision is taken on the device,
by the one-warp ``gmres_qr`` kernel over the runner's state vector ``S``
(the Givens rotations and the exit test after each Arnoldi step, the
back-substitution at a cycle's end, the monotone acceptance, the restart
and refinement flags). The device work between two decisions is a fixed
sequence over static buffers, gated by a flag in ``F``: the restart
cycles are a loop while "a cycle is under way" (``cycles``: the cycle's
start, Arnoldi steps j = 0 .. m-1 each under "running", nested, the m + 1
cycle-end variants under a switch on the step count j, the acceptance),
the refinement passes are gated by "the residual is above tol"
(``solve``). On the card a program (the solve, or a loop of implicit
steps around it: ``coupling.StepRunner``) is recorded once into a CUDA
graph whose loops and gates are conditional (WHILE, IF and SWITCH) nodes
(``GmresRunner.program``, ``kernels.device_loop.CondGraph``) and replayed; on
the CPU, under a mesh, for 3D float64 or on request (``eager``) it runs
directly, each gate read on the host (``if flag.item()``, a switch's
value likewise). Both give the
same bits, and the host reads nothing until the caller's one ``read``.

Storage: the Krylov basis is one [m+1, N] tensor whose rows are contiguous
and start on 128-byte lines (``kernels.pitched_basis``: N is odd on the
fine-calibration grid, and the axpy kernel reads rows 16 bytes a thread).
With ``flat_kernels`` the whole-basis contractions (CGS2 dots and
recombinations, norms, the solution update) go through the CUDA kernel
wrappers ``kernels.basis_dots`` / ``kernels.basis_axpy`` (plain twins on
the CPU); without it they use the plain versions directly, as float64 runs
must.
"""

from __future__ import annotations

import ctypes
import functools
import math
import time
import warnings
import weakref
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..fields import DeviceUnavailable
from ..kernels import (PackedStencil, add_launch_counts, basis_axpy,
                       basis_axpy_plain, basis_dots, basis_dots_plain,
                       launch_counts, no_collection, pitched_basis,
                       reserve_dots_scratch)
from ..kernels import device_loop as qr
from ..kernels.device_loop import QrLayout, gmres_qr

# the solves of this process by kind, from the trip counters the device
# reports at each read. GMRES_COUNTS: Arnoldi steps run inside graphs
# ("replays") and directly ("eager"), the solve program's graph launches,
# captures and recaptures (of a key whose graph had been dropped: a buffer
# was allocated anew), restart cycles, the kernel nodes captured (launched
# while a program was recorded) and those that ran (theirs and the kernels
# that set the conditional nodes' handles), the device operations that ran
# (kernels, copies and fills, each run: the kernel records a profiler
# takes of the launches, as a graph with conditional nodes runs its copies
# and fills as kernels), and the host reads of a gate on the eager route.
# STEP_COUNTS: the same for the implicit step loop's programs ("replays"
# and "eager" count steps), plus the steps, the chunks, and the host reads
# of each step's or chunk's read besides the gates'.
GMRES_COUNTS = {"replays": 0, "eager": 0, "launches": 0, "captures": 0,
                "recaptures": 0, "cycles": 0, "captured_kernels": 0,
                "replayed_kernels": 0, "traced_kernels": 0, "host_reads": 0}
STEP_COUNTS = {"replays": 0, "eager": 0, "launches": 0, "captures": 0,
               "recaptures": 0, "captured_kernels": 0, "replayed_kernels": 0,
               "traced_kernels": 0, "host_reads": 0, "steps": 0,
               "chunks": 0}
# CYCLE_COUNTS: the fused coupling cycles' program (``coupling.CycleRunner``):
# its graph launches and direct runs, captures, recaptures, kernel nodes,
# host reads (one a launch on the graph route; each gate's besides on the
# eager route), and from the device's counters the cycles, the micro-ops
# (passes of its outer loop), the flow iterations and the launches that
# ended because a packed operator outgrew its buffers
CYCLE_COUNTS = {"launches": 0, "eager_launches": 0, "captures": 0,
                "recaptures": 0, "captured_kernels": 0,
                "replayed_kernels": 0, "traced_kernels": 0, "host_reads": 0,
                "cycles": 0, "micro_ops": 0, "flow_iters": 0,
                "pack_overflows": 0}
# room a packed operator's buffers leave for a longer store in a later cycle
PACKED_HEADROOM = 1.25
# diagnostic rows the state vector holds at first (a longer chunk grows it)
ROWS_ROOM = 64


def reset_gmres_counts() -> None:
    GMRES_COUNTS.update(dict.fromkeys(GMRES_COUNTS, 0))


def reset_step_counts() -> None:
    STEP_COUNTS.update(dict.fromkeys(STEP_COUNTS, 0))


def reset_cycle_counts() -> None:
    CYCLE_COUNTS.update(dict.fromkeys(CYCLE_COUNTS, 0))


def vector_norm_t(x: torch.Tensor, allreduce=None) -> torch.Tensor:
    """2-norm as a 0-d float64 tensor (float64 accumulation); with
    ``allreduce`` (a mesh's float64 sum) the norm of the vector split over
    the ranks."""
    if allreduce is None:
        return torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64)
    x64 = x.reshape(-1).to(torch.float64)
    return torch.sqrt(allreduce(torch.dot(x64, x64)))


def vector_norm(x: torch.Tensor, allreduce=None) -> float:
    """``vector_norm_t`` as a Python float."""
    return float(vector_norm_t(x, allreduce))


def self_dot(dots, v: torch.Tensor) -> torch.Tensor:
    """<v, v> through ``dots`` (basis_dots or its twin, a mesh's sum
    included): a 0-d float64 tensor."""
    v = v.reshape(-1)
    return dots(v[None], v)[0]


def fnorm_t(dots, v: torch.Tensor) -> torch.Tensor:
    """GMRES's 2-norm of v through ``dots``: a 0-d float64 tensor."""
    return torch.sqrt(self_dot(dots, v))


def inv_norm(h: torch.Tensor) -> torch.Tensor:
    """1 / h for h > 1e-30, else 0 (a happy breakdown keeps a zero
    vector), in h's dtype on h's device: the host's ``1.0 / max(h,
    1e-300) if h > 1e-30 else 0.0`` bit for bit, and what gmres_qr's START
    and ARNOLDI write as the basis vector's scale."""
    return torch.where(h > 1e-30,
                       torch.reciprocal(torch.clamp(h, min=1e-300)), 0.0)


def _givens(hcol: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply the j previous rotations to the new column, then zero its
    subdiagonal with a new one. Returns (c, s). The host form of
    ``gmres_qr``'s ARNOLDI mode (each square a product, as on the card)."""
    for i in range(j):
        t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i] = t
    denom = math.sqrt(hcol[j] * hcol[j] + hcol[j + 1] * hcol[j + 1])
    if denom > 1e-300:
        c, s = hcol[j] / denom, hcol[j + 1] / denom
    else:
        c, s = 1.0, 0.0
    hcol[j] = denom
    hcol[j + 1] = 0.0
    return c, s


def _back_substitute(R: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    """R[:n, :n] y = g[:n], each row's sum taken one term at a time in
    ascending order (``gmres_qr``'s FINISH mode; a BLAS dot sums in an
    order no device code reproduces)."""
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        acc = 0.0
        for k in range(i + 1, n):
            acc = acc + R[i, k] * y[k]
        y[i] = (g[i] - acc) / R[i, i]
    return y


@dataclass
class Program:
    """A recorded program: its graph with conditional nodes, the captured
    pieces (kept: they hold the pool's memory), per level (the trip
    counter of its gate or loop body; None for the ungated top level) the
    wrapper launches, kernel nodes and device operations a profiler
    records (kernels, copies and fills) one run of that level stands for,
    and the kernel nodes of the whole graph (``captured``: those a capture
    launched, the rest the kernels that set the conditional nodes'
    handles)."""

    cg: qr.CondGraph
    leaves: list
    tally: dict = field(default_factory=dict)
    nodes: int = 0        # kernel nodes, every level
    captured: int = 0     # those the captures launched (the rest set handles)


class _Recorder:
    """Records a program into a CondGraph: the device work between two
    conditional nodes is captured by PyTorch (``CUDAGraph.capture_begin``
    in the runner's pool, on the runner's side stream) and its nodes
    copied in; a gate, a switch or a loop adds its conditional node (and
    the one-thread kernel that sets its handle) and records its bodies into
    it. A body recorded twice (the two refinement passes) has the same
    tally each time."""

    def __init__(self, run: "GmresRunner"):
        self.run = run
        self.prog = Program(qr.CondGraph(run.S.device), [])
        self.prog.tally[None] = [{}, 0, 0]
        self.trips = [None]
        self.leaf = None
        self.before = None

    def _kernel(self, n=1, captured=False, traced=None):
        """n kernel nodes added to the level under construction, and the
        device operations a profiler records of them (``traced``, by
        default n)."""
        level = self.prog.tally[self.trips[-1]]
        level[1] += n
        level[2] += n if traced is None else traced
        self.prog.nodes += n
        self.prog.captured += n if captured else 0

    def begin(self):
        self.before = launch_counts()
        self.leaf = torch.cuda.CUDAGraph(keep_graph=True)
        # relaxed: a body may load its kernels' modules (CUDA's lazy
        # loading) while it is captured
        self.leaf.capture_begin(pool=self.run.pool,
                                capture_error_mode="relaxed")

    def end(self):
        g = self.leaf
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", ".*CUDA Graph is empty.*")
                g.capture_end()
        finally:
            self.leaf = None
        # the capture launched nothing: take its counts back
        after = launch_counts()
        launched = {k: n - self.before[k] for k, n in after.items()
                    if n != self.before[k]}
        add_launch_counts({k: -n for k, n in launched.items()})
        # every piece is kept, an empty one too: a piece that goes releases
        # its hold on the pool, which the next capture still needs
        self.prog.leaves.append(g)
        kinds = node_kinds(g.raw_cuda_graph())
        if not kinds:
            return
        self.prog.cg.add(g.raw_cuda_graph())
        level = self.prog.tally[self.trips[-1]][0]
        for k, n in launched.items():
            level[k] = level.get(k, 0) + n
        # a graph with conditional nodes runs on the device's own launcher,
        # whose copies and fills are kernels to a profiler
        self._kernel(kinds.count(0), captured=True,
                     traced=sum(kinds.count(t) for t in (0, 1, 2)))

    def _body(self, trip, body):
        self.trips.append(trip)
        self.prog.tally[trip] = [{}, 0, 0]
        self.begin()
        body()
        self.end()

    def gate(self, flag, trip, body):
        self.end()
        self.prog.cg.begin_if(flag)
        self._kernel()                 # the kernel that sets the handle
        self._body(trip, body)
        self.trips.pop()
        self.prog.cg.end_if()
        self.begin()

    def loop(self, flag, trip, body):
        self.end()
        self.prog.cg.begin_while(flag)
        self._kernel()
        self._body(trip, body)
        self._kernel()                 # the kernel that sets it again
        self.trips.pop()
        self.prog.cg.end_while()
        self.begin()

    def switch(self, value, trips, bodies):
        self.end()
        graphs = self.prog.cg.switch(value, len(bodies))
        self._kernel()
        for g, trip, body in zip(graphs, trips, bodies):
            self.prog.cg.begin_case(g)
            self._body(trip, body)
            self.trips.pop()
            self.prog.cg.end_if()
        self.begin()


class GmresRunner:
    """One kit's implicit solve over static buffers.

    Holds everything the solve's device work reads or writes at a fixed
    address: the Krylov basis ``V`` [m+1, N]; ``gmres_qr``'s state ``S``
    (float64, ``lay``: the Hessenberg's R, g, the rotations, the Arnoldi
    column, the coefficients ``yc`` = -y, the scalars, the trip counters,
    the diagnostic rows) and flags ``F`` (bool), and the pinned host copy
    of S's read region ``S_host``; the solve's vectors (``setup``): the
    right-hand side ``b``, the iterate ``x`` and a cycle's candidate
    ``xn``, ``dt`` and the Jacobi scaling ``inv_diag``, and for a float32
    step's refinement ``b64``, ``x64`` and ``r64``; and the operator
    (``load``: every tensor of it copied into a buffer of its own; a
    ``PackedStencil``'s slots and values into buffers with PACKED_HEADROOM
    of room, since its stored length changes from cycle to cycle while the
    kernels read only up to ``slice_ptr[-1]``). So one graph per program
    serves every GMRES call of the run: the main solve and the refinement
    corrections share A, M and the restart length, and the right-hand side
    and the start enter through ``b`` and ``x``.

    ``graph_route``: on the card, off a mesh, and not a 3D float64 solve
    (its dense plain matvec walks the unknown rows found by ``nonzero``, a
    host read). ``graphs``: each recorded program by key (``("solve",)``,
    ``("step", x0)`` the implicit step loop's). The graphs share one
    private pool: every output that is read afterwards lands in the static
    buffers, so each piece's temporaries are dead at its end. A buffer
    that is allocated anew (the operator outgrew its buffers, or a new
    grid, restart length or row count) drops every graph (``growths``
    counts such buffers); they are recorded again as the solve reaches
    them. ``captured`` holds every key recorded at least once,
    ``capture_ms`` and ``pool_bytes`` add up over the captures. The runner
    holds no reference to its kit (``runner_for`` keys runners weakly on
    their kit).
    """

    def __init__(self, graph_route: bool = False):
        self.graph_route = graph_route
        self.V = self.scale = self.S = self.F = self.S_host = self.lay = None
        self.b = self.x = self.xn = self.dt = self.inv_diag = None
        self.b64 = self.x64 = self.r64 = None
        self.op = None
        self._source = None        # weak reference to the operator loaded
        self._bufs: dict = {}      # path -> static tensor
        self._caps: dict = {}      # path of a PackedStencil -> capacity
        self.graphs: dict = {}
        self.captured: set = set()
        self.pool = None
        self.stream = None
        self.growths = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._rec: _Recorder | None = None
        self._kind = "solve"       # the program running (its counts)
        self._replayed: set = set()   # program keys launched since a read
        self._trips_seen = None

    # -- static inputs -------------------------------------------------
    def drop_graphs(self) -> None:
        self.graphs.clear()
        self.pool = None

    def buffer(self, path, shape, dtype, device, grow=None):
        """The static tensor at ``path``, allocated anew (dropping every
        graph) unless it has ``shape``, or ``grow`` or more elements of a
        1-D buffer, in ``dtype`` on ``device``."""
        buf = self._bufs.get(path)
        fits = (buf is not None and buf.dtype == dtype
                and buf.device == device
                and (buf.shape == shape if grow is None
                     else buf.numel() >= grow))
        if not fits:
            if buf is not None:
                self.growths += 1
                self.drop_graphs()
            buf = self._bufs[path] = (
                torch.empty(shape, dtype=dtype, device=device)
                if grow is None else
                torch.zeros(grow, dtype=dtype, device=device))
        return buf

    def put(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into the static tensor at ``path``."""
        buf = self.buffer(path, t.shape, t.dtype, t.device)
        buf.copy_(t)
        return buf

    def _static(self, path, new, memo):
        if new is None or not isinstance(new, torch.Tensor) and not (
                is_dataclass(new)):
            return new
        if id(new) in memo:     # a tensor shared by two fields stays shared
            return memo[id(new)]
        if isinstance(new, torch.Tensor):
            out = self.put(path, new)
        elif isinstance(new, PackedStencil):
            n = new.values.numel()
            if n > self._caps.get(path, 0):
                self._caps[path] = math.ceil(n * PACKED_HEADROOM)
            parts = {}
            for name in ("count", "slice_ptr", "slots", "values"):
                t = getattr(new, name)
                if id(t) not in memo:
                    memo[id(t)] = (self.put(f"{path}.{name}", t)
                                   if name in ("count", "slice_ptr")
                                   else self._grown(f"{path}.{name}", t,
                                                    self._caps[path]))
                parts[name] = memo[id(t)]
            out = replace(new, **parts)
        else:
            out = replace(new, **{f.name: self._static(
                f"{path}.{f.name}", getattr(new, f.name), memo)
                for f in fields(new)})
        memo[id(new)] = out
        return out

    def _grown(self, path, t, cap):
        buf = self.buffer(path, None, t.dtype, t.device, grow=cap)
        buf[:t.numel()].copy_(t)
        return buf

    def load(self, op):
        """The operator in the static buffers: ``op`` copied in, unless it
        is the operator loaded last (once a coupling cycle)."""
        if self._source is None or self._source() is not op:
            self.op = self._static("op", op, {})
            self._source = weakref.ref(op)
        return self.op

    def setup(self, like: torch.Tensor, restart: int, refine: bool) -> None:
        """The basis for GMRES(``restart``) over vectors shaped like
        ``like``, and the solve's vectors (the refinement's float64 ones
        with ``refine``), each allocated at its first use and anew, dropping
        every graph, when its shape, dtype or device changes."""
        self.basis(restart, like.numel(), like.dtype, like.device)
        shape, dev = like.shape, like.device
        for name, sh, dtype in (
                ("b", shape, like.dtype), ("x", shape, like.dtype),
                ("xn", shape, like.dtype), ("dt", (), like.dtype),
                ("inv_diag", shape, like.dtype),
                *(((n, shape, torch.float64) for n in ("b64", "x64", "r64"))
                  if refine else ())):
            setattr(self, name, self.buffer(name, sh, dtype, dev))

    def basis(self, m: int, n: int, dtype, device) -> torch.Tensor:
        """The [m+1, n] basis, the scale gmres_qr leaves for its next
        vector (one element of its dtype) and gmres_qr's state, allocated
        at the first call and whenever m, n or the dtype change."""
        V = self.V
        if V is None or V.shape != (m + 1, n) or V.dtype != dtype or (
                V.device != device):
            if V is not None:
                self.drop_graphs()
            self.V = pitched_basis(m + 1, n, dtype, device)
            self.scale = torch.zeros(1, dtype=dtype, device=device)
            self.qr_state(m, ROWS_ROOM, device)
        return self.V

    def qr_state(self, m: int, rows: int, device) -> None:
        """gmres_qr's state for restart length m with room for ``rows``
        diagnostic rows, allocated anew (zeros, dropping every graph)
        unless the present one serves."""
        lay = self.lay
        if (lay is not None and lay.m == m and lay.cap >= rows
                and self.S.device == device):
            return
        if lay is not None:
            self.growths += 1
            self.drop_graphs()
        self.lay = QrLayout(m, max(rows, ROWS_ROOM))
        self.S = torch.zeros(self.lay.size, dtype=torch.float64,
                             device=device)
        self.F = torch.zeros(self.lay.n_flags, dtype=torch.bool,
                             device=device)
        self.S_host = torch.zeros(self.lay.size - self.lay.SC,
                                  dtype=torch.float64,
                                  pin_memory=device.type == "cuda")
        self._trips_seen = np.zeros(self.lay.n_trips)

    # -- the state vector ----------------------------------------------
    def put_sc(self, name: str, *vals) -> None:
        """0-d tensors into S's consecutive scalars from ``name`` on."""
        at = self.lay.sc(name)
        if len(vals) == 1:
            self.S[at].copy_(vals[0])
        else:
            self.S[at:at + len(vals)].copy_(torch.stack(
                [v.to(torch.float64) for v in vals]))

    def qr(self, mode: int, j: int = 0, params=None, c1=None, c2=None,
           dot=None) -> None:
        """gmres_qr's mode over S and F (START and ARNOLDI writing the
        basis vector's scale into ``scale``)."""
        gmres_qr(mode, j, self.S, self.F, self.lay.m, params, c1, c2, dot,
                 self.scale)

    def read(self, rows: int = 0) -> list:
        """S's scalars, trip counters and the first ``rows`` diagnostic
        rows, by one copy into the pinned buffer and one stream sync; the
        runs since the last read counted from the trip counters."""
        lay = self.lay
        n = lay.ROWS - lay.SC + 5 * rows
        self.S_host[:n].copy_(self.S[lay.SC:lay.SC + n], non_blocking=True)
        self._sync()
        vals = self.S_host[:n].tolist()
        STEP_COUNTS["host_reads"] += 1
        self._settle(vals[lay.TRIPS - lay.SC:lay.ROWS - lay.SC])
        return vals

    def sc(self, vals: list, name: str) -> float:
        """Scalar ``name`` of a ``read``."""
        return vals[qr.SC_INDEX[name]]

    def _settle(self, trips: list, other: dict | None = None) -> None:
        """Count what ran since the last read from the trip counters: a
        body of a program launched as a graph since then adds the launches,
        kernel nodes and device operations its capture recorded, once per
        run; a body run directly counted its own launches. ``other`` holds
        the runs since the last read of bodies whose trip counters lie
        outside S (keys that are not S's trip indices: the fused cycles'
        bodies, counted in CYCLE_COUNTS)."""
        lay = self.lay
        now = np.asarray(trips)
        d = (now - self._trips_seen).astype(np.int64)
        self._trips_seen = now
        loops = [set(lay.loop_trips(c)) for c in range(qr.COPIES)]
        gmres_trips = set().union(*loops)
        graphed = set()
        for key in self._replayed:
            prog = self.graphs.get(key)
            if prog is None:
                continue
            for trip, (launched, nodes, traced) in prog.tally.items():
                if trip is None:
                    continue
                runs = (int(d[trip]) if isinstance(trip, int)
                        else int((other or {}).get(trip, 0)))
                if not runs:
                    continue
                graphed.add(trip)
                add_launch_counts({k: v * runs for k, v in launched.items()})
                counts = (CYCLE_COUNTS if not isinstance(trip, int)
                          else GMRES_COUNTS if trip in gmres_trips
                          else STEP_COUNTS)
                counts["replayed_kernels"] += nodes * runs
                counts["traced_kernels"] += traced * runs
        for c in range(qr.COPIES):
            arn = int(d[lay.arn(c):lay.arn(c) + lay.m].sum())
            GMRES_COUNTS["replays" if lay.arn(c) in graphed
                         else "eager"] += arn
            GMRES_COUNTS["cycles"] += int(d[lay.cyc(c)])
        steps = int(d[lay.trip["tail"]])
        STEP_COUNTS["replays" if lay.trip["head"] in graphed
                    else "eager"] += steps
        STEP_COUNTS["steps"] += steps
        self._replayed.clear()

    # -- programs --------------------------------------------------------
    def _counts(self) -> dict:
        return {"solve": GMRES_COUNTS, "cycles": CYCLE_COUNTS}.get(
            self._kind, STEP_COUNTS)

    def _flag(self, flag) -> torch.Tensor:
        """``F[flag]`` for an index, else the 0-d bool device tensor
        itself (another state's flag)."""
        return self.F[flag] if isinstance(flag, int) else flag

    def gate(self, flag, trip, body) -> None:
        """``body`` (device work) gated by flag ``F[flag]`` (or a 0-d bool
        tensor ``flag``): an IF node of the program being recorded, else
        run if the flag reads true (a host read). ``trip`` is the counter
        gmres_qr (or the kernel that set the flag) adds one to when the
        body runs."""
        flag = self._flag(flag)
        if self._rec is not None:
            self._rec.gate(flag, trip, body)
            return
        self._counts()["host_reads"] += 1
        if bool(flag.item()):
            body()

    def loop(self, flag, trip, body) -> None:
        """``body`` run while flag ``F[flag]`` (or a 0-d bool tensor
        ``flag``) holds (it is read before each run): a WHILE node of the
        program being recorded, else a host loop over the flag's reads."""
        flag = self._flag(flag)
        if self._rec is not None:
            self._rec.loop(flag, trip, body)
            return
        while True:
            self._counts()["host_reads"] += 1
            if not bool(flag.item()):
                return
            body()

    def switch(self, name, trips: list, bodies: list) -> None:
        """``bodies[i]`` run when S's scalar ``name`` (or the 0-d float64
        tensor ``name``) is i: a SWITCH node of the program being
        recorded, else the body the scalar reads (a host read)."""
        value = self.S[self.lay.sc(name)] if isinstance(name, str) else name
        if self._rec is not None:
            self._rec.switch(value, trips, bodies)
            return
        self._counts()["host_reads"] += 1
        i = int(value.item())
        if i < len(bodies):
            bodies[i]()

    def program(self, key: tuple, fn, graphed: bool) -> None:
        """Run program ``fn`` (device work and ``gate`` / ``loop`` /
        ``switch`` over the static buffers; no host read but theirs)
        directly, or as one launch of its graph, recorded at its first use
        (the recording runs nothing). Nothing is read back: the caller's
        ``read`` counts what ran. Keys: ``("solve",)`` (GMRES and the
        refinement; counted in GMRES_COUNTS), ``("step", x0)`` (the
        step loop; STEP_COUNTS) and ``("cycles", x0)`` (the fused coupling
        cycles, ``coupling.CycleRunner``; CYCLE_COUNTS)."""
        self._kind = key[0]
        if not graphed:
            if self._kind == "cycles":
                CYCLE_COUNTS["eager_launches"] += 1
            fn()
            return
        prog = self.graphs.get(key)
        counts = self._counts()
        if prog is None:
            self.graphs[key] = prog = self._capture(key, fn)
            counts["captures"] += 1
            counts["captured_kernels"] += prog.captured
            if key in self.captured:
                counts["recaptures"] += 1
            self.captured.add(key)
        prog.cg.launch()
        launched, nodes, traced = prog.tally[None]
        add_launch_counts(launched)
        counts["launches"] += 1
        counts["replayed_kernels"] += nodes
        counts["traced_kernels"] += traced
        self._replayed.add(key)

    def _sync(self) -> None:
        if self.S.is_cuda:
            torch.cuda.current_stream(self.S.device).synchronize()

    def _capture(self, key, fn) -> Program:
        """Record ``fn`` on the runner's side stream into a CondGraph in the
        runner's pool; nothing runs. basis_dots' scratch of that stream is
        sized for the whole basis first and may not grow afterwards.
        Raises DeviceUnavailable without a card and whatever the capture
        raises: there is no fallback."""
        dev = self.V.device
        if not torch.cuda.is_available() or dev.type != "cuda":
            raise DeviceUnavailable(
                f"a CUDA graph of the program {key!r} needs a card; the "
                f"basis is on {dev}")
        t0 = time.perf_counter()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side = self.stream
        reserve_dots_scratch(dev, side.cuda_stream, self.V.shape[0])
        with no_collection():
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            side.wait_stream(torch.cuda.current_stream(dev))
            rec = self._rec = _Recorder(self)
            with torch.cuda.stream(side):
                try:
                    rec.begin()
                    fn()
                    rec.end()
                finally:
                    self._rec = None
                    if rec.leaf is not None:   # a capture that raised
                        try:
                            rec.leaf.capture_end()
                        except Exception:   # noqa: BLE001 - the first wins
                            pass
        rec.prog.cg.instantiate()
        torch.cuda.synchronize(dev)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms += 1e3 * (time.perf_counter() - t0)
        return rec.prog


def node_kinds(raw_graph: int) -> list:
    """The node types of a CUDA graph (``raw_cuda_graph()`` of a graph
    made with ``keep_graph``; 0 is a kernel node), through libcuda's graph
    API: one level, the bodies of conditional nodes not included."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    g = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    if n.value == 0:
        return []
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    kinds = []
    for node in nodes[:n.value]:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds.append(kind.value)
    return kinds


# {kit: GmresRunner}
_runners: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def runner_for(kit) -> GmresRunner:
    """The kit's GmresRunner, made at its first implicit step (its buffers
    and graphs live as long as the kit)."""
    run = _runners.get(kit)
    if run is None:
        run = _runners[kit] = GmresRunner(
            kit.device.type == "cuda" and getattr(kit, "slab", None) is None
            and not (kit.dim == 3 and kit.dtype == torch.float64))
    return run


# ---------------------------------------------------------------------------
# the restart cycles and the refinement, over a runner's buffers
# ---------------------------------------------------------------------------

@dataclass
class System:
    """An implicit step's linear system over a runner's static buffers.

    ``A`` and ``M`` (the right preconditioner) act on vectors shaped like
    C; ``A64`` is A in float64 over the float32 weights (the refinement's
    residual) on float32 runs, None on float64 ones; ``rhs(C)`` is b;
    ``solved()`` the rows the step writes (the rest keep C); ``unknown``
    the rows whose start is clipped; ``diag`` M's diagonal (the Jacobi
    scaling 1 / (1 - dt diag)). Every tensor a program reads is the
    runner's or the kit's, so a graph recorded over one System serves the
    next one over the same buffers."""

    A: Callable
    M: Callable
    A64: Callable | None
    rhs: Callable
    solved: Callable
    unknown: torch.Tensor
    diag: torch.Tensor
    restart: int
    flat_kernels: bool
    allreduce: Callable | None = None

    def fns(self):
        """(A, M, dots, axpy) for ``cycle_program``."""
        return krylov_fns(self.A, self.M, self.flat_kernels, self.allreduce)


def krylov_fns(A, M, flat_kernels: bool, allreduce=None):
    """(A, M, dots, axpy): the basis kernels' wrappers with
    ``flat_kernels`` (float32), their plain twins otherwise, the dots
    summed over a mesh's ranks by ``allreduce``."""
    dots = basis_dots if flat_kernels else basis_dots_plain
    axpy = basis_axpy if flat_kernels else basis_axpy_plain
    if allreduce is not None:
        local_dots = dots

        def dots(V, w):
            return allreduce(local_dots(V, w))
    return A, M, dots, axpy


def prepare(run: GmresRunner, system, op, kit, like: torch.Tensor,
            restart: int = 50) -> System:
    """``system(run, op, kit, restart)`` (a backend's ``linear_system``)
    over ``op`` loaded into the runner's buffers, and the runner set up
    for it with vectors shaped like ``like``."""
    sys = system(run, run.load(op), kit, restart)
    run.setup(like, sys.restart, refine=sys.A64 is not None)
    return sys


def start(sys: System, C: torch.Tensor, x0, c_max: float) -> torch.Tensor:
    """The solve's start: C, or ``x0`` (implicit_extrapolate_x0) clipped to
    [0, c_max] on the unknown rows and C elsewhere."""
    if x0 is None:
        return C
    return torch.where(sys.unknown, torch.clamp(x0, 0.0, c_max), C)


def norms(run: GmresRunner, fns) -> list:
    """(||b||, ||b - A x||) of the runner's b and x, GMRES's norms."""
    A, _, dots, _ = fns
    return [fnorm_t(dots, run.b), fnorm_t(dots, run.b - A(run.x))]


def load_rhs(run: GmresRunner, sys: System, C: torch.Tensor, x0,
             c_max: float) -> None:
    """A step's solve set up from C (after the BCs), dt in ``run.dt``: the
    Jacobi scaling into ``run.inv_diag``, b = ``sys.rhs(C)`` into
    ``run.b``, the start (``start``) into ``run.x``, and their ``norms``
    into S's BN and RN."""
    run.inv_diag.copy_(1.0 / (1.0 - run.dt * sys.diag))
    run.b.copy_(sys.rhs(C))
    run.x.copy_(start(sys, C, x0, c_max))
    run.put_sc("BN", *norms(run, sys.fns()))


def solve_params(sys: System, tol: float, maxiter: int, t0=0.0,
                 T_final=math.inf, total0=0, steps_left=1, cap=1,
                 batch=2 ** 30, diag_every=2 ** 30, out_every=2 ** 30):
    """gmres_qr's BEGIN parameters of a solve to ``tol`` (float32 runs:
    the cycles to max(tol, 1e-4), the refinement to tol) in ``maxiter``
    Arnoldi steps, and of the chunk of steps it is part of (by default
    one step with no exit of its own)."""
    main = max(tol, 1e-4) if sys.A64 is not None else tol
    return (t0, T_final, main, tol, n_cycles(maxiter, sys.restart), total0,
            steps_left, cap, batch, diag_every, out_every)


def n_cycles(maxiter: int, restart: int) -> int:
    """Eigen's cycle count (pd_ard_implicit.cpp:399-401): maxiter counts
    total inner iterations, cycles = ceil(maxiter / restart)."""
    return max(1, -(-maxiter // restart))


def _arnoldi(run: GmresRunner, j: int, fns) -> None:
    """Arnoldi step j in place: w = A(M(V[j])), CGS2 against V[:j+1], then
    gmres_qr's ARNOLDI from the raw dots (the column [c1 + c2, ||w||],
    its rotations and the scale 1 / ||w||, 0 at a happy breakdown, whose
    zero vector is never used) and V[j+1] = w * scale."""
    A, M, dots, axpy = fns
    V = run.V
    w = A(M(V[j].view(run.x.shape))).reshape(-1)
    Vj = V[:j + 1]
    c1 = dots(Vj, w)
    w = axpy(c1, Vj, w)
    c2 = dots(Vj, w)
    w = axpy(c2, Vj, w)
    run.qr(qr.ARNOLDI, j, c1=c1, c2=c2, dot=self_dot(dots, w))
    torch.mul(w, run.scale, out=V[j + 1])


def _cycle_start(run: GmresRunner, fns) -> None:
    """r = b - A x; gmres_qr's START from <r, r> (beta = ||r|| into S and
    the scale 1 / beta, 0 below 1e-30), then V[0] = r * scale."""
    A, _, dots, _ = fns
    r = (run.b - A(run.x)).reshape(-1)
    run.qr(qr.START, dot=self_dot(dots, r))
    torch.mul(r, run.scale, out=run.V[0])


def _cycle_end(run: GmresRunner, fns, j: int) -> None:
    """A cycle of j Arnoldi steps ends: xn = x + M(sum_i yc_i V[i]) with
    the coefficients gmres_qr left in S, and <r, r> of r = b - A xn into
    S's RNEW, whose square root ACCEPT takes (j > 0); for j = 0 the
    residual of x itself."""
    A, M, dots, axpy = fns
    if j == 0:
        run.put_sc("RNEW", self_dot(dots, run.b - A(run.x)))
        return
    yc = run.S[run.lay.YC:run.lay.YC + j]
    dx = M(axpy(yc, run.V[:j]).view(run.x.shape))
    torch.add(run.x, dx, out=run.xn)
    run.put_sc("RNEW", self_dot(dots, run.b - A(run.xn)))


def cycles(run: GmresRunner, fns, loop: int = 0) -> None:
    """GMRES's restart cycles (cycle loop ``loop``: 0 the main solve's, 1
    and 2 the refinement corrections', each with its own trip counters),
    looped while "a cycle is under way" (k <
    the cycle count and the residual above tol, set by gmres_qr's HEAD,
    CORRECT or ACCEPT): each the cycle's start, Arnoldi steps j = 0 ..
    m-1, each gated by "running" inside the step before it and followed by
    gmres_qr's rotation and exit test, the back-substitution, the cycle end
    for the j the cycle stopped at (a SWITCH on j: the axpy over V[:j] has
    a shape of its own), and the monotone acceptance (x = xn under its
    flag) with the next restart flag."""
    lay, m = run.lay, run.lay.m
    arn, end = lay.arn(loop), lay.end(loop)

    def arnoldi(j):
        _arnoldi(run, j, fns)
        if j + 1 < m:
            run.gate(qr.RUNNING, arn + j + 1, lambda: arnoldi(j + 1))

    def cycle():
        _cycle_start(run, fns)
        run.gate(qr.RUNNING, arn, lambda: arnoldi(0))
        run.qr(qr.FINISH)
        run.switch("J", [end + j for j in range(m + 1)],
                   [functools.partial(_cycle_end, run, fns, j)
                    for j in range(m + 1)])
        run.qr(qr.ACCEPT)
        run.gate(qr.TAKE, lay.take(loop), lambda: run.x.copy_(run.xn))

    run.loop(qr.ACTIVE, lay.cyc(loop), cycle)


def solve(run: GmresRunner, sys: System) -> None:
    """An implicit step's solve from the runner's b and x, after gmres_qr's
    HEAD (or BEGIN and HEAD) took their norms and set the restart flag:
    the restart cycles (GMRES to tol, float32 runs to max(tol, 1e-4)) and,
    on float32 runs, the float64 refinement (pd_ard_implicit.cpp:399-417
    reaches 1e-10 in double): the residual from A64, then two passes, each
    gated by "the residual is above tol": the correction's right-hand side
    in ``b`` and its start 0 in ``x``, its cycles to tol_c (two at most),
    and the update of x64 with the new residual. Every decision is
    gmres_qr's and nothing is read here: a program body (``program``).
    The answer is ``solution(run, sys)``; the residual is S's RES (REFRES
    with the refinement)."""
    fns = sys.fns()
    lay = run.lay
    cycles(run, fns)
    if sys.A64 is None:
        return

    def residual():
        torch.sub(run.b64, sys.A64(run.x64), out=run.r64)
        return vector_norm_t(run.r64, sys.allreduce)

    def correction(loop):
        run.b.copy_(run.r64)
        run.x.zero_()
        run.put_sc("BN", *norms(run, fns))
        run.qr(qr.CORRECT)
        cycles(run, fns, loop)
        run.x64.add_(run.x)
        run.put_sc("RN", residual())
        run.qr(qr.UPDATE)

    run.b64.copy_(run.b)
    run.x64.copy_(run.x)
    run.put_sc("BN", vector_norm_t(run.b64, sys.allreduce), residual())
    run.qr(qr.REF_FIRST)
    for loop in (1, 2):
        run.gate(qr.GO, lay.trip["correct"],
                 functools.partial(correction, loop))


def solution(run: GmresRunner, sys: System) -> torch.Tensor:
    """The solve's answer in the run dtype."""
    return run.x if sys.A64 is None else run.x64.to(run.x.dtype)


def default_tol(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-10


def implicit_step(system, state, op, kit, dt, tol: float | None = None,
                  restart: int = 50, maxiter: int = 200, x0=None,
                  eager: bool = False):
    """One implicit step's solve (I - dt M) C_new = b from ``state.C``
    (pd_ard_implicit.cpp:371-429) over a backend's ``system``, its
    ``linear_system`` (``prepare``): dt into the kit's runner, b and the
    start from C (``load_rhs``; ``x0``, implicit_extrapolate_x0, e.g.
    2 C_n - C_{n-1}, clipped to [0, C_solid_init] on the unknown rows),
    ``solve`` (f32 runs refine in f64), one read, and C_new = the answer
    clamped to [0, C_solid_init] on the solved rows, C elsewhere.
    ``load_rhs`` reads the caller's tensors and so runs directly; the
    solve's programs are CUDA graphs on the runner's graph route unless
    ``eager`` (the same bits). The coupled loop steps through
    ``coupling.StepRunner`` instead, whose head is a graph too. Returns
    (new state, residual as a float)."""
    run = runner_for(kit)
    sys = prepare(run, system, op, kit, state.C, restart)
    C, c_max = state.C, kit.cfg.C_solid_init
    tol = default_tol(C.dtype) if tol is None else tol
    run.dt.copy_(torch.as_tensor(dt, dtype=C.dtype, device=C.device))

    # b and the start from the caller's tensors, directly
    run.qr(qr.BEGIN, params=solve_params(sys, tol, maxiter))
    load_rhs(run, sys, C, x0, c_max)
    run.qr(qr.HEAD)
    run.program(("solve",), lambda: solve(run, sys),
                run.graph_route and not eager)
    vals = run.read()
    res = run.sc(vals, "RES" if sys.A64 is None else "REFRES")
    C_new = torch.where(sys.solved(), torch.clamp(solution(run, sys), 0.0,
                                                  c_max), C)
    return replace(state, C=C_new), res


def gmres(A, b, x0, *, tol: float, restart: int, maxiter: int, M=None,
          flat_kernels: bool = False, allreduce=None):
    """Solve A x = b. Returns (x, (residual, n_cycles)) with the relative
    residual ||b - A x|| / ||b|| as a float.

    A: linear operator (function), M: right preconditioner (function).
    ``allreduce`` sums a float64 tensor over the ranks of a mesh whose
    ranks each hold a slab of the vectors: every dot (CGS2 coefficients,
    norms) is the local ``basis_dots`` summed by it before its
    ``basis_axpy``, so every rank takes the same Arnoldi steps.
    The cycles run directly over a fresh GmresRunner's buffers.
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    run = GmresRunner()
    run.setup(b, restart, refine=False)
    run.b.copy_(b)
    run.x.copy_(x0)
    fns = krylov_fns(A, M, flat_kernels, allreduce)
    ncyc = n_cycles(maxiter, restart)
    run.qr(qr.BEGIN, params=(0.0, math.inf, tol, tol, ncyc, 0, 1, 1,
                             2 ** 30, 2 ** 30, 2 ** 30))
    run.put_sc("BN", *norms(run, fns))
    run.qr(qr.HEAD)
    cycles(run, fns)
    vals = run.read()
    return run.x.clone(), (run.sc(vals, "RES"), int(run.sc(vals, "K")))
