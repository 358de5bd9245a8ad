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
``lax.cond``s around them. Here the host makes those loops' decisions and
the device work between two decisions is one fixed sequence over static
buffers (a ``GmresRunner``'s): an Arnoldi step (``GmresRunner.arnoldi``:
the preconditioner and the operator, both CGS2 sweeps, the norm, the new
Hessenberg column and the next basis vector, its ``1 / h`` taken on the
device in float64), a cycle's start (r = b - A x, its norm, V[0]) and end
(the solution update for j Arnoldi steps and its true residual), and the
refinement's residuals. Each ends in one read of a pinned host buffer. On
the card each sequence is captured into a CUDA graph at its first use
(``GmresRunner.segment``, a graph per segment key: an Arnoldi step's per
index j, a cycle end's per j) and replayed; elsewhere, under a mesh, or on
request (``eager``) it is called directly; both give the same bits. The
(m+1) x m Hessenberg, the rotations and the back-substitution run on the
host in float64 (the JAX package's associative-scan Givens update was a
TPU latency device; the sequential rotation is the same algebra).

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

import math
import time
import weakref
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..fields import DeviceUnavailable
from ..kernels import (PackedStencil, add_launch_counts, basis_axpy,
                       basis_axpy_plain, basis_dots, basis_dots_plain,
                       launch_counts, pitched_basis, reserve_dots_scratch)

# the segments of every solve in this process (``GmresRunner.segment``) by
# kind: GMRES_COUNTS the Arnoldi steps (and the restart cycles), STEP_COUNTS
# every other segment (each cycle's start and end, the refinement's
# residuals, a caller's own: the implicit step's head and tail). Graph
# replays, segments run directly (the eager route's, and a capture's
# warm-up), graph captures, captures of a key whose graph had been dropped
# (a buffer was allocated anew), and the kernel nodes of the graphs
# captured and of the graphs replayed
GMRES_COUNTS = {"replays": 0, "eager": 0, "captures": 0, "recaptures": 0,
                "cycles": 0, "captured_kernels": 0, "replayed_kernels": 0}
STEP_COUNTS = {"replays": 0, "eager": 0, "captures": 0, "recaptures": 0,
               "captured_kernels": 0, "replayed_kernels": 0}
# room a packed operator's buffers leave for a longer store in a later cycle
PACKED_HEADROOM = 1.25


def reset_gmres_counts() -> None:
    GMRES_COUNTS.update(dict.fromkeys(GMRES_COUNTS, 0))


def reset_step_counts() -> None:
    STEP_COUNTS.update(dict.fromkeys(STEP_COUNTS, 0))


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


def fnorm_t(dots, v: torch.Tensor) -> torch.Tensor:
    """GMRES's 2-norm of v through ``dots`` (basis_dots or its twin, a
    mesh's sum included): a 0-d float64 tensor."""
    v = v.reshape(-1)
    return torch.sqrt(dots(v[None], v)[0])


def inv_norm(h: torch.Tensor) -> torch.Tensor:
    """1 / h for h > 1e-30, else 0 (a happy breakdown keeps a zero
    vector), in h's dtype on h's device: the host's ``1.0 / max(h,
    1e-300) if h > 1e-30 else 0.0`` bit for bit."""
    return torch.where(h > 1e-30,
                       torch.reciprocal(torch.clamp(h, min=1e-300)), 0.0)


def _givens(hcol: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply the j previous rotations to the new column, then zero its
    subdiagonal with a new one. Returns (c, s)."""
    for i in range(j):
        t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i] = t
    denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
    if denom > 1e-300:
        c, s = hcol[j] / denom, hcol[j + 1] / denom
    else:
        c, s = 1.0, 0.0
    hcol[j] = denom
    hcol[j + 1] = 0.0
    return c, s


def _back_substitute(R: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:n] @ y[i + 1:n]) / R[i, i]
    return y


class GmresRunner:
    """One kit's implicit solve over static buffers.

    Holds everything the solve's device work reads or writes at a fixed
    address: the Krylov basis ``V`` [m+1, N], the back-substitution's
    coefficients ``y_host`` (pinned on the card) and their device copy
    ``yc``; the solve's vectors (``setup``): the right-hand side ``b``, the
    iterate ``x`` and a cycle's candidate ``xn``, ``dt`` and the Jacobi
    scaling ``inv_diag``, and for a float32 step's refinement ``b64``,
    ``x64`` and ``r64``; a segment's outputs ``out`` (float64, room for a
    Hessenberg column) and their pinned copy ``out_host``; and the operator
    (``load``: every tensor of it copied into a buffer of its own; a
    ``PackedStencil``'s slots and values into buffers with PACKED_HEADROOM
    of room, since its stored length changes from cycle to cycle while the
    kernels read only up to ``slice_ptr[-1]``). So one graph per segment
    key serves every GMRES call of the run: the main solve and the
    refinement corrections share A, M and the restart length, and the
    right-hand side and the start enter through ``b`` and ``x``.

    ``graph_route``: on the card, off a mesh, and not a 3D float64 solve
    (its dense plain matvec walks the unknown rows found by ``nonzero``, a
    host read). ``graphs``: each captured segment's (graph, the wrapper
    launches one replay stands for, its kernel nodes, its outputs) by key:
    ``("arnoldi", j)`` for Arnoldi step j, ``("start",)`` and ``("end",
    j)`` for a cycle's, and the refinement's and a caller's own. The graphs
    share one private pool: every output that is read afterwards lands in
    the static buffers, so each graph's temporaries are dead at the end of
    its replay. A buffer that is allocated anew (the operator outgrew its
    buffers, or a new grid) drops every graph (``growths`` counts such
    buffers); they are captured again as the solve reaches them.
    ``captured`` holds every key captured at least once, ``capture_ms`` and
    ``pool_bytes`` add up over the captures. The runner holds no reference
    to its kit (``runner_for`` keys runners weakly on their kit).
    """

    def __init__(self, graph_route: bool = False):
        self.graph_route = graph_route
        self.V = self.yc = self.y_host = self.out = self.out_host = None
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
        """The [m+1, n] basis (and the coefficient and output buffers),
        allocated at the first call and whenever m, n or the dtype
        change."""
        V = self.V
        if V is None or V.shape != (m + 1, n) or V.dtype != dtype or (
                V.device != device):
            if V is not None:
                self.drop_graphs()
            pin = device.type == "cuda"
            self.V = pitched_basis(m + 1, n, dtype, device)
            self.yc = torch.zeros(m, dtype=torch.float64, device=device)
            self.y_host = torch.zeros(m, dtype=torch.float64, pin_memory=pin)
            # a Hessenberg column (up to m + 1 entries) or a step's numbers
            room = max(m + 1, 8)
            self.out = torch.zeros(room, dtype=torch.float64, device=device)
            self.out_host = torch.zeros(room, dtype=torch.float64,
                                        pin_memory=pin)
        return self.V

    # -- the segments --------------------------------------------------
    def arnoldi(self, j, A, M, dots, axpy, shape) -> torch.Tensor:
        """Arnoldi step j in place: w = A(M(V[j])), CGS2 against V[:j+1],
        h = ||w||, V[j+1] = w / h; returns the new Hessenberg column
        [c1 + c2, h] (j + 2 entries, float64)."""
        V = self.V
        w = A(M(V[j].view(shape))).reshape(-1)
        Vj = V[:j + 1]
        c1 = dots(Vj, w)
        w = axpy(c1, Vj, w)
        c2 = dots(Vj, w)
        w = axpy(c2, Vj, w)
        h = torch.sqrt(dots(w[None], w)[0])
        # happy breakdown keeps a zero vector; its column is never used
        V[j + 1] = w * inv_norm(h).to(w.dtype)
        return torch.cat([c1 + c2, h[None]])

    def segment(self, key: tuple, body, graphed: bool) -> list:
        """One segment of a solve: ``body`` (device work over the static
        buffers, returning the float64 column or the 0-d tensors the host
        reads next) run directly, or as a replay of its graph (captured at
        its first use, whose warm-up runs it). Its outputs go into ``out``
        in float64 (exact for every value read) and on to ``out_host`` by
        one non-blocking copy; returns them as Python floats after one
        stream sync. Counted in GMRES_COUNTS for an Arnoldi step (key
        ``("arnoldi", j)``), in STEP_COUNTS otherwise."""
        counts = GMRES_COUNTS if key[0] == "arnoldi" else STEP_COUNTS
        if not graphed:
            n = self._emit(body)
            counts["eager"] += 1
        elif key in self.graphs:
            graph, launched, nodes, n = self.graphs[key]
            graph.replay()
            add_launch_counts(launched)
            counts["replays"] += 1
            counts["replayed_kernels"] += nodes
        else:
            self.graphs[key] = graph, launched, nodes, n = self._capture(
                key, lambda: self._emit(body))
            counts["captures"] += 1
            counts["eager"] += 1
            counts["captured_kernels"] += nodes
            if key in self.captured:
                counts["recaptures"] += 1
            self.captured.add(key)
        self._sync()
        return self.out_host[:n].tolist()

    def _emit(self, body) -> int:
        vals = body()
        if not isinstance(vals, torch.Tensor):
            if not vals:
                return 0
            vals = torch.stack([v.to(torch.float64) for v in vals])
        n = vals.numel()
        self.out[:n] = vals
        self.out_host[:n].copy_(self.out[:n], non_blocking=True)
        return n

    def _sync(self) -> None:
        if self.out.is_cuda:
            torch.cuda.current_stream(self.out.device).synchronize()

    def _capture(self, key, fn):
        """Run ``fn`` once on a side stream (the warm-up: the work of this
        call), then capture it on that stream into a CUDA graph in the
        runner's pool. basis_dots' scratch of that stream is sized for the
        whole basis first and may not grow afterwards. Returns (graph, the
        wrapper launches a replay stands for, its kernel nodes, what the
        warm-up returned). Raises DeviceUnavailable without a card and
        whatever the capture raises: there is no fallback."""
        dev = self.V.device
        if not torch.cuda.is_available() or dev.type != "cuda":
            raise DeviceUnavailable(
                f"a CUDA graph of the segment {key!r} needs a card; the "
                f"basis is on {dev}")
        t0 = time.perf_counter()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side = self.stream
        reserve_dots_scratch(dev, side.cuda_stream, self.V.shape[0])
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        # kept until instantiated, so that its kernel nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                fn()
        finally:
            # the capture launched nothing: take its counts back
            after = launch_counts()
            launched = {k: n - before[k] for k, n in after.items()
                        if n != before[k]}
            add_launch_counts({k: -n for k, n in launched.items()})
        nodes = kernel_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms += 1e3 * (time.perf_counter() - t0)
        return graph, launched, nodes, out


def kernel_nodes(graph) -> int:
    """The kernel nodes of a captured CUDA graph (made with
    ``keep_graph``), counted through libcuda's graph API: the kernels one
    replay runs, PyTorch's own among them."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    count = 0
    for node in nodes[:n.value]:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        count += kind.value == 0      # CU_GRAPH_NODE_TYPE_KERNEL
    return count


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
    scaling 1 / (1 - dt diag)). Every tensor a segment reads is the
    runner's or the kit's, so a graph captured over one System serves the
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
        """(A, M, dots, axpy) for ``cycles``."""
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
             c_max: float) -> list:
    """A step's solve set up from C (after the BCs), dt in ``run.dt``: the
    Jacobi scaling into ``run.inv_diag``, b = ``sys.rhs(C)`` into
    ``run.b``, the start (``start``) into ``run.x``. Returns their
    ``norms``."""
    run.inv_diag.copy_(1.0 / (1.0 - run.dt * sys.diag))
    run.b.copy_(sys.rhs(C))
    run.x.copy_(start(sys, C, x0, c_max))
    return norms(run, sys.fns())


def _cycle_start(run: GmresRunner, fns) -> list:
    """r = b - A x, beta = ||r||, V[0] = r / beta (0 below 1e-30, on the
    device as ``inv_norm``); reads beta."""
    A, _, dots, _ = fns
    r = (run.b - A(run.x)).reshape(-1)
    beta = fnorm_t(dots, r)
    run.V[0] = r * inv_norm(beta).to(r.dtype)
    return [beta]


def _cycle_end(run: GmresRunner, fns, j: int) -> list:
    """A cycle of j Arnoldi steps ends: the coefficients -y from their
    pinned host buffer, xn = x + M(sum_i y_i V[i]) and ||b - A xn|| (j >
    0); for j = 0 the residual of x itself. Reads that residual."""
    A, M, dots, axpy = fns
    if j == 0:
        return [fnorm_t(dots, run.b - A(run.x))]
    run.yc[:j].copy_(run.y_host[:j], non_blocking=True)
    dx = M(axpy(run.yc[:j], run.V[:j]).view(run.x.shape))
    torch.add(run.x, dx, out=run.xn)
    return [fnorm_t(dots, run.b - A(run.xn))]


def cycles(run: GmresRunner, fns, tol: float, restart: int, maxiter: int,
           b_norm: float, r_norm: float, graphed: bool):
    """GMRES's restart cycles from the runner's b and x, whose norms
    (``norms``) the caller has read. Leaves the answer in ``run.x`` and
    returns (relative residual, cycles). ``maxiter`` counts total inner
    iterations as in Eigen (pd_ard_implicit.cpp:399-401): cycles =
    ceil(maxiter / restart)."""
    m = restart
    n_cycles = max(1, -(-maxiter // restart))
    steps = (*fns, run.x.shape)
    safe_b = max(b_norm, 1e-300)
    res = r_norm / safe_b
    k = 0
    while k < n_cycles and res > tol:
        GMRES_COUNTS["cycles"] += 1
        (beta,) = run.segment(("start",), lambda: _cycle_start(run, fns),
                              graphed)
        R = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.ones(m)
        sn = np.zeros(m)
        j = 0
        done = beta / safe_b < tol
        while j < m and not done:
            hcol = np.zeros(m + 1)
            hcol[:j + 2] = run.segment(
                ("arnoldi", j), lambda: run.arnoldi(j, *steps), graphed)
            c, s = _givens(hcol, cs, sn, j)
            cs[j], sn[j] = c, s
            g_next = -s * g[j]
            g[j + 1] = g_next
            g[j] = c * g[j]
            R[:, j] = hcol
            j += 1
            done = abs(g_next) / safe_b < tol
        if j:
            run.y_host[:j] = torch.from_numpy(-_back_substitute(R, g, j))
        (r_new,) = run.segment(("end", j), lambda: _cycle_end(run, fns, j),
                               graphed)
        res_new = r_new / safe_b
        # monotone restarts: never accept a cycle that raised the residual
        # (a NaN residual is reported, and ends the loop, as in the JAX twin)
        if res_new < res and j:
            run.x.copy_(run.xn)
        res = res_new if math.isnan(res_new) else min(res_new, res)
        k += 1
    return res, k


def solve(run: GmresRunner, sys: System, b_norm: float, r_norm: float,
          tol: float, maxiter: int, graphed: bool) -> float:
    """An implicit step's solve from the runner's b and x (their norms
    read): GMRES to ``tol`` (float64) or, on float32 runs, to max(tol,
    1e-4) and then up to two float64 refinement passes
    (pd_ard_implicit.cpp:399-417 reaches 1e-10 in double): the residual
    from A64, each correction solved in float32 through the same cycles,
    the correction's right-hand side in ``b``, its start 0 in ``x``. The
    answer is ``solution(run, sys)``; returns the relative residual."""
    fns = sys.fns()
    refine = sys.A64 is not None
    res, _ = cycles(run, fns, max(tol, 1e-4) if refine else tol, sys.restart,
                    maxiter, b_norm, r_norm, graphed)
    if not refine:
        return res

    def residual():
        torch.sub(run.b64, sys.A64(run.x64), out=run.r64)
        return vector_norm_t(run.r64, sys.allreduce)

    def first():
        run.b64.copy_(run.b)
        run.x64.copy_(run.x)
        return [vector_norm_t(run.b64, sys.allreduce), residual()]

    def correction():
        run.b.copy_(run.r64)
        run.x.zero_()
        return norms(run, fns)

    def update():
        run.x64.add_(run.x)
        return [residual()]

    bn, rn = run.segment(("refine",), first, graphed)
    b64_norm = max(bn, 1e-300)
    res = rn / b64_norm
    for _ in range(2):
        if not res > tol:
            break
        tol_c = min(max(0.5 * tol / max(res, 1e-300), 1e-4), 0.5)
        cycles(run, fns, tol_c, sys.restart, sys.restart * 2,
               *run.segment(("correct",), correction, graphed), graphed)
        (rn,) = run.segment(("update",), update, graphed)
        res = rn / b64_norm
    return res


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
    ``solve`` (f32 runs refine in f64), and C_new = the answer clamped to
    [0, C_solid_init] on the solved rows, C elsewhere. ``load_rhs`` reads
    the caller's tensors and so runs directly; the solve's segments replay
    CUDA graphs on the runner's graph route unless ``eager`` (the same
    bits). The coupled loop steps through ``coupling.StepRunner`` instead,
    whose head is a graph too. Returns (new state, residual as a float)."""
    run = runner_for(kit)
    sys = prepare(run, system, op, kit, state.C, restart)
    C, c_max = state.C, kit.cfg.C_solid_init
    run.dt.copy_(torch.as_tensor(dt, dtype=C.dtype, device=C.device))
    bn, rn = run.segment(("norms",), lambda: load_rhs(run, sys, C, x0, c_max),
                         False)
    res = solve(run, sys, bn, rn, default_tol(C.dtype) if tol is None
                else tol, maxiter, run.graph_route and not eager)
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
    bn, rn = run.segment(("norms",), lambda: norms(run, fns), False)
    res, k = cycles(run, fns, tol, restart, maxiter, bn, rn, False)
    return run.x.clone(), (res, k)
