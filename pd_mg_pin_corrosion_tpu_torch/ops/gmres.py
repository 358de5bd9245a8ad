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
restart cycles a second one. Here the host drives the cycles, and each
Arnoldi step is one fixed sequence of device work over static buffers
(``GmresRunner.arnoldi``: the preconditioner and the operator, both CGS2
sweeps, the norm, the new Hessenberg column and the next basis vector, its
``1 / h`` taken on the device in float64), followed by one read of the
new column. On the card that sequence is captured into a CUDA graph per
step index j (``GmresRunner.capture``) and replayed; elsewhere, under a
mesh, or on request (``eager``) it is called directly; both give the same
bits. The (m+1) x m Hessenberg, the rotations and the back-substitution
run on the host in float64 (the JAX package's associative-scan Givens
update was a TPU latency device; the sequential rotation is the same
algebra), as do the cycle start and the solution update, once per cycle.

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
from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch

from ..fields import DeviceUnavailable
from ..kernels import (PackedStencil, add_launch_counts, basis_axpy,
                       basis_axpy_plain, basis_dots, basis_dots_plain,
                       launch_counts, pitched_basis, reserve_dots_scratch)

# Arnoldi steps of every GMRES solve in this process: graph replays, steps
# run directly (the eager route's, and a capture's warm-up step), graph
# captures, captures of a step index whose graph had been dropped (the
# packed operator outgrew its buffers), and restart cycles
GMRES_COUNTS = {"replays": 0, "eager": 0, "captures": 0, "recaptures": 0,
                "cycles": 0}
# room a packed operator's buffers leave for a longer store in a later cycle
PACKED_HEADROOM = 1.25


def reset_gmres_counts() -> None:
    GMRES_COUNTS.update(dict.fromkeys(GMRES_COUNTS, 0))


def vector_norm(x: torch.Tensor, allreduce=None) -> float:
    """2-norm as a Python float (float64 accumulation); with ``allreduce``
    (a mesh's float64 sum) the norm of the vector split over the ranks."""
    if allreduce is None:
        return float(torch.linalg.vector_norm(x.reshape(-1),
                                              dtype=torch.float64))
    x64 = x.reshape(-1).to(torch.float64)
    return float(torch.sqrt(allreduce(torch.dot(x64, x64))))


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

    Holds everything an Arnoldi step reads or writes at a fixed address:
    the Krylov basis ``V`` [m+1, N], the new Hessenberg column ``hcol``
    (float64 on the device) and its copy ``hcol_host`` (pinned on the
    card), and the solve's inputs: the operator (``load``: every tensor of
    it copied into a buffer of its own; a ``PackedStencil``'s slots and
    values into buffers with PACKED_HEADROOM of room, since its stored
    length changes from cycle to cycle while the kernels read only up to
    ``slice_ptr[-1]``), ``dt`` and ``inv_diag`` (``put``). So one graph per
    step index j serves every GMRES call of the run: the main solve and
    the refinement corrections share A, M and the restart length, and the
    right-hand side enters only at the cycle start, which stays eager.

    ``graph_route``: on the card, off a mesh, and not a 3D float64 solve
    (its dense plain matvec walks the unknown rows found by ``nonzero``, a
    host read). ``graphs`` / ``launches``: step j's graph and the kernel
    launches one replay of it stands for. The graphs share one private
    pool: every output that is read afterwards lands in the static
    buffers, so each graph's temporaries are dead at the end of its
    replay. A buffer the operator outgrows is allocated anew, which drops
    every graph (``growths`` counts such buffers); they are captured again
    as the cycles reach them. ``capture_ms`` and ``pool_bytes`` add up over the captures. The
    runner holds no reference to its kit (``runner_for`` keys runners
    weakly on their kit).
    """

    def __init__(self, graph_route: bool = False):
        self.graph_route = graph_route
        self.V = self.hcol = self.hcol_host = None
        self.op = None
        self._source = None        # weak reference to the operator loaded
        self._bufs: dict = {}      # path -> static tensor
        self._caps: dict = {}      # path of a PackedStencil -> capacity
        self.graphs: dict = {}
        self.launches: dict = {}
        self.captured: set = set()   # step indices captured at least once
        self.pool = None
        self.stream = None
        self.growths = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0

    # -- static inputs -------------------------------------------------
    def drop_graphs(self) -> None:
        self.graphs.clear()
        self.launches.clear()
        self.pool = None

    def _buffer(self, path, shape, dtype, device, grow=None):
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
        buf = self._buffer(path, t.shape, t.dtype, t.device)
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
        buf = self._buffer(path, None, t.dtype, t.device, grow=cap)
        buf[:t.numel()].copy_(t)
        return buf

    def load(self, op):
        """The operator in the static buffers: ``op`` copied in, unless it
        is the operator loaded last (once a coupling cycle)."""
        if self._source is None or self._source() is not op:
            self.op = self._static("op", op, {})
            self._source = weakref.ref(op)
        return self.op

    # -- the Arnoldi step ----------------------------------------------
    def basis(self, m: int, n: int, dtype, device) -> torch.Tensor:
        """The [m+1, n] basis (and the column buffers), allocated at the
        first call and whenever m, n or the dtype change."""
        V = self.V
        if V is None or V.shape != (m + 1, n) or V.dtype != dtype or (
                V.device != device):
            if V is not None:
                self.drop_graphs()
            self.V = pitched_basis(m + 1, n, dtype, device)
            self.hcol = torch.zeros(m + 1, dtype=torch.float64, device=device)
            self.hcol_host = torch.zeros(m + 1, dtype=torch.float64,
                                         pin_memory=device.type == "cuda")
        return self.V

    def arnoldi(self, j, A, M, dots, axpy, shape) -> None:
        """Arnoldi step j in place: w = A(M(V[j])), CGS2 against V[:j+1],
        h = ||w||, the column [c1 + c2, h] into ``hcol`` and its copy
        ``hcol_host``, V[j+1] = w / h. What a graph captures."""
        V = self.V
        w = A(M(V[j].view(shape))).reshape(-1)
        Vj = V[:j + 1]
        c1 = dots(Vj, w)
        w = axpy(c1, Vj, w)
        c2 = dots(Vj, w)
        w = axpy(c2, Vj, w)
        h = torch.sqrt(dots(w[None], w)[0])
        self.hcol[:j + 2] = torch.cat([c1 + c2, h[None]])
        # happy breakdown keeps a zero vector; its column is never used
        V[j + 1] = w * inv_norm(h).to(w.dtype)
        self.hcol_host[:j + 2].copy_(self.hcol[:j + 2], non_blocking=True)

    def step(self, j, fns, graphed: bool) -> np.ndarray:
        """Arnoldi step j (``fns`` = (A, M, dots, axpy, shape)): a replay
        of its graph (captured at its first use, whose warm-up runs this
        step), or ``arnoldi`` called directly. Returns the new column's
        j + 2 entries once the device has written them."""
        if not graphed:
            self.arnoldi(j, *fns)
            GMRES_COUNTS["eager"] += 1
        elif j in self.graphs:
            self.graphs[j].replay()
            add_launch_counts(self.launches[j])
            GMRES_COUNTS["replays"] += 1
        else:
            self.capture(j, fns)
            GMRES_COUNTS["eager"] += 1
        if self.hcol.is_cuda:
            torch.cuda.current_stream(self.hcol.device).synchronize()
        return self.hcol_host[:j + 2].numpy()

    def capture(self, j, fns) -> None:
        """Run Arnoldi step j once on a side stream (the warm-up: this
        step), then capture it on that stream into ``graphs[j]``, in the
        runner's pool. basis_dots' scratch of that stream is sized for the
        whole basis first and may not grow afterwards. Raises
        DeviceUnavailable without a card and whatever the capture raises:
        there is no fallback."""
        dev = self.V.device
        if not torch.cuda.is_available() or dev.type != "cuda":
            raise DeviceUnavailable(
                f"a CUDA graph of an Arnoldi step needs a card; the basis "
                f"is on {dev}")
        t0 = time.perf_counter()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side = self.stream
        reserve_dots_scratch(dev, side.cuda_stream, self.V.shape[0])
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.arnoldi(j, *fns)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                self.arnoldi(j, *fns)
        finally:
            # the capture launched nothing: take its counts back
            after = launch_counts()
            launched = {k: n - before[k] for k, n in after.items()
                        if n != before[k]}
            add_launch_counts({k: -n for k, n in launched.items()})
        torch.cuda.synchronize(dev)
        self.graphs[j] = graph
        self.launches[j] = launched
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms += 1e3 * (time.perf_counter() - t0)
        GMRES_COUNTS["captures"] += 1
        if j in self.captured:
            GMRES_COUNTS["recaptures"] += 1
        self.captured.add(j)


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


def gmres(A, b, x0, *, tol: float, restart: int, maxiter: int, M=None,
          flat_kernels: bool = False, allreduce=None, runner=None,
          graphed: bool = False):
    """Solve A x = b. Returns (x, (residual, n_cycles)) with the relative
    residual ||b - A x|| / ||b|| as a float.

    A: linear operator (function), M: right preconditioner (function).
    ``maxiter`` counts total inner iterations as in Eigen
    (pd_ard_implicit.cpp:399-401): cycles = ceil(maxiter / restart).
    ``allreduce`` sums a float64 tensor over the ranks of a mesh whose
    ranks each hold a slab of the vectors: every dot (CGS2 coefficients,
    norms) is the local ``basis_dots`` summed by it before its
    ``basis_axpy``, so every rank takes the same Arnoldi steps.
    ``runner``: the GmresRunner whose basis the solve uses (a fresh one
    by default); with ``graphed`` its Arnoldi steps are graph replays, so
    A and M must read only the runner's static buffers and the kit's
    tensors.
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    if graphed and allreduce is not None:
        raise ValueError("gmres: a mesh's dots reduce on the host; its "
                         "Arnoldi steps cannot be graphed")
    dots = basis_dots if flat_kernels else basis_dots_plain
    if allreduce is not None:
        local_dots = dots

        def dots(V, w):
            return allreduce(local_dots(V, w))
    axpy = basis_axpy if flat_kernels else basis_axpy_plain
    shape = b.shape
    m = restart
    n_cycles = max(1, -(-maxiter // restart))
    N = b.numel()

    def fnorm(v):
        v = v.reshape(-1)
        return float(torch.sqrt(dots(v[None], v)[0]))

    b_norm = fnorm(b)
    safe_b = max(b_norm, 1e-300)
    run = GmresRunner() if runner is None else runner
    V = run.basis(m, N, b.dtype, b.device)
    fns = (A, M, dots, axpy, shape)

    def arnoldi_cycle(x):
        GMRES_COUNTS["cycles"] += 1
        r = (b - A(x)).reshape(-1)
        beta = fnorm(r)
        inv_beta = 1.0 / max(beta, 1e-300) if beta > 1e-30 else 0.0
        V[0] = r * inv_beta

        R = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.ones(m)
        sn = np.zeros(m)
        j = 0
        done = beta / safe_b < tol
        while j < m and not done:
            hcol = np.zeros(m + 1)
            hcol[:j + 2] = run.step(j, fns, graphed)
            c, s = _givens(hcol, cs, sn, j)
            cs[j], sn[j] = c, s
            g_next = -s * g[j]
            g[j + 1] = g_next
            g[j] = c * g[j]
            R[:, j] = hcol
            j += 1
            done = abs(g_next) / safe_b < tol

        if j == 0:
            return x
        y = _back_substitute(R, g, j)
        c = torch.tensor(-y, dtype=torch.float64, device=b.device)
        dx = M(axpy(c, V[:j]).view(shape))
        return x + dx

    res = fnorm(b - A(x0)) / safe_b
    x, k = x0, 0
    while k < n_cycles and res > tol:
        x_new = arnoldi_cycle(x)
        res_new = fnorm(b - A(x_new)) / safe_b
        # monotone restarts: never accept a cycle that raised the residual
        # (a NaN residual is reported, and ends the loop, as in the JAX twin)
        if res_new < res:
            x = x_new
        res = res_new if math.isnan(res_new) else min(res_new, res)
        k += 1
    return x, (res, k)
