"""device_loop — GMRES's scalar decisions on the device: CUDA kernel wrapper,
plain twin, the layout of its state vector, and the conditional CUDA graphs
whose flags it sets.

Kernel: ``csrc/gmres_qr.cu`` (no TPU kernel: the JAX package decides its
solve loops on the device through XLA, ``ops/gmres.py:136-259`` and
``coupling.py:113-175``). One warp runs a mode over the float64 state
``S`` (``QrLayout``) and the bool flags ``F``: a cycle's start and the
Givens update after an Arnoldi step (each from the raw dot products: the
norm, the Hessenberg column and the new basis vector's scale, which the
caller multiplies into V), the back-substitution at a cycle's end, the
restart's acceptance, the refinement passes, an implicit step's start
and its end (the exits and diagnostic rows of a chunk of steps).
``gmres_qr_plain`` repeats every mode with Python floats in the kernel's
order, so the two agree bit for bit.

``csrc/cond_graph.cu`` assembles CUDA graphs with IF nodes out of pieces
that PyTorch captured (``CondGraph``); ``ops.gmres.GmresRunner`` records its
gated programs through it.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch

from .build import check, load, ptr, stream

# modes (csrc/gmres_qr.cu Mode)
(BEGIN, HEAD, START, ARNOLDI, FINISH, ACCEPT, REF_FIRST, CORRECT, UPDATE,
 TAIL) = range(10)
# scalars, in csrc/gmres_qr.cu's order (offsets from QrLayout.SC)
SCALARS = ("J", "K", "NCYC", "TOL", "SAFE_B", "RES", "BETA", "RNEW", "BN",
           "RN", "B64N", "REFRES", "TOLC", "DT", "NBELOW", "LOSS", "SOLID",
           "VMAX", "CMAX", "T", "KK", "DISSOLVED", "MAXRES", "NROWS",
           "RESSTEP", "TOL_MAIN", "TOL_FINAL", "NCYC_MAIN", "T_FINAL",
           "TOTAL0", "STEPS_LEFT", "CAP", "BATCH", "DIAG_EVERY", "OUT_EVERY",
           "COPY")
SC_INDEX = {name: i for i, name in enumerate(SCALARS)}
# flags: a cycle is under way, an Arnoldi step runs next, the cycle's
# answer is taken, a refinement pass runs, the step runs
ACTIVE, RUNNING, TAKE, GO, STEP = range(5)
N_FLAGS = 5
# restart-cycle loops a step holds (the main solve's, the two refinement
# corrections'), each with its own trip counters; then the step's
COPIES = 3
TRIP_NAMES = ("head", "first", "correct", "update", "tail")


class QrLayout:
    """Offsets into S for restart length m (csrc/gmres_qr.cu Lay):
    R [(m+1) x m] column-major, g, cs, sn, the Arnoldi column h, the
    coefficients yc (-y), the scalars, the trip counters (of cycle loop c:
    Arnoldi step j at ``arn(c) + j``, a cycle end after j steps at
    ``end(c) + j``, cycles at ``cyc(c)``, accepted restarts at
    ``take(c)``; the step's by TRIP_NAMES, offsets from TRIPS) and
    ``cap`` diagnostic rows of (t, loss, solid, v_max, C_max)."""

    def __init__(self, m: int, cap: int = 1):
        self.m, self.cap = m, cap
        self.R = 0
        self.G = self.R + (m + 1) * m
        self.CS = self.G + m + 1
        self.SN = self.CS + m
        self.H = self.SN + m
        self.YC = self.H + m + 1
        self.SC = self.YC + m
        self.TRIPS = self.SC + len(SCALARS)
        self.n_trips = COPIES * (2 * m + 3) + len(TRIP_NAMES)
        self.ROWS = self.TRIPS + self.n_trips
        self.size = self.ROWS + 5 * cap
        self.n_flags = N_FLAGS
        self.trip = {name: COPIES * (2 * m + 3) + i
                     for i, name in enumerate(TRIP_NAMES)}

    def arn(self, c: int) -> int:
        return c * (2 * self.m + 3)

    def end(self, c: int) -> int:
        return self.arn(c) + self.m

    def cyc(self, c: int) -> int:
        return self.arn(c) + 2 * self.m + 1

    def take(self, c: int) -> int:
        return self.arn(c) + 2 * self.m + 2

    def loop_trips(self, c: int) -> range:
        """The trip counters of cycle loop c."""
        return range(self.arn(c), self.arn(c) + 2 * self.m + 3)

    def sc(self, name: str) -> int:
        return self.SC + SC_INDEX[name]


def _py_max(a, b):
    return b if b > a else a


def _py_min(a, b):
    return b if b < a else a


def _torch_sqrt(x, device):
    """torch.sqrt of the float64 x on ``device``, as a norm is taken there:
    on the card the IEEE square root the kernel takes; PyTorch's float64
    sqrt on the CPU is not always correctly rounded (at times one ulp off
    math.sqrt), and the CPU route follows it."""
    return float(torch.sqrt(torch.tensor(x, dtype=torch.float64,
                                         device=device)))


def _put_scale(scale, h):
    """``ops.gmres.inv_norm(h)`` (1 / max(h, 1e-300) above 1e-30, else 0; a
    NaN gives 0) into the one-element ``scale``, rounded to its dtype."""
    inv = 1.0 / _py_max(h, 1e-300) if h > 1e-30 else 0.0
    scale.view(-1)[:1].copy_(torch.tensor([inv], dtype=torch.float64))


def _div(a, b):
    """a / b as IEEE float64 divides (Python raises on a zero divisor)."""
    try:
        return a / b
    except ZeroDivisionError:
        if math.isnan(a) or a == 0.0:
            return math.nan
        return math.copysign(math.inf, a) * math.copysign(1.0, b)


def gmres_qr_plain(mode, j, S, F, m, params=None, c1=None, c2=None,
                   dot=None, scale=None):
    """The kernel's mode ``mode`` (step index or flag ``j``) on S and F,
    with Python floats in the kernel's order; ``params`` (BEGIN): t0,
    T_final, tol_main, tol_final, ncyc_main, total0, steps_left, cap,
    batch, diag_every, out_every. START takes the residual's self-dot
    ``dot`` (its first element), ARNOLDI CGS2's coefficient vectors ``c1``
    and ``c2`` (their first j + 1 elements, float64) and the new vector's
    self-dot; both write the basis vector's scale into ``scale`` (one
    element, the basis dtype). ACCEPT takes the candidate's self-dot in
    S's RNEW and leaves its square root there. The self-dots' square roots
    are torch.sqrt's on S's device (``_torch_sqrt``); the tensors may lie
    on the card, where the twin is held against the kernel."""
    L = QrLayout(m)
    v = S.tolist()
    f = F.tolist()
    s0 = L.SC

    def sc(name):
        return s0 + SC_INDEX[name]

    def trip(i):
        v[L.TRIPS + i] += 1.0

    def init(tol, ncyc):
        v[sc("SAFE_B")] = _py_max(v[sc("BN")], 1e-300)
        v[sc("RES")] = v[sc("RN")] / v[sc("SAFE_B")]
        v[sc("K")] = 0.0
        v[sc("NCYC")] = ncyc
        v[sc("TOL")] = tol
        f[ACTIVE] = 0.0 < ncyc and v[sc("RES")] > tol

    def refine(rn):
        v[sc("REFRES")] = res = rn / v[sc("B64N")]
        tol = v[sc("TOL_FINAL")]
        f[GO] = res > tol
        if f[GO]:
            v[sc("TOLC")] = _py_min(_py_max(0.5 * tol / _py_max(res, 1e-300),
                                            1e-4), 0.5)

    def R(i, k):            # column-major
        return L.R + k * (m + 1) + i

    g, cs, sn, h = L.G, L.CS, L.SN, L.H
    c_loop = min(max(int(v[sc("COPY")]), 0), COPIES - 1)
    if mode == BEGIN:
        (t0, T_final, tol_main, tol_final, ncyc_main, total0, steps_left,
         cap, batch, diag_every, out_every) = params
        for name, val in (("T", t0), ("KK", 0.0), ("DISSOLVED", 0.0),
                          ("MAXRES", 0.0), ("NROWS", 0.0),
                          ("TOL_MAIN", tol_main), ("TOL_FINAL", tol_final),
                          ("NCYC_MAIN", ncyc_main), ("T_FINAL", T_final),
                          ("TOTAL0", total0), ("STEPS_LEFT", steps_left),
                          ("CAP", cap), ("BATCH", batch),
                          ("DIAG_EVERY", diag_every),
                          ("OUT_EVERY", out_every)):
            v[sc(name)] = float(val)
        f[STEP] = steps_left > 0 and cap > 0 and t0 < T_final
        f[ACTIVE] = f[RUNNING] = f[TAKE] = f[GO] = False
    elif mode == HEAD:
        init(v[sc("TOL_MAIN")], v[sc("NCYC_MAIN")])
        f[GO] = False
        v[sc("COPY")] = 0.0
        trip(L.trip["head"])
    elif mode == START:
        beta = _torch_sqrt(float(dot.reshape(-1)[0]), S.device)
        v[sc("BETA")] = beta
        _put_scale(scale, beta)
        for i in range(m + 1):
            v[g + i] = 0.0
        v[g] = beta
        for i in range(m):
            v[cs + i] = 1.0
            v[sn + i] = 0.0
        v[sc("J")] = 0.0
        f[RUNNING] = not beta / v[sc("SAFE_B")] < v[sc("TOL")]
        trip(L.cyc(c_loop))
    elif mode == ARNOLDI:
        col = [a + b for a, b in zip(c1.reshape(-1)[:j + 1].tolist(),
                                      c2.reshape(-1)[:j + 1].tolist())]
        v[h:h + j + 1] = col
        v[h + j + 1] = _torch_sqrt(float(dot.reshape(-1)[0]), S.device)
        _put_scale(scale, v[h + j + 1])
        for i in range(j):
            t = v[cs + i] * v[h + i] + v[sn + i] * v[h + i + 1]
            v[h + i + 1] = -v[sn + i] * v[h + i] + v[cs + i] * v[h + i + 1]
            v[h + i] = t
        a, b = v[h + j], v[h + j + 1]
        denom = math.sqrt(a * a + b * b)
        c, s = (a / denom, b / denom) if denom > 1e-300 else (1.0, 0.0)
        v[h + j] = denom
        v[h + j + 1] = 0.0
        for i in range(j + 2):
            v[R(i, j)] = v[h + i]
        v[cs + j], v[sn + j] = c, s
        g_next = -s * v[g + j]
        v[g + j + 1] = g_next
        v[g + j] = c * v[g + j]
        v[sc("J")] = float(j + 1)
        f[RUNNING] = (not abs(g_next) / v[sc("SAFE_B")] < v[sc("TOL")]
                      and j + 1 < m)
        trip(L.arn(c_loop) + j)
    elif mode == FINISH:
        n = int(v[sc("J")])
        y = L.YC
        for i in range(n - 1, -1, -1):
            acc = 0.0
            for k in range(i + 1, n):
                acc = acc + v[R(i, k)] * v[y + k]
            v[y + i] = _div(v[g + i] - acc, v[R(i, i)])
        for i in range(n):
            v[y + i] = -v[y + i]
        trip(L.end(c_loop) + n)
    elif mode == ACCEPT:
        v[sc("RNEW")] = _torch_sqrt(v[sc("RNEW")], S.device)
        res_new = v[sc("RNEW")] / v[sc("SAFE_B")]
        take = res_new < v[sc("RES")] and v[sc("J")] > 0.0
        v[sc("RES")] = (res_new if math.isnan(res_new)
                        else _py_min(res_new, v[sc("RES")]))
        v[sc("K")] = v[sc("K")] + 1.0
        f[ACTIVE] = (v[sc("K")] < v[sc("NCYC")]
                     and v[sc("RES")] > v[sc("TOL")])
        f[TAKE] = take
        if take:
            trip(L.take(c_loop))
    elif mode == REF_FIRST:
        v[sc("B64N")] = _py_max(v[sc("BN")], 1e-300)
        refine(v[sc("RN")])
        trip(L.trip["first"])
    elif mode == CORRECT:
        init(v[sc("TOLC")], 2.0)
        v[sc("COPY")] = v[sc("COPY")] + 1.0
        trip(L.trip["correct"])
    elif mode == UPDATE:
        refine(v[sc("RN")])
        trip(L.trip["update"])
    elif mode == TAIL:
        res = v[sc("REFRES")] if j else v[sc("RES")]
        v[sc("RESSTEP")] = res
        v[sc("T")] = v[sc("T")] + v[sc("DT")]
        kk = v[sc("KK")] + 1.0
        v[sc("KK")] = kk
        dissolved = v[sc("NBELOW")] >= v[sc("BATCH")]
        v[sc("DISSOLVED")] = 1.0 if dissolved else 0.0
        mr = v[sc("MAXRES")]
        v[sc("MAXRES")] = (math.nan if math.isnan(mr) or math.isnan(res)
                           else (res if res > mr else mr))
        step = int(v[sc("TOTAL0")]) + int(kk)
        if step % int(v[sc("DIAG_EVERY")]) == 0:
            row = L.ROWS + 5 * int(v[sc("NROWS")])
            for i, name in enumerate(("T", "LOSS", "SOLID", "VMAX", "CMAX")):
                v[row + i] = v[sc(name)]
            v[sc("NROWS")] = v[sc("NROWS")] + 1.0
        f[STEP] = (kk < v[sc("STEPS_LEFT")] and kk < v[sc("CAP")]
                   and v[sc("T")] < v[sc("T_FINAL")] and not dissolved
                   and step % int(v[sc("OUT_EVERY")]) != 0)
        f[GO] = False
        trip(L.trip["tail"])
    else:
        raise ValueError(f"gmres_qr: unknown mode {mode}")
    S.copy_(torch.tensor(v, dtype=torch.float64))
    F.copy_(torch.tensor(f, dtype=torch.bool))


def _f64_operand(name, t, n, device):
    if (t is None or t.dtype != torch.float64 or t.device != device
            or not t.is_contiguous() or t.numel() < n):
        raise ValueError(f"gmres_qr: {name} must be a contiguous float64 "
                         f"tensor of at least {n} on {device}")
    return ptr(t)


def gmres_qr(mode, j, S, F, m, params=None, c1=None, c2=None, dot=None,
             scale=None):
    """gmres_qr_plain's contract: the one-warp kernel on CUDA tensors (S
    float64, F bool, c1, c2 and dot float64, scale float32 or float64, all
    contiguous, on one card), the plain version on CPU tensors. One launch
    on the current stream; no host read. The kernel refuses (and this
    raises) a restart length whose FINISH staging (R's upper triangle, g
    and y) does not fit one block's shared memory: m above 238."""
    if S.device.type == "cpu" and F.device.type == "cpu":
        return gmres_qr_plain(mode, j, S, F, m, params, c1, c2, dot, scale)
    if S.device != F.device or S.device.type != "cuda":
        raise ValueError(f"gmres_qr: S on {S.device}, F on {F.device}")
    L = QrLayout(m)
    if (S.dtype != torch.float64 or F.dtype != torch.bool
            or not S.is_contiguous() or not F.is_contiguous()
            or S.numel() < L.ROWS or F.numel() < L.n_flags):
        raise ValueError("gmres_qr: S must be contiguous float64 of at least "
                         f"{L.ROWS}, F contiguous bool of at least "
                         f"{L.n_flags}")
    lib, dev, st = load().lib, S.device, stream(S)
    if mode == BEGIN:
        p = params
        rc = lib.pd_gmres_qr_begin(
            m, ptr(S), ptr(F), float(p[0]), float(p[1]), float(p[2]),
            float(p[3]), *(int(x) for x in p[4:]), dev.index, st)
    else:
        raw = [None] * 4
        f32 = 0
        if mode in (START, ARNOLDI):
            if (scale is None or scale.device != dev
                    or scale.dtype not in (torch.float32, torch.float64)
                    or not scale.is_contiguous() or scale.numel() < 1):
                raise ValueError("gmres_qr: scale must be a contiguous "
                                 f"float32 or float64 tensor on {dev}")
            raw[2] = _f64_operand("dot", dot, 1, dev)
            raw[3] = ptr(scale)
            f32 = int(scale.dtype == torch.float32)
        if mode == ARNOLDI:
            if not 0 <= j < m:
                raise ValueError(f"gmres_qr: Arnoldi step {j} of {m}")
            raw[0] = _f64_operand("c1", c1, j + 1, dev)
            raw[1] = _f64_operand("c2", c2, j + 1, dev)
        rc = lib.pd_gmres_qr(mode, j, m, ptr(S), ptr(F), *raw, f32,
                             dev.index, st)
    check(rc, "gmres_qr")
    gmres_qr.launches += 1


gmres_qr.launches = 0


# ---------------------------------------------------------------------------
# CUDA graphs with IF nodes (csrc/cond_graph.cu)
# ---------------------------------------------------------------------------

def _call(name, *args) -> None:
    rc = getattr(load().lib, name)(*args)
    if rc != 0:
        msg = load().lib.pd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: {msg} ({rc}); conditional graph nodes "
                           f"need CUDA 12.4 or later, SWITCH nodes 12.8 (runtime "
                           f"{load().lib.pd_cg_runtime_version()}, torch "
                           f"{torch.__version__} built for "
                           f"{torch.version.cuda})")


class CondGraph:
    """A CUDA graph assembled from captured pieces and IF, WHILE and SWITCH
    nodes: ``add`` appends a copy of a captured graph's nodes (a raw
    ``cudaGraph_t``; node by node, so that a profiler records each run of a
    conditional body) to the level under construction,
    ``begin_if(flag)`` appends the IF node on a
    0-d bool device tensor and makes its body the level under
    construction until ``end_if``. Each level is a chain: every node
    follows the one added before it. ``instantiate`` makes it launchable;
    the graph and its executable are destroyed with this object."""

    def __init__(self, device):
        self.device = torch.device("cuda", torch.cuda.current_device()) if (
            device.index is None) else device
        g = ctypes.c_void_p()
        _call("pd_cg_create", ctypes.byref(g))
        self.graph = g.value
        self.exec = None
        self.levels = [[self.graph, None]]   # [graph, last node]
        self._fin = weakref.finalize(self, _destroy, self.graph, [None])

    def add(self, child: int) -> None:
        level = self.levels[-1]
        node = ctypes.c_void_p()
        _call("pd_cg_add_copy", ctypes.c_void_p(level[0]),
              ctypes.c_void_p(level[1]), ctypes.c_void_p(child),
              self.device.index, ctypes.byref(node))
        level[1] = node.value

    def begin_if(self, flag: torch.Tensor) -> None:
        level = self.levels[-1]
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        _call("pd_cg_add_if", ctypes.c_void_p(level[0]),
              ctypes.c_void_p(level[1]), ptr(flag), ctypes.byref(node),
              ctypes.byref(body))
        level[1] = node.value
        self.levels.append([body.value, None])

    def end_if(self) -> None:
        self.levels.pop()

    def switch(self, value: torch.Tensor, n: int) -> list:
        """Append a SWITCH node on a 0-d float64 device tensor holding a
        whole number: body i runs when it is i. Returns the n body graphs;
        ``begin_case(body)`` / ``end_if`` record into each."""
        level = self.levels[-1]
        node = ctypes.c_void_p()
        bodies = (ctypes.c_void_p * n)()
        _call("pd_cg_add_switch", ctypes.c_void_p(level[0]),
              ctypes.c_void_p(level[1]), ptr(value), n, ctypes.byref(node),
              bodies)
        level[1] = node.value
        return [b for b in bodies]

    def begin_case(self, body: int) -> None:
        self.levels.append([body, None])

    def begin_while(self, flag: torch.Tensor) -> None:
        """Append a WHILE node on a 0-d bool device tensor and make its
        body the level under construction until ``end_while``, which sets
        the loop's handle from the flag again at the body's end."""
        level = self.levels[-1]
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.c_ulonglong()
        _call("pd_cg_add_while", ctypes.c_void_p(level[0]),
              ctypes.c_void_p(level[1]), ptr(flag), ctypes.byref(node),
              ctypes.byref(body), ctypes.byref(handle))
        level[1] = node.value
        self.levels.append([body.value, None, handle.value, flag])

    def end_while(self) -> None:
        body, last, handle, flag = self.levels.pop()
        node = ctypes.c_void_p()
        _call("pd_cg_add_set", ctypes.c_void_p(body), ctypes.c_void_p(last),
              handle, ptr(flag), ctypes.byref(node))

    def instantiate(self) -> None:
        e = ctypes.c_void_p()
        _call("pd_cg_instantiate", ctypes.c_void_p(self.graph),
              ctypes.byref(e), self.device.index)
        self.exec = e.value
        self._fin.detach()
        self._fin = weakref.finalize(self, _destroy, self.graph, [self.exec])

    def launch(self) -> None:
        _call("pd_cg_launch", ctypes.c_void_p(self.exec), self.device.index,
              ctypes.c_void_p(torch.cuda.current_stream(
                  self.device).cuda_stream))


def _destroy(graph, exec_box) -> None:
    try:
        load().lib.pd_cg_destroy(ctypes.c_void_p(graph),
                                 ctypes.c_void_p(exec_box[0]))
    except Exception:   # noqa: BLE001 - interpreter shutdown
        pass
