"""cycle_loop — the fused coupling cycles' decisions on the device: CUDA
kernel wrapper, plain twin and the layout of its state vector.

Kernel: ``csrc/cycle_qr.cu`` (no TPU kernel: the JAX package runs its
fused cycles as one XLA program, ``coupling.py:184-433``
``coupled_cycles_chunk``, with the flow segment's loop of
``solvers.py:60-150`` inside). One thread runs a mode over the float64
state ``Y`` (``CycleLayout``: the launch's parameters, the carried phase,
inner_k, need_flow, time and flow-segment position, the launch's counts,
the flow segment's iteration and flags, the numbers the device work
before a mode leaves for it, trip counters and per-cycle records), the
bool flags ``CF``, and, around an inner window of implicit steps,
gmres_qr's state ``S`` and flags ``F``. ``cycle_qr_plain`` repeats every
mode with Python floats in the kernel's order; every quantity is a whole
number or a copy, so the two agree bit for bit.

``coupling.CycleRunner`` records the program these decisions gate
(``ops.gmres.GmresRunner.program``).
"""

from __future__ import annotations

import ctypes

import torch

from . import device_loop as dl
from .build import check, load, ptr, stream

# modes (csrc/cycle_qr.cu Mode)
(BEGIN, CYC_START, FLOW_NEXT, FLOW_CHECK, FLOW_END, ASM_END, INNER_START,
 INNER_END, PC_END, OUTER) = range(10)
N_MODES = 10
# scalars, in csrc/cycle_qr.cu's order; the first len(PARAMS) are BEGIN's
# parameters
PARAMS = ("T_FINAL", "MAX_CYCLES", "MAX_INNER", "FLOW_CAP", "FLOW_CAP_INIT",
          "STEP_CAP", "FLOW_ITER_CAP", "OUT_EVERY", "FLOW_STRIDE",
          "FLOW_SOLVES0", "CYCLE_CAP", "TOTAL0", "NREC", "T", "PHASE",
          "INNER_K", "NEED_FLOW", "F_IT", "F_EPS", "F_DT")
SCALARS = PARAMS + (
    "CYCLES", "STEPS", "DISSOLVED", "FLOW_ITERS", "FLOW_SOLVES", "EPS_LAST",
    "DIVERGED", "ANY_SOLID", "EXIT_OUTPUT", "EXIT_FLOW", "EXIT_PACK",
    "MICRO_OPS", "IT", "IT0", "LIM", "CAP_TOTAL", "EPS", "CONV", "DIV",
    "KIND", "CHK_EPS", "CHK_VMAX", "CHK_RMIN", "CHK_RMAX", "CHK_OK",
    "CHK_DIV", "N_DISS", "N_SOLID", "OVERFLOW")
SC = {name: i for i, name in enumerate(SCALARS)}
# trip counters: the outer loop's passes, cycle starts, flow segments, flow
# passes, check iterations, plain blocks of 64 .. 1 iterations, finished
# solves, assemblies, inner windows, phase changes
BLOCKS = (64, 32, 16, 8, 4, 2, 1)
TRIPS = ("pass", "start", "flow", "flowpass", "check",
         *(f"b{b}" for b in BLOCKS), "fin", "asm", "inner", "pc")
TRIP = {name: i for i, name in enumerate(TRIPS)}
# flags: the outer loop goes on, a flow segment runs, the solve is fresh,
# the segment goes on, a check broke, dt is refreshed, the solve finished,
# the operator is assembled
(MORE, FLOW, FRESH, FLOW_GO, BRK, REFRESH, FIN, ASM) = range(8)
N_FLAGS = 8
# micro-op phases (JAX coupling.py:179-181)
PH_START, PH_INNER, PH_PC = range(3)
# flow iterations a segment runs at most (JAX solvers.FLOW_SEGMENT_ITERS)
FLOW_SEGMENT_ITERS = 2000
# gmres_qr's scalars and flag the kernel reads or writes
_G = ("T", "KK", "DISSOLVED", "T_FINAL", "TOTAL0", "STEPS_LEFT", "CAP")


class CycleLayout:
    """Offsets into Y with room for ``nrec`` cycles' and flow solves'
    records (csrc/cycle_qr.cu): the scalars, the trip counters, the steps
    of each cycle, each flow solve's (iterations, eps, converged,
    diverged)."""

    def __init__(self, nrec: int):
        self.nrec = nrec
        self.TRIPS = len(SCALARS)
        self.REC_STEPS = self.TRIPS + len(TRIPS)
        self.REC_FLOW = self.REC_STEPS + nrec
        self.size = self.REC_FLOW + 4 * nrec


def cycle_qr_plain(mode, Y, CF, S, F, sc: int, params=None):
    """The kernel's mode ``mode`` on Y and CF (and gmres_qr's S, F, its
    scalars from ``sc`` on), with Python floats in the kernel's order;
    ``params`` (BEGIN): the PARAMS values."""
    y = Y.tolist()
    cf = CF.tolist()
    tr = len(SCALARS)
    nrec = int(y[SC["NREC"]]) if mode != BEGIN else int(params[SC["NREC"]])
    rec_steps = tr + len(TRIPS)
    rec_flow = rec_steps + nrec
    g_idx = {n: sc + dl.SC_INDEX[n] for n in _G}

    def v(name):
        return y[SC[name]]

    def put(name, val):
        y[SC[name]] = float(val)

    def trip(name):
        y[tr + TRIP[name]] += 1.0

    def more():
        cap = v("CYCLE_CAP") if v("CYCLE_CAP") < v("MAX_CYCLES") else v(
            "MAX_CYCLES")
        return (v("CYCLES") < cap and v("ANY_SOLID") != 0.0
                and v("DIVERGED") == 0.0
                and (v("T") < v("T_FINAL") or v("PHASE") != PH_START)
                and v("STEPS") < v("STEP_CAP")
                and v("FLOW_ITERS") < v("FLOW_ITER_CAP")
                and v("EXIT_OUTPUT") == 0.0 and v("EXIT_FLOW") == 0.0
                and v("EXIT_PACK") == 0.0)

    if mode == BEGIN:
        for i, p in enumerate(params):
            y[i] = float(p)
        for i in range(SC["CYCLES"], len(SCALARS)):
            y[i] = 0.0
        put("ANY_SOLID", 1.0)
        cf = [False] * N_FLAGS
        cf[MORE] = more()
    elif mode == CYC_START:
        nf = v("NEED_FLOW") != 0.0
        cf[FLOW] = nf
        cf[ASM] = not nf
        cf[FIN] = False
        if nf:
            fresh = v("F_IT") == 0.0
            cf[FRESH] = fresh
            it0 = 1 if fresh else int(v("F_IT"))
            put("EPS", 1.0 if fresh else v("F_EPS"))
            initial = v("FLOW_SOLVES0") + v("FLOW_SOLVES") == 0.0
            cap = int(v("FLOW_CAP_INIT") if initial else v("FLOW_CAP"))
            lim = min(it0 + FLOW_SEGMENT_ITERS - 1, cap)
            for name, val in (("IT0", it0), ("IT", it0), ("CAP_TOTAL", cap),
                              ("LIM", lim), ("CONV", 0), ("DIV", 0)):
                put(name, val)
            cf[FLOW_GO] = it0 <= lim
        trip("start")
    elif mode == FLOW_NEXT:
        it = int(v("IT"))
        kind = 0
        if not (it <= 10 or it % 100 == 0):
            end = min((it // 100 + 1) * 100 - 1, int(v("LIM")))
            n = min(end - it + 1, BLOCKS[0])
            kind = 1 + next(i for i, b in enumerate(BLOCKS) if b <= n)
            b = BLOCKS[kind - 1]
            put("IT", it + b)
            cf[FLOW_GO] = it + b <= int(v("LIM"))
        put("KIND", kind)
        trip("flowpass")
        y[tr + TRIP["check"] + kind] += 1.0
    elif mode == FLOW_CHECK:
        it = int(v("IT"))
        conv = v("CHK_OK") != 0.0 and it > 100
        div = v("CHK_DIV") != 0.0
        brk = conv or div
        put("EPS", v("CHK_EPS"))
        put("CONV", 1.0 if conv else 0.0)
        put("DIV", 1.0 if div else 0.0)
        cf[BRK] = brk
        cf[REFRESH] = not brk and it % 200 == 0
        put("IT", it + 1)
        cf[FLOW_GO] = not brk and it + 1 <= int(v("LIM"))
    elif mode == FLOW_END:
        it = int(v("IT"))
        conv, div = v("CONV") != 0.0, v("DIV") != 0.0
        done = conv or div or it > int(v("CAP_TOTAL"))
        put("FLOW_ITERS", v("FLOW_ITERS") + float(it - int(v("IT0"))))
        put("F_EPS", v("EPS"))
        if done:
            k = int(v("FLOW_SOLVES"))
            if k < nrec:
                at = rec_flow + 4 * k
                y[at:at + 4] = [float(it - 1 if conv or div else it),
                                v("EPS"), 1.0 if conv else 0.0,
                                1.0 if div else 0.0]
            put("FLOW_SOLVES", k + 1)
            gcount = int(v("FLOW_SOLVES0")) + k + 1
            put("EXIT_FLOW",
                1.0 if (gcount - 1) % int(v("FLOW_STRIDE")) == 0 else 0.0)
            put("EPS_LAST", v("EPS"))
            if div:
                put("DIVERGED", 1.0)
            put("F_IT", 0.0)
            put("NEED_FLOW", 0.0)
            trip("fin")
        else:
            put("F_IT", it)
        cf[FIN] = done
        cf[ASM] = done
        trip("flow")
    elif mode == ASM_END:
        put("PHASE", PH_INNER)
        put("INNER_K", 0.0)
        put("NEED_FLOW", 0.0)
        put("EXIT_PACK", 1.0 if v("OVERFLOW") != 0.0 else 0.0)
        trip("asm")
    elif mode in (INNER_START, INNER_END):
        gv = S.tolist()
        g = {n: gv[i] for n, i in g_idx.items()}
        f = F.tolist()
        if mode == INNER_START:
            left = v("MAX_INNER") - v("INNER_K")
            cap = v("STEP_CAP") - v("STEPS")
            for name, val in (("T", v("T")), ("KK", 0.0), ("DISSOLVED", 0.0),
                              ("TOTAL0", v("TOTAL0") + v("STEPS")),
                              ("STEPS_LEFT", left), ("CAP", cap)):
                gv[g_idx[name]] = val
            f[dl.STEP] = left > 0.0 and cap > 0.0 and v("T") < g["T_FINAL"]
            S.copy_(torch.tensor(gv, dtype=torch.float64))
            F.copy_(torch.tensor(f, dtype=torch.bool))
        else:
            kk = g["KK"]
            put("T", g["T"])
            put("STEPS", v("STEPS") + kk)
            put("INNER_K", v("INNER_K") + kk)
            gstep = int(v("TOTAL0")) + int(v("STEPS"))
            done = (g["DISSOLVED"] != 0.0 or v("INNER_K") >= v("MAX_INNER")
                    or v("T") >= v("T_FINAL"))
            put("PHASE", PH_PC if done else PH_INNER)
            put("EXIT_OUTPUT", 1.0 if kk > 0.0
                and gstep % int(v("OUT_EVERY")) == 0 else 0.0)
            trip("inner")
    elif mode == PC_END:
        c = int(v("CYCLES"))
        if c < nrec:
            y[rec_steps + c] = v("INNER_K")
        put("CYCLES", c + 1)
        put("DISSOLVED", v("DISSOLVED") + v("N_DISS"))
        put("NEED_FLOW", 1.0 if v("N_DISS") > 0.0 else 0.0)
        put("ANY_SOLID", 1.0 if v("N_SOLID") > 0.0 else 0.0)
        put("PHASE", PH_START)
        trip("pc")
    elif mode == OUTER:
        put("MICRO_OPS", v("MICRO_OPS") + 1.0)
        cf[MORE] = more()
        trip("pass")
    else:
        raise ValueError(f"cycle_qr: unknown mode {mode}")
    Y.copy_(torch.tensor(y, dtype=torch.float64))
    CF.copy_(torch.tensor(cf, dtype=torch.bool))


def layout_of_library() -> tuple:
    """(scalars, trips, flags, parameters, modes) as the kernel counts
    them."""
    out = (ctypes.c_int * 5)()
    load().lib.pd_cycle_qr_layout(out)
    return tuple(out)


def cycle_qr(mode, Y, CF, S, F, sc: int, params=None) -> None:
    """cycle_qr_plain's contract: the one-thread kernel on CUDA tensors (Y
    and S float64, CF and F bool, all contiguous, on one card), the plain
    version on CPU tensors. One launch on the current stream; no host
    read."""
    if all(t.device.type == "cpu" for t in (Y, CF, S, F)):
        return cycle_qr_plain(mode, Y, CF, S, F, sc, params)
    dev = Y.device
    if any(t.device != dev for t in (CF, S, F)) or dev.type != "cuda":
        raise ValueError("cycle_qr: Y, CF, S and F must lie on one card")
    if (Y.dtype != torch.float64 or S.dtype != torch.float64
            or CF.dtype != torch.bool or F.dtype != torch.bool
            or not all(t.is_contiguous() for t in (Y, CF, S, F))
            or Y.numel() < len(SCALARS) + len(TRIPS)
            or CF.numel() < N_FLAGS or F.numel() < dl.N_FLAGS
            or S.numel() < sc + len(dl.SCALARS)):
        raise ValueError("cycle_qr: Y and S must be contiguous float64 "
                         "vectors of their layouts, CF and F bool")
    lib = load().lib
    n = len(PARAMS)
    p = (ctypes.c_double * n)(*(float(x) for x in params)) if (
        mode == BEGIN) else None
    rc = lib.pd_cycle_qr(mode, ptr(Y), ptr(CF), ptr(S), ptr(F), sc, p,
                         n if mode == BEGIN else 0, dev.index, stream(Y))
    check(rc, "cycle_qr")
    cycle_qr.launches += 1


cycle_qr.launches = 0


def walk(run_mode, peek, seed: int = 0, launches: int = 12):
    """Drive cycle_qr's modes in the fused program's order over a few
    launches, with the device work's outputs made up from ``seed``: check
    iterations' numbers (a convergence or a divergence now and then), the
    flow's dt, a pack overflow, the inner windows' steps, times and
    dissolutions, the phase changes' counts (the last solid node gone at
    times). ``run_mode(mode, params, ys, ss)`` writes the Y scalars ``ys``
    and gmres_qr scalars ``ss`` ({name: value}) and runs the mode;
    ``peek()`` returns (Y, CF) as lists after it. With small budgets and
    cadences every mode and every exit is reached. Returns the modes run."""
    import random

    rng = random.Random(seed)
    modes = []
    carried = dict(T=0.0, PHASE=PH_START, INNER_K=0, NEED_FLOW=1, F_IT=0,
                   F_EPS=0.0, F_DT=0.0)
    total0 = solves0 = 0

    def go(mode, params=None, ys=None, ss=None):
        run_mode(mode, params, ys or {}, ss or {})
        modes.append(mode)
        return peek()

    for n in range(launches):
        params = dict(T_FINAL=40.0, MAX_CYCLES=3, MAX_INNER=6, FLOW_CAP=150,
                      FLOW_CAP_INIT=250, STEP_CAP=4,
                      FLOW_ITER_CAP=120, OUT_EVERY=5, FLOW_STRIDE=3,
                      FLOW_SOLVES0=solves0, CYCLE_CAP=1 + n % 2,
                      TOTAL0=total0, NREC=4, **carried)
        y, cf = go(BEGIN, [params[p] for p in PARAMS])
        while cf[MORE]:
            phase = int(y[SC["PHASE"]])
            if phase == PH_START:
                y, cf = go(CYC_START)
                if cf[FLOW]:
                    while cf[FLOW_GO]:
                        y, cf = go(FLOW_NEXT)
                        if y[SC["KIND"]] == 0:
                            u = rng.random()
                            y, cf = go(FLOW_CHECK, ys=dict(
                                CHK_EPS=rng.random() * 1e-3,
                                CHK_VMAX=rng.random(),
                                CHK_RMIN=rng.random(), CHK_RMAX=rng.random(),
                                CHK_OK=float(u < 0.3), CHK_DIV=float(
                                    u > 0.995)))
                    y, cf = go(FLOW_END, ys=dict(F_DT=rng.random() * 1e-6))
                if cf[ASM]:
                    y, cf = go(ASM_END, ys=dict(
                        OVERFLOW=float(rng.random() < 0.15)))
            elif phase == PH_INNER:
                y, cf = go(INNER_START)
                left = min(y[SC["MAX_INNER"]] - y[SC["INNER_K"]],
                           y[SC["STEP_CAP"]] - y[SC["STEPS"]])
                kk = rng.randint(1, int(left))
                y, cf = go(INNER_END, ss=dict(
                    KK=float(kk), T=y[SC["T"]] + kk * rng.random(),
                    DISSOLVED=float(rng.random() < 0.3)))
            else:
                y, cf = go(PC_END, ys=dict(
                    N_DISS=float(rng.randint(0, 3)),
                    N_SOLID=float(rng.random() > 0.05)))
            y, cf = go(OUTER)
        carried = {k: y[SC[k]] for k in carried}
        total0 += int(y[SC["STEPS"]])
        solves0 += int(y[SC["FLOW_SOLVES"]])
        if y[SC["ANY_SOLID"]] == 0.0:
            break
    return modes
