#!/usr/bin/env python3
"""gmres_qr's modes on the card, each with the scalar work of GMRES around
it, against a chain floor and a library call.

    python3 scripts/gmres_qr_modes_torch.py [--tree DIR] [--bodies]

Imports the port from DIR (default: the repository holding this script),
so that one call can time another commit's tree whose ``gmres_qr`` takes
the raw dot products, unpacked beside this one with ``git archive``, next
to this one, in turns. A mode with the callers' scalar work around it is
its launch plus, for START and ARNOLDI, the one N-sized ``torch.mul``
into the basis. Cases, at the fine-calibration grid's N = 196,749
float32: an Arnoldi step at j = 0, 12 and 24 of GMRES(25) (from after the
self-dot to before the next gate's handle kernel), a cycle's START and
ACCEPT, the scalar modes (BEGIN, HEAD, REF_FIRST, CORRECT, UPDATE, TAIL)
alone, and FINISH (the back-substitution) at m = 25 and m = 50, also
timed eagerly (64 calls behind a spin kernel, by CUDA events) beside
``torch.linalg.solve_triangular`` timed the same way. Each case is
captured 64 times into one CUDA graph and timed by CUDA events over
replays (median of 7 rounds of 10 replays); its graph nodes a run are
counted at capture. The chain floor of a mode is its longest chain of
dependent float64 operations times the latency of one dependent float64
add, measured in the same process by a one-thread loop (a kernel built
here with nvcc into build/gmres_qr_modes/). The bound is the mode's
unique bytes over 3.35 TB/s.

``--bodies`` also records one graphed implicit step (the step loop's
program) on each of chip_smoke.py's four FLOW_CASES grids and prints the
kernel nodes captured into the bodies of the Arnoldi steps j = 0, 1 and
m - 1 and the whole program's.

Prints the card's name and power limit, then one JSON line a case. Needs
a CUDA device; imports nothing of JAX.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_RATE = 3.35e12
N = 196_749
# a one-thread chain of dependent float64 adds (kind 0) or products
LATENCY_SRC = r"""
#include <cuda_runtime.h>
__global__ void chain_kernel(int kind, long long n, double a, double b,
                             double* out, long long* cycles) {
  double x = a;
  const long long t0 = clock64();
  if (kind == 0) {
    for (long long i = 0; i < n; ++i) {
#pragma unroll
      for (int u = 0; u < 16; ++u) x = x + b;
    }
  } else {
    for (long long i = 0; i < n; ++i) {
#pragma unroll
      for (int u = 0; u < 16; ++u) x = x * b;
    }
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}
extern "C" int pd_f64_chain(int kind, long long n, double a, double b,
                            double* out, long long* cycles, void* stream) {
  chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, n, a, b, out, cycles);
  return static_cast<int>(cudaGetLastError());
}
"""


def latency_ns(build):
    """(ns, cycles) of one dependent float64 add and of one product: the
    median of 5 launches of 2^20 dependent operations on one thread, by
    CUDA events and by clock64."""
    out_dir = os.path.join(ROOT, "build", "gmres_qr_modes")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "f64_chain.cu")
    so = os.path.join(out_dir, "libf64_chain.so")
    with open(src, "w") as f:
        f.write(LATENCY_SRC)
    subprocess.run([build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.pd_f64_chain.restype = ctypes.c_int
    lib.pd_f64_chain.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_double, ctypes.c_double,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    n = 1 << 16
    res = []
    for kind, a, b in ((0, 1.0, 1e-9), (1, 1.0, 1.0 + 1e-9)):
        times, cycles = [], []
        for _ in range(6):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = lib.pd_f64_chain(kind, n, a, b, out.data_ptr(),
                                  cyc.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
            e1.record()
            e1.synchronize()
            if rc != 0:
                sys.exit(f"f64_chain launch failed ({rc})")
            times.append(1e6 * e0.elapsed_time(e1) / (16 * n))
            cycles.append(int(cyc) / (16 * n))
        res.append((statistics.median(times[1:]),
                    statistics.median(cycles[1:])))
    return res


def graph_ms(seq, reps=64, replays=10, rounds=7):
    """(ms a run of seq(), nodes a run, kernel nodes a run): seq()
    captured ``reps`` times into one CUDA graph, timed by CUDA events
    around ``replays`` replays, the median of ``rounds``."""
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        seq()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(reps):
            seq()
    kinds = gmres.node_kinds(g.raw_cuda_graph())
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        for _ in range(replays):
            g.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / (replays * reps))
    return statistics.median(times), len(kinds) / reps, kinds.count(0) / reps


def eager_ms(fn, calls=64, rounds=7):
    """ms a call of fn(), by CUDA events around ``calls`` calls queued
    behind a spin kernel (the median of ``rounds``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def state(dl, m, rng):
    """gmres_qr's state at restart length m mid-cycle: R, g, rotations and
    the column seeded, SAFE_B 1, TOL 1e-9 (no exit), cycle loop 0."""
    lay = dl.QrLayout(m, 4)
    S = torch.zeros(lay.size, dtype=torch.float64)
    S[:lay.YC] = torch.tensor(rng.normal(size=lay.YC))
    ang = torch.tensor(rng.uniform(0.0, 6.28, size=m))
    S[lay.CS:lay.SN] = torch.cos(ang)
    S[lay.SN:lay.H] = torch.sin(ang)
    # R's diagonal away from zero
    for k in range(m):
        S[lay.R + k * (m + 1) + k] = 1.0 + abs(float(S[lay.R + k * (m + 1)
                                                        + k]))
    # no exit, and no diagnostic row or output boundary at any step count
    for name, v in (("SAFE_B", 1.0), ("TOL", 1e-9), ("RES", 1.0),
                    ("NCYC", 1e9), ("COPY", 0.0), ("BN", 2.0), ("RN", 1.0),
                    ("B64N", 2.0), ("TOL_FINAL", 1e-9), ("TOTAL0", 1.0),
                    ("STEPS_LEFT", 1e9), ("CAP", 1e9), ("T_FINAL", 1e30),
                    ("BATCH", 1e9), ("DIAG_EVERY", 2.0 ** 30),
                    ("OUT_EVERY", 2.0 ** 30)):
        S[lay.sc(name)] = v
    F = torch.zeros(lay.n_flags, dtype=torch.bool)
    return lay, S.cuda(), F.cuda()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--bodies", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gmres_qr_modes_torch.py needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np

    from pd_mg_pin_corrosion_tpu_torch.kernels import build
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    label = os.path.relpath(tree, ROOT) if tree != ROOT else "."
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"{smi}; tree {label}")
    build.load()
    (add_ns, add_cyc), (mul_ns, mul_cyc) = latency_ns(build)
    print(json.dumps({"tree": label, "case": "f64_latency",
                      "add_ns": add_ns, "add_cycles": add_cyc,
                      "mul_ns": mul_ns, "mul_cycles": mul_cyc}))
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=N), dtype=torch.float32, device="cuda")
    V = torch.zeros(26, N, dtype=torch.float32, device="cuda")
    scale = torch.zeros(1, dtype=torch.float32, device="cuda")
    rr = torch.tensor([0.49], dtype=torch.float64, device="cuda")

    def emit(case, m, seq, chain, nbytes, library=None):
        ms, nodes, knodes = graph_ms(seq)
        # a mode with a library call is also timed eagerly beside it, the
        # same way
        lib_ms = eager_ms(library) if library is not None else None
        seq_ms = eager_ms(seq) if library is not None else None
        print(json.dumps({
            "tree": label, "case": case, "m": m, "ms": ms, "nodes": nodes,
            "kernel_nodes": knodes, "eager_ms": seq_ms,
            "chain_ops": chain, "floor_ms": chain * add_ns * 1e-6,
            "bound_ms": 1e3 * nbytes / HBM_RATE, "library_ms": lib_ms}))

    m = 25
    lay, S, F = state(dl, m, rng)
    for j in (0, 12, 24):
        c1 = torch.tensor(rng.normal(size=j + 1), device="cuda")
        c2 = torch.tensor(1e-3 * rng.normal(size=j + 1), device="cuda")
        def seq(j=j, c1=c1, c2=c2):
            dl.gmres_qr(dl.ARNOLDI, j, S, F, m, c1=c1, c2=c2, dot=rr,
                        scale=scale)
            torch.mul(w, scale, out=V[j + 1])

        # the column from c1 + c2, j rotations of 2 dependent operations,
        # the new rotation (a product, a sum, a square root, a division),
        # g's update and the exit test's division
        emit(f"arnoldi_j{j}", m, seq, 2 * j + 7,
             8 * (2 * (j + 1) + 2 * j + 5) + 8 * (2 * (j + 2) + 8)
             + 8 * N)

    def start():
        dl.gmres_qr(dl.START, 0, S, F, m, dot=rr, scale=scale)
        torch.mul(w, scale, out=V[0])

    # the square root, then the exit test's division or the scale's
    emit("start", m, start, 3, 8 * (3 * m + 8) + 8 * N)

    def accept():
        S[lay.sc("RNEW")].copy_(rr[0])
        dl.gmres_qr(dl.ACCEPT, 0, S, F, m)

    emit("accept", m, accept, 3, 8 * 12)

    for m in (25, 50):
        lay, S, F = state(dl, m, rng)
        S[lay.sc("J")] = float(m)
        R = S[:lay.G].view(m, m + 1).T[:m, :m].contiguous()
        g = S[lay.G:lay.G + m].clone()
        # a product and the n - 1 - i ascending adds of each row i below
        # the last, a subtraction and a division a row
        emit("finish", m, lambda m=m, S=S, F=F: dl.gmres_qr(
            dl.FINISH, 0, S, F, m),
             m * (m - 1) // 2 + (m - 1) + 2 * m,
             8 * (m * (m + 1) // 2 + 2 * m),
             library=lambda R=R, g=g: torch.linalg.solve_triangular(
                 R, g[:, None], upper=True))

    # the scalar modes, lane 0 alone (BEGIN: the step's
    # parameters; TAIL after a refined step)
    m = 25
    lay, S, F = state(dl, m, rng)
    params = (0.0, 1e30, 1e-4, 1e-9, 8, 1, 10 ** 9, 10 ** 9, 10 ** 9,
              2 ** 30, 2 ** 30)
    # (mode, j, its longest chain: BEGIN t0 < T_final; HEAD and CORRECT
    # max, division, comparison; REF_FIRST max, division, then tol_c's
    # max, division, max, min; UPDATE the same without the first max;
    # TAIL t + dt, then the comparison with T_final)
    for name, j, chain in (("BEGIN", 0, 1), ("HEAD", 0, 3),
                           ("REF_FIRST", 0, 6), ("CORRECT", 0, 3),
                           ("UPDATE", 0, 5), ("TAIL", 1, 2)):
        mode = getattr(dl, name)
        emit(name.lower(), m, lambda mode=mode, j=j: dl.gmres_qr(
            mode, j, S, F, m, params if mode == dl.BEGIN else None), chain,
             8 * 24)

    if args.bodies:
        bodies(tree, label)


def bodies(tree, label):
    """The kernel nodes captured into the Arnoldi steps' bodies of one
    graphed implicit step on each FLOW_CASES grid of the tree's
    chip_smoke.py."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import pd_mg_pin_corrosion_tpu_torch as pkg
    from pd_mg_pin_corrosion_tpu_torch import coupling
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for

    for name in cs.FLOW_CASES:
        kit, st = cs.flow_case(pkg, name)
        op = ops_for(kit).assemble(st, kit, coupling.volume_loss_fraction(
            st, kit))
        stepper = coupling.step_runner_for(kit)
        stepper.begin(st, op, kit, st.C)
        stepper.step(kit)
        torch.cuda.synchronize()
        run = stepper.run
        lay = run.lay
        for key, prog in run.graphs.items():
            per = {j: prog.tally[lay.arn(0) + j][1]
                   for j in (0, 1, lay.m - 1)
                   if lay.arn(0) + j in prog.tally}
            print(json.dumps({"tree": label, "case": "bodies", "grid": name,
                              "program": str(key), "m": lay.m,
                              "arnoldi_body_kernel_nodes": per,
                              "program_kernel_nodes": prog.nodes}))
        del kit, st, op, stepper, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
