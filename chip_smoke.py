#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. Device: the card's name and power limit; build (or load) the four CUDA
   kernels from csrc/ with nvcc.
2. Kernel vs plain: each kernel against its plain PyTorch twin at the
   slice's shapes (the 567 x 347 = 196,749-node fine-calibration grid with
   a real Kit and seeded State; a 26-row basis of 196,749-long vectors),
   twice for identical bits, with median times of both.
3. Main path: ``cli.run`` on config/params_fine_calibration.cfg at full size
   on CUDA, capped by MAIN_CAPS; checks the run and that all four kernels
   launched in it.
4. Kernels vs plain end to end: tests/golden/parity.cfg on CUDA (kernels)
   and on the CPU (plain twins); diagnostics.csv must agree.

Then one JSON line about the kernels, the nvidia-smi line, and the result
line. Imports nothing of JAX. Exits non-zero without a CUDA device or
without the repository beside it.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FINE = os.path.join(ROOT, "config", "params_fine_calibration.cfg")
PARITY = os.path.join(ROOT, "tests", "golden", "parity.cfg")

# Main-path caps: 20,000 iterations for the initial flow solve and 2,000 per
# re-solve; 1,200 s of physics in cycles of at most 20 implicit steps (two
# cycles at the 30 s adaptive-dt ceiling).
MAIN_CAPS = ["flow_max_iters=20000", "flow_max_iters_resolve=2000",
             "T_final=1200", "corrosion_steps_per_check=20"]
# the CPU slice test's flow cap (tests/test_torch_slice.py), in f32
PARITY_CAPS = ["precision=f32", "flow_max_iters=300"]
SEED = 20261016


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, calls, reps=7):
    """Median over ``reps`` of the device time per call of fn(), in ms:
    CUDA events around ``calls`` back-to-back calls, all queued behind a
    ~10 ms spin kernel so the host's launch overhead is hidden and the
    events time the device work only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def seeded(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.tensor(rng.normal(0.0, scale, shape), dtype=dtype,
                        device="cuda")


def phase_kernels(pkg):
    """Phase 2; returns {name: (max_abs_err, ms, plain_ms)}."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    cfg = pkg.Config.load(FINE)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg,
                              grains=pkg.grains.generate(grid, cfg),
                              device="cuda")
    print(f"[kernels] fine-calibration grid {kit.shape} = {grid.N_total} "
          f"nodes, S={kit.S}, mext={kit.mext}, {kit.dtype}")
    rng = np.random.default_rng(SEED)
    fluid = st.node_type == 0
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    st.C = torch.where(st.node_type == 1, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"), 0.0)
    results = {}

    def record(name, err, ok, fn, plain, what):
        k1, k2 = fn(), fn()
        same = all(torch.equal(a, b) for a, b in zip(k1, k2))
        if not same:
            fail(f"{name}: two launches gave different bits")
        ms, plain_ms = median_ms(fn, 20), median_ms(plain, 3)
        print(f"[kernels] {name}: max_abs_err={err:.3e} ({what}) "
              f"repeat-identical={same} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not ok:
            fail(f"{name}: disagrees with its plain version ({what})")
        results[name] = (err, ms, plain_ms)

    # ns2d
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    (r, v), (rp, vp) = kernels.ns2d(*args), kernels.ns2d_plain(*args)
    torch.cuda.synchronize()
    ok = (torch.allclose(r, rp, rtol=1e-6, atol=0.0)
          and torch.allclose(v, vp, rtol=1e-5, atol=1e-9))
    err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
    record("ns2d", err, ok, lambda: kernels.ns2d(*args),
           lambda: kernels.ns2d_plain(*args), "rho rtol 1e-6, v rtol 1e-5 atol 1e-9")

    # matvec2d, on the operator of this state
    op = ai.assemble(st, kit)
    x = torch.tensor(rng.random(kit.shape), dtype=torch.float32, device="cuda")
    mv = (x, op.W, op.diag, op.unknown, kit)
    y, yp = kernels.matvec2d(*mv), kernels.matvec2d_plain(*mv)
    err = float((y - yp).abs().max())
    record("matvec2d", err, err <= 1e-5 * float(yp.abs().max()),
           lambda: (kernels.matvec2d(*mv),), lambda: kernels.matvec2d_plain(*mv),
           "max|dy| <= 1e-5 max|y|")

    # basis kernels: a 26-row basis (restart 25) of 196,749-long vectors
    n = grid.N_total
    V = seeded(rng, (26, n))
    w = seeded(rng, (n,))
    c = seeded(rng, (26,), dtype=torch.float64)
    d, dp = kernels.basis_dots(V, w), kernels.basis_dots_plain(V, w)
    err = float((d - dp).abs().max())
    record("basis_dots", err, torch.allclose(d, dp, rtol=2e-6, atol=0.0),
           lambda: (kernels.basis_dots(V, w),),
           lambda: kernels.basis_dots_plain(V, w), "rtol 2e-6 vs f64 plain sum")
    a, ap = kernels.basis_axpy(c, V, w), kernels.basis_axpy_plain(c, V, w)
    err = float((a - ap).abs().max())
    record("basis_axpy", err, torch.allclose(a, ap, rtol=1e-5, atol=1e-5),
           lambda: (kernels.basis_axpy(c, V, w),),
           lambda: kernels.basis_axpy_plain(c, V, w), "rtol 1e-5 atol 1e-5")
    return results


def run_cli(out_dir, args):
    """cli.run with its console output kept in out_dir/run.log."""
    from pd_mg_pin_corrosion_tpu_torch import cli

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "run.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        solver = cli.run(args + [f"output_dir={out_dir}/out"])
    return solver, np.atleast_1d(np.genfromtxt(
        f"{out_dir}/out/diagnostics.csv", delimiter=",", names=True))


def phase_main(tmp):
    """Phase 3; returns the launch counts of the main path's run."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.time()
    solver, rows = run_cli(os.path.join(tmp, "fine"),
                           [FINE, *MAIN_CAPS, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    st = solver.final_state
    flow_rate = solver.flow_iters / max(solver.flow_seconds, 1e-9)
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps, 1)
    print(f"[main] params_fine_calibration.cfg {' '.join(MAIN_CAPS)}: "
          f"{solver.cycles} cycles, steps per cycle {solver.cycle_steps}, "
          f"{solver.flow_solve_count} flow solves, {solver.flow_iters} flow "
          f"iterations in {solver.flow_seconds:.3f} s, "
          f"{solver.total_dissolved} dissolved, wall {wall:.2f} s")
    print(f"[main] flow iterations/s {flow_rate:.1f}; "
          f"ms per implicit step {step_ms:.3f} "
          f"({solver.total_implicit_steps} steps in {solver.implicit_seconds:.3f} s)")
    print(f"[main] launches {json.dumps(counts)}")
    last = rows[-1]
    print(f"[main] last row: t={last['time_s']:.1f} s loss={last['pin_mass_loss_pct']:.6e} % "
          f"solid={int(last['solid_nodes'])} v_max={last['v_max']:.6e} "
          f"C_max_fluid={last['C_max_fluid']:.6e}")

    checks = {
        "a complete cycle (flow solve, assemble, >= 5 steps, phase change)":
            solver.flow_solve_count >= 1 and len(solver.cycle_steps) >= 1
            and solver.cycle_steps[0] >= 5,
        "finite diagnostics": all(np.isfinite(rows[c]).all()
                                  for c in rows.dtype.names),
        "pin_mass_loss_pct does not decrease":
            bool(np.all(np.diff(rows["pin_mass_loss_pct"]) >= 0.0)),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "every kernel launched": all(v > 0 for v in counts.values()),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
    }
    for what, ok in checks.items():
        print(f"[main] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("main path checks")
    return counts


def phase_parity(tmp):
    """Phase 4: parity.cfg with the kernels on CUDA vs the plain twins on
    the CPU."""
    t0 = time.time()
    gpu, g = run_cli(os.path.join(tmp, "parity_cuda"),
                     [PARITY, *PARITY_CAPS, "--device", "cuda"])
    t1 = time.time()
    cpu, c = run_cli(os.path.join(tmp, "parity_cpu"),
                     [PARITY, *PARITY_CAPS, "--device", "cpu"])
    t2 = time.time()
    same_solid = (len(g) == len(c)
                  and np.array_equal(g["solid_nodes"], c["solid_nodes"]))
    diffs = {}
    if same_solid:
        for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
            rel = np.abs(g[col] - c[col]) / np.maximum(np.abs(c[col]), 1e-300)
            diffs[col] = float(rel.max())
    print(f"[parity] tests/golden/parity.cfg {' '.join(PARITY_CAPS)}: {len(g)} "
          f"rows, cuda {t1 - t0:.2f} s vs cpu {t2 - t1:.2f} s; solid_nodes "
          f"equal: {same_solid}; max rel diff by column {json.dumps(diffs)} "
          f"(limit 1e-4)")
    if not same_solid or max(diffs.values()) > 1e-4:
        fail("parity.cfg: CUDA kernels vs CPU plain path disagree")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    try:
        import pd_mg_pin_corrosion_tpu_torch as pkg
        from pd_mg_pin_corrosion_tpu_torch import grains  # noqa: F401
        from pd_mg_pin_corrosion_tpu_torch.kernels import KERNELS, build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if any(m == "jax" or m.startswith("pd_mg_pin_corrosion_tpu.")
           or m == "pd_mg_pin_corrosion_tpu" for m in sys.modules):
        fail("JAX or the JAX package was imported")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}")
    lib = build.load()
    print(f"[device] kernels {'built' if lib.built else 'loaded'} in "
          f"{lib.seconds:.2f} s: {lib.path}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    measured = phase_kernels(pkg)
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_main(tmp)
        phase_parity(tmp)

    rows = []
    for k in KERNELS:
        err, ms, plain_ms = measured[k.name]
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": counts[k.name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
