#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [phase ...]

Phases (each prints its own lines; any failure exits non-zero; with no
argument all of them run, in this order):

1. Device: the card's name and power limit; build (or load) the seven CUDA
   kernels from csrc/ with nvcc (ptxas register / spill lines printed).
2. ``kernels``, 2D kernel vs plain: ns2d, matvec2d, basis_dots and
   basis_axpy against their plain PyTorch twins at the 2D slice's shapes
   (the 567 x 347 = 196,749-node fine-calibration grid with a real Kit and
   seeded State; a 26-row basis of 196,749-long vectors), twice for
   identical bits, with median times of both.
3. ``kernels3d``, 3D kernel vs plain at the flagship shape: ns3d, matvec3d
   (f32 and bf16 weights) and slots3d_f64 on config/params_3d.cfg's
   157 x 82 x 82 = 1,055,668-node grid (S = 178) with a real Kit, seeded
   State and its assembled operator; the same checks, plus bytes per call.
4. ``main``, 2D main path: ``cli.run`` on params_fine_calibration.cfg at
   full size on CUDA, capped by MAIN_CAPS; checks the run and that the 2D
   path's four kernels launched in it.
5. ``main3d``, 3D main path: ``cli.run`` on params_3d.cfg at full size on
   CUDA, capped by MAIN3D_CAPS (one cycle of 20 implicit steps at the 30 s
   dt ceiling, one checkpoint); checks the run and the 3D path's kernels,
   reloads the checkpoint, and holds the 20 rows against the banked
   docs/runs/3d_1M/diagnostics.csv within BANKED_GATES.
6. ``parity``, kernels vs plain end to end: tests/golden/parity.cfg on CUDA
   (kernels) and on the CPU (plain twins); diagnostics.csv must agree.

Launch counts are set to 0 just before each main path and read just after
it. Then one JSON line about the kernels, the nvidia-smi line, and the
result line. Imports nothing of JAX. Exits non-zero without a CUDA device
or without the repository beside it.
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
FLAGSHIP = os.path.join(ROOT, "config", "params_3d.cfg")
BANKED = os.path.join(ROOT, "docs", "runs", "3d_1M", "diagnostics.csv")
PARITY = os.path.join(ROOT, "tests", "golden", "parity.cfg")

# Main-path caps: 20,000 iterations for the initial flow solve and 2,000 per
# re-solve; 1,200 s of physics in cycles of at most 20 implicit steps (two
# cycles at the 30 s adaptive-dt ceiling).
MAIN_CAPS = ["flow_max_iters=20000", "flow_max_iters_resolve=2000",
             "T_final=1200", "corrosion_steps_per_check=20"]
# 3D main-path caps: the initial flow solve converged at ~6,500 iterations
# in the banked run; 600 s of physics is 20 implicit steps at the 30 s dt
# ceiling in one cycle, and checkpoint_every=1 writes one 1M-node checkpoint
MAIN3D_CAPS = ["flow_max_iters=10000", "T_final=600", "checkpoint_every=1"]
# max relative difference of the 20 rows against the banked run's first 20
# (measured on an H100 at 700 W: 2.1e-5, 1.0e-6 and 7.4e-5)
BANKED_GATES = {"pin_mass_loss_pct": 1e-3, "v_max": 1e-3, "C_max_fluid": 1e-2}
# the CPU slice test's flow cap (tests/test_torch_slice.py), in f32
PARITY_CAPS = ["precision=f32", "flow_max_iters=300"]
SEED = 20261016
PHASES = ("kernels", "kernels3d", "main", "main3d", "parity")
# the kernels each main path must launch
PATH_2D = ("ns2d", "matvec2d", "basis_dots", "basis_axpy")
PATH_3D = ("ns3d", "matvec3d", "slots3d_f64", "basis_dots", "basis_axpy")


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


def recorder(tag, results, calls=20, plain_calls=3):
    """record(name, err, ok, fn, plain, what, nbytes=None): two launches of
    fn() must give the same bits; median times of fn and plain; fails
    unless ok. Fills results[name] = (max_abs_err, ms, plain_ms)."""
    def record(name, err, ok, fn, plain, what, nbytes=None):
        k1, k2 = fn(), fn()
        same = all(torch.equal(a, b) for a, b in zip(k1, k2))
        if not same:
            fail(f"{name}: two launches gave different bits")
        del k1, k2
        ms, plain_ms = median_ms(fn, calls), median_ms(plain, plain_calls)
        rate = (f", {nbytes / 1e6:.1f} MB per call -> "
                f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s" if nbytes else "")
        print(f"[{tag}] {name}: max_abs_err={err:.3e} ({what}) "
              f"repeat-identical={same} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{rate}")
        if not ok:
            fail(f"{name}: disagrees with its plain version ({what})")
        results[name] = (err, ms, plain_ms)
    return record


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

    record = recorder("kernels", results)

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


def phase_kernels3d(pkg):
    """Phase 3; returns {name: (max_abs_err, ms, plain_ms)}."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    t0 = time.time()
    cfg = pkg.Config.load(FLAGSHIP)
    grid = pkg.build_grid(cfg)
    t1 = time.time()
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg,
                              grains=pkg.grains.generate(grid, cfg),
                              device="cuda")
    torch.cuda.synchronize()
    n, S = grid.N_total, kit.S
    print(f"[kernels3d] flagship grid {kit.shape} = {n} nodes, S={S}, "
          f"mext={kit.mext}, {kit.dtype}; grid built in {t1 - t0:.2f} s, "
          f"grains + kit + state in {time.time() - t1:.2f} s")
    rng = np.random.default_rng(SEED + 3)
    fluid = st.node_type == 0
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    st.C = torch.where(st.node_type == 1, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"), 0.0)
    results = {}
    record = recorder("kernels3d", results, calls=10)

    # ns3d: 53 B/node of unique HBM traffic (rho, vel[3], p, node_type and
    # the four pure-act sums in; rho, vel[3] out)
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    (r, v), (rp, vp) = kernels.ns3d(*args), kernels.ns3d_plain(*args)
    torch.cuda.synchronize()
    ok = (torch.allclose(r, rp, rtol=1e-6, atol=0.0)
          and torch.allclose(v, vp, rtol=1e-4, atol=1e-9))
    err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
    print(f"[kernels3d] ns3d bit-equal to its plain twin: "
          f"{torch.equal(r, rp) and torch.equal(v, vp)}")
    del r, v, rp, vp
    record("ns3d", err, ok, lambda: kernels.ns3d(*args),
           lambda: kernels.ns3d_plain(*args),
           "rho rtol 1e-6, v rtol 1e-4 atol 1e-9", nbytes=53 * n)

    # matvec3d on the operator of this state, f32 and bf16 weights: W of
    # the unknown rows, plus x, diag, unknown and y
    op = ai.assemble(st, kit)
    n_unk = int(op.unknown.sum())
    x = torch.tensor(rng.random(kit.shape), dtype=torch.float32, device="cuda")
    print(f"[kernels3d] operator: {n_unk} unknown rows; W "
          f"{op.W.numel() * 4 / 1e6:.1f} MB f32, "
          f"{op.W16.numel() * 2 / 1e6:.1f} MB bf16")
    for name, W, wbytes in (("matvec3d", op.W, 4),
                            ("matvec3d_bf16", op.W16, 2)):
        mv = (x, W, op.diag, op.unknown, kit)
        y, yp = kernels.matvec3d(*mv), kernels.matvec3d_plain(*mv)
        err = float((y - yp).abs().max())
        print(f"[kernels3d] {name} bit-equal to its plain twin: "
              f"{torch.equal(y, yp)}")
        record(name, err, err <= 1e-5 * float(yp.abs().max()),
               lambda: (kernels.matvec3d(*mv),),
               lambda: kernels.matvec3d_plain(*mv), "max|dy| <= 1e-5 max|y|",
               nbytes=n_unk * S * wbytes + 13 * n)

    # slots3d_f64: all of W (no mask) plus x and y in f64
    x64 = torch.tensor(rng.random(kit.shape), dtype=torch.float64,
                       device="cuda")
    y, yp = kernels.slots3d_f64(x64, op.W, kit), kernels.slots3d_f64_plain(
        x64, op.W, kit)
    err = float((y - yp).abs().max())
    print(f"[kernels3d] slots3d_f64 bit-equal to its plain twin: "
          f"{torch.equal(y, yp)}")
    record("slots3d_f64", err, err <= 1e-14 * float(yp.abs().max()),
           lambda: (kernels.slots3d_f64(x64, op.W, kit),),
           lambda: kernels.slots3d_f64_plain(x64, op.W, kit),
           "max|dy| <= 1e-14 max|y|", nbytes=n * S * 4 + 16 * n)
    print(f"[kernels3d] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    """Phase 4; returns the launch counts of the 2D main path's run."""
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
        "every kernel of the 2D path launched":
            all(counts[k] > 0 for k in PATH_2D),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
    }
    for what, ok in checks.items():
        print(f"[main] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("main path checks")
    return counts


def phase_main3d(tmp):
    """Phase 5; returns the launch counts of the 3D main path's run."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.checkpoint import load_checkpoint

    out_dir = os.path.join(tmp, "flagship")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    solver, rows = run_cli(out_dir, [FLAGSHIP, *MAIN3D_CAPS, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("Grid:", "Flow:", "Implicit cycle",
                                       "WARNING", "Checkpoint", "[Timer]")):
                print(f"[main3d] log: {line.rstrip()}")
    st = solver.final_state
    flow_rate = solver.flow_iters / max(solver.flow_seconds, 1e-9)
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps, 1)
    print(f"[main3d] params_3d.cfg {' '.join(MAIN3D_CAPS)}: {solver.cycles} "
          f"cycles, steps per cycle {solver.cycle_steps}, flow solves "
          f"{solver.flow_results}, {solver.flow_iters} flow iterations in "
          f"{solver.flow_seconds:.3f} s, wall {wall:.2f} s")
    print(f"[main3d] flow iterations/s {flow_rate:.2f}; ms per implicit step "
          f"{step_ms:.3f} ({solver.total_implicit_steps} steps in "
          f"{solver.implicit_seconds:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[main3d] launches {json.dumps(counts)}")

    ck, t_ck, _ = load_checkpoint(f"{out_dir}/out/checkpoint.npz", st)
    same_ckpt = (t_ck == float(rows["time_s"][-1]) and all(
        torch.equal(a, b) for a, b in zip(ck.tensors(), st.tensors())))
    banked = np.atleast_1d(np.genfromtxt(BANKED, delimiter=",", names=True))
    banked = banked[:len(rows)]
    diffs = {}
    if len(banked) == len(rows):
        ratio = {c: rows[c] / banked[c]
                 for c in ("pin_mass_loss_pct", "v_max", "C_max_fluid")}
        diffs = {c: float(np.abs(r - 1.0).max()) for c, r in ratio.items()}
    print(f"[main3d] vs docs/runs/3d_1M/diagnostics.csv, first {len(rows)} "
          f"rows: max rel diff {json.dumps(diffs)} (gates "
          f"{json.dumps(BANKED_GATES)})")
    last = rows[-1]
    print(f"[main3d] last row: t={last['time_s']:.1f} s loss="
          f"{last['pin_mass_loss_pct']:.6e} % solid={int(last['solid_nodes'])} "
          f"v_max={last['v_max']:.6e} C_max_fluid={last['C_max_fluid']:.6e}")
    checks = {
        "the initial flow solve converged":
            bool(solver.flow_results) and bool(solver.flow_results[0][2]),
        "20 rows, all finite": len(rows) == 20 and all(
            np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "every kernel of the 3D path launched":
            all(counts[k] > 0 for k in PATH_3D),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
        "the checkpoint reloads equal to final_state": same_ckpt,
        "solid_nodes 31,600 on every row":
            bool(np.all(rows["solid_nodes"] == 31600)),
        "time_s equal to the banked run's": len(banked) == len(rows)
            and np.allclose(rows["time_s"], banked["time_s"], rtol=1e-9),
        "the banked-run gates": bool(diffs) and all(
            diffs[c] <= g for c, g in BANKED_GATES.items()),
    }
    for what, ok in checks.items():
        print(f"[main3d] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("3D main path checks")
    return counts


def phase_parity(tmp):
    """Phase 6: parity.cfg with the kernels on CUDA vs the plain twins on
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
    phases = sys.argv[1:] or list(PHASES)
    if set(phases) - set(PHASES):
        fail(f"unknown phase(s) {sorted(set(phases) - set(PHASES))}; "
             f"phases are {', '.join(PHASES)}")
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

    measured, counts2d, counts3d = {}, {}, {}
    if "kernels" in phases:
        measured.update(phase_kernels(pkg))
    if "kernels3d" in phases:
        measured.update(phase_kernels3d(pkg))
    with tempfile.TemporaryDirectory() as tmp:
        if "main" in phases:
            counts2d = phase_main(tmp)
        if "main3d" in phases:
            counts3d = phase_main3d(tmp)
        if "parity" in phases:
            phase_parity(tmp)

    rows = []
    for k in KERNELS:
        if k.name not in measured:
            continue
        err, ms, plain_ms = measured[k.name]
        # each kernel's launches on a main path that runs it (the 3D one,
        # the flagship, for the kernels both paths share)
        counts = counts3d if k.name in PATH_3D and counts3d else counts2d
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": counts.get(k.name),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
