#!/usr/bin/env python3
"""The slot-chunked and j-static 3D NS variants against the production ns3d
kernel, on one CUDA device.

    python3 scripts/exp_ns3d_chunked_torch.py [dx]

The PyTorch/CUDA port of ``scripts/exp_ns3d_chunked.py``'s ``main()``.
Builds config/params_3d.cfg at ``dx`` (default 4e-6, the flagship: 157 x 82
x 82 = 1,055,668 nodes, S = 178) in float32 on the card, then for ns3d (the
production kernel) and for each rung (BZ, NCHUNK, form) of the ladder:
checks one step against ns3d (max |d rho| / max |rho| and max |d vel| / max
|vel| at most 1e-4, else the rung is not timed), and times it with CUDA
events around 150 back-to-back launches on the same inputs, best of 3.
The ladder is the JAX script's five rungs, (8, 4), (16, 4), (16, 8) and
(32, 8) in the factored form and (16, 4) in the XLA form, plus the two
forms its ``main()`` did not time: jconv at (16, 6) and the j-static
kernel at its defaults (8, 2). BZ is the z extent of the kernel's staged
tile (8, 16 or 32; the cross-section is chosen per BZ, printed per rung);
NCHUNK the number of slot chunks. Prints a summary in ms per step. Fails
without a card; imports nothing of JAX.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pd_mg_pin_corrosion_tpu_torch as pkg  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch import kernels  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch.ops import ns  # noqa: E402

# (BZ, NCHUNK, form): form is ns3d_chunked's ``factored`` (False, True,
# "jconv") or "jstat"
LADDER = ((8, 4, True), (16, 4, True), (16, 8, True), (32, 8, True),
          (16, 4, False), (16, 6, "jconv"), (8, 2, "jstat"))
GATE = 1e-4
INNER, REPS = 150, 3


def label(bz, nchunk, form):
    if form == "jstat":
        return f"jstat BZ={bz} NCHUNK={nchunk}"
    fac = "jconv" if form == "jconv" else int(form)
    return f"chunked BZ={bz} NCHUNK={nchunk} fac={fac}"


def best_ms(fn, inner=INNER, reps=REPS):
    """Best over ``reps`` of the device time per call of fn(), in ms: CUDA
    events around ``inner`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / inner)
    return best


def ladder(kit, state, dt, rungs=LADDER, inner=INNER, reps=REPS, log=print):
    """Check and time every rung against ns3d on (kit, state, dt). Returns
    (ns3d ms, {label: ms}, {label: (rel drho, rel dvel)})."""
    p = ns.tait_pressure(state.rho, kit)
    args = (state.rho, state.vel, p, state.node_type, dt, kit)
    ref_rho, ref_vel = kernels.ns3d(*args)
    base = best_ms(lambda: kernels.ns3d(*args), inner, reps)
    log(f"{'production ns3d':40s} {base:8.4f} ms/step")
    actconv = None
    times, errs = {}, {}
    for bz, nchunk, form in rungs:
        name = label(bz, nchunk, form)
        if form == "jstat":
            if actconv is None:
                actconv = kernels.compute_actconv(kit, state.node_type)

            def fn(bz=bz, nchunk=nchunk):
                return kernels.ns3d_jstat(*args, actconv, nchunk=nchunk,
                                          bz=bz)
        else:
            def fn(bz=bz, nchunk=nchunk, form=form):
                return kernels.ns3d_chunked(*args, nchunk=nchunk, bz=bz,
                                            factored=form)
        geo = kernels.ns3d_chunked_geometry(
            {False: "xla", True: "factored"}.get(form, form), bz)
        log(f"{name:40s} tile {geo.tx} x {geo.ty} x {geo.tz} (x, y, z), "
            f"{geo.r} z nodes a thread, {geo.threads} threads, "
            f"{geo.tile_bytes / 1e3:.1f} KB staged")
        rho, vel = fn()
        dr = float((rho - ref_rho).abs().max() / ref_rho.abs().max())
        dv = float((vel - ref_vel).abs().max() / ref_vel.abs().max())
        errs[name] = (dr, dv)
        log(f"{name:40s} max rel drho={dr:.2e} dvel={dv:.2e}")
        if dr > GATE or dv > GATE:
            log(f"{name:40s} MISMATCH - skipping timing")
            continue
        times[name] = best_ms(fn, inner, reps)
        log(f"{name:40s} {times[name]:8.4f} ms/step")
    return base, times, errs


def build(dx):
    """(kit, state, dt) of config/params_3d.cfg at dx, float32, on CUDA."""
    cfg = pkg.Config.load(os.path.join(ROOT, "config", "params_3d.cfg"))
    cfg.dx = dx
    cfg.precision = "f32"
    cfg.compute_derived()
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    state = pkg.initialize_state(grid, cfg, dtype=kit.dtype, device="cuda")
    print(f"grid {grid.shape} N={grid.N_total} S={kit.S}", flush=True)
    return kit, state, ns.compute_dt(state, kit)


def main():
    if not torch.cuda.is_available():
        print("exp_ns3d_chunked_torch: needs a CUDA device", file=sys.stderr)
        return 1
    dx = float(sys.argv[1]) if len(sys.argv) > 1 else 4.0e-6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    base, times, _ = ladder(*build(dx))
    print("\n=== summary (ms/step) ===")
    print(f"{'production':40s} {base:8.4f}")
    for k, v in sorted(times.items(), key=lambda kv: kv[1]):
        print(f"{k:40s} {v:8.4f}  ({base / v:4.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
