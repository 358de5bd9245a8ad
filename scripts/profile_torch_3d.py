#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main paths.

    python3 scripts/profile_torch_3d.py [out.txt] [config.cfg]

Builds config/params_3d.cfg at full size (157 x 82 x 82 = 1,055,668 nodes;
or the given configuration, e.g. config/params_fine_calibration.cfg for the
2D path) on one CUDA device, then times and profiles (``torch.profiler``)
two windows of the main path:

* flow: 200 iterations of ``solvers.solve_steady`` after a 1,000-iteration
  warm-up from the initial state;
* implicit: 5 implicit steps (``coupling.implicit_inner_step``) on the
  assembled operator, after 2 warm-up steps.

For each window it prints the wall time per unit (timed without the
profiler), the device busy time per unit, the busy share, the device
ops per unit beside the host's kernel launch records per unit (fewer
device ops than launches: the window lost device records, as
scripts/profiler_windows_torch.py shows for long-running processes) and
the largest kernels by device time, and writes the
profiler tables to ``out.txt`` (default build/profile_3d.txt). Needs a
CUDA device; imports nothing of JAX.
"""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pd_mg_pin_corrosion_tpu_torch as pkg  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch import grains, solvers  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch.coupling import (  # noqa: E402
    implicit_inner_step, volume_loss_fraction)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai  # noqa: E402

FLOW_WARM, FLOW_WINDOW = 1000, 200
STEP_WARM, STEP_WINDOW = 2, 5


def device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def window(name, fn, units, out, show=()):
    """Time fn() (one window of ``units`` units) without and with the
    profiler; print and return the summary line. The eight largest device
    items are printed, and every item whose name holds a string of
    ``show``."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / units
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    launched = sum("LaunchKernel" in e.name for e in prof.events())
    busy_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total for e in ev)
    by_name = {}
    for e in ev:
        t = (e.device_time_total if hasattr(e, "device_time_total")
             else e.cuda_time_total)
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = ranked[:8] + [(k, t) for k, t in ranked[8:]
                        if any(w in k for w in show)]
    busy = busy_us * 1e-3 / units
    line = (f"[{name}] wall {wall * 1e3:.4f} ms per unit, device busy "
            f"{busy:.4f} ms per unit ({100 * busy / (wall * 1e3):.1f} %), "
            f"{len(ev) / units:.1f} device ops per unit, "
            f"{launched / units:.1f} kernel launches per unit")
    print(line)
    for k, t in top:
        print(f"[{name}]   {100 * t / max(busy_us, 1e-9):5.1f} %  "
              f"{t * 1e-3 / units:.4f} ms/unit  {k[:90]}")
    out.write(line + "\n")
    out.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=40) + "\n")
    return line


def main():
    if not torch.cuda.is_available():
        print("profile_torch_3d: needs a CUDA device", file=sys.stderr)
        return 1
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "build", "profile_3d.txt")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cfg = pkg.Config.load(sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, "config", "params_3d.cfg"))
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                              device="cuda")
    print(f"[profile] {torch.cuda.get_device_name(0)}; grid {kit.shape} = "
          f"{grid.N_total} nodes, S={kit.S}")
    st, *_ = solvers.solve_steady(st, kit, max_iters=FLOW_WARM)
    with open(path, "w") as out:
        window("flow", lambda: solvers.solve_steady(st, kit,
                                                    max_iters=FLOW_WINDOW),
               FLOW_WINDOW, out)
        torch.cuda.synchronize()
        t0 = time.time()
        op = ai.assemble(st, kit, volume_loss_fraction(st, kit))
        torch.cuda.synchronize()
        print(f"[assemble] {1e3 * (time.time() - t0):.2f} ms (first call; "
              f"packing included where the operator is packed)")
        s = st
        for _ in range(STEP_WARM):
            s = implicit_inner_step(s, op, kit)[0]

        def steps():
            x = s
            for _ in range(STEP_WINDOW):
                x = implicit_inner_step(x, op, kit)[0]

        window("implicit", steps, STEP_WINDOW, out)
    print(f"[profile] tables in {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
