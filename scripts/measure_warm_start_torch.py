"""Measure the coarse-grid warm start (cfg.flow_warm_start) of the initial
steady flow solve on the PyTorch/CUDA port: the counterpart of
scripts/measure_warm_start.py.

Times both paths on the same initial state, each fenced with
``torch.cuda.synchronize()``: the cold ``solvers.solve_steady``, then the
warm path (``solvers.coarse_warm_start`` at 2 dx, its sampling onto the
fine grid included, then ``solve_steady``), under the configuration's own
convergence gate, in f32; and checks that the two converged fields agree
(FLUID-node relative L2 of the velocity).

Usage: python scripts/measure_warm_start_torch.py [config] [--device cuda|cpu]
Default config: config/params_3d.cfg. Block-AMR configurations
(``use_amr = 1``, e.g. config/params_amr.cfg) run on the block grid, as
the port's CLI does. The device comes from --device, else
$PD_TORCH_DEVICE, else cuda (no fallback to the CPU). Prints the JSON line
of the JAX script; exits 0 when both fine solves converged, the warm one
did not diverge, and the fields agree within 5 %.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from pd_mg_pin_corrosion_tpu_torch import cli
    from pd_mg_pin_corrosion_tpu_torch.config import Config
    from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable
    from pd_mg_pin_corrosion_tpu_torch.grid import FLUID
    from pd_mg_pin_corrosion_tpu_torch.solvers import (coarse_warm_start,
                                                       solve_steady)

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg_path = os.path.join(ROOT, "config", "params_3d.cfg")
    device = os.environ.get("PD_TORCH_DEVICE", "cuda")
    while argv:
        a = argv.pop(0)
        if a == "--device" and argv:
            device = argv.pop(0)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            raise SystemExit(f"unknown switch {a}")
        else:
            cfg_path = a
    try:
        dev = cli.device_of(device)
    except DeviceUnavailable as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    cfg = Config.load(cfg_path)
    cfg.precision = "f32"
    cfg.compute_derived()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"device: {dev} ({name}); {cfg_path}", flush=True)

    # the CLI's grid, kit and state: block AMR on its block grid
    grid, kit, state0 = cli.build(cfg, dev)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- cold (reference behavior) ---
    fence()
    t0 = time.perf_counter()
    st_cold, it_c, eps_c, conv_c, div_c = solve_steady(state0, kit)
    fence()
    wall_cold = time.perf_counter() - t0
    print(f"cold: {int(it_c)} iters, eps={float(eps_c):.3e}, "
          f"converged={bool(conv_c)}, wall={wall_cold:.1f} s", flush=True)

    # --- warm (flow_warm_start=2) ---
    cfg.flow_warm_start = 2
    t0 = time.perf_counter()
    st_w, coarse_iters = coarse_warm_start(state0, grid, kit, cfg)
    fence()
    st_warm, it_w, eps_w, conv_w, div_w = solve_steady(st_w, kit)
    fence()
    wall_warm = time.perf_counter() - t0
    print(f"warm: coarse {coarse_iters} iters + fine {int(it_w)} iters, "
          f"eps={float(eps_w):.3e}, converged={bool(conv_w)}, "
          f"wall={wall_warm:.1f} s (incl. coarse solve + interp)", flush=True)

    # --- same answer ---
    fluid = state0.node_type == FLUID
    v_c = st_cold.vel[fluid].double()
    v_w = st_warm.vel[fluid].double()
    rel = float(torch.sqrt(((v_c - v_w) ** 2).sum() / (v_c ** 2).sum()))
    print(f"field agreement: rel L2 = {rel:.3e}", flush=True)

    ok = bool(conv_c) and bool(conv_w) and not bool(div_w) and rel < 0.05
    print(json.dumps({
        "cold_iters": int(it_c), "cold_wall_s": round(wall_cold, 1),
        "warm_fine_iters": int(it_w), "warm_coarse_iters": int(coarse_iters),
        "warm_wall_s": round(wall_warm, 1),
        "speedup": round(wall_cold / wall_warm, 2),
        "field_rel_l2": rel, "ok": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
