#!/usr/bin/env python3
"""What one read a step costs the implicit step loop's graph route, and
what a profiler that has run in the process adds to it.

    python3 scripts/step_route_costs_torch.py

On the block-AMR and fine-calibration grids of chip_smoke.py (its seeded
flow cases, ``flow_case``, after a 1,000-iteration flow solve and the
operator assembled on it; five steps from the extrapolated start, then
the start C): windows of 3 implicit steps on the graph route one step and
one read at a time (``StepRunner.step``) and as one chunk
(``StepRunner.steps``), single, chunk, single, chunk, by the host clock;
then one torch.profiler window of a tiny op, and the same windows again.
Prints one line a grid and round: ms an implicit step and Arnoldi steps
an implicit step by window. Needs a CUDA device; imports nothing of JAX.
"""

import importlib.util
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    if not torch.cuda.is_available():
        sys.exit("step_route_costs_torch.py needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import pd_mg_pin_corrosion_tpu_torch as pkg
    from pd_mg_pin_corrosion_tpu_torch import coupling, solvers
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    print(cs.nvidia_smi())
    kits = {}
    for name in ("amr", "fine"):
        kit, st = cs.flow_case(pkg, name)
        st = solvers.solve_steady(st, kit, max_iters=1000)[0]
        ops = ops_for(kit)
        stepper = coupling.step_runner_for(kit)
        op = ops.assemble(st, kit, coupling.volume_loss_fraction(st, kit))
        stepper.begin(st, op, kit, st.C)
        for _ in range(5):
            stepper.step(kit)
        e = stepper.result(st)
        stepper.begin(e, op, kit)
        stepper.steps(kit, 3)
        kits[name] = (kit, stepper, e, op)

    def times(tag):
        for name, (kit, stepper, e, op) in kits.items():
            out = []
            for route in ("single", "chunk", "single", "chunk"):
                gmres.reset_gmres_counts()
                stepper.begin(e, op, kit)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if route == "chunk":
                    stepper.steps(kit, 3)
                else:
                    for _ in range(3):
                        stepper.step(kit)
                torch.cuda.synchronize()
                c = gmres.GMRES_COUNTS
                out.append(f"{route} "
                           f"{1e3 * (time.perf_counter() - t0) / 3:.3f} "
                           f"({(c['replays'] + c['eager']) / 3:.2f} Arnoldi)")
            print(f"{tag} {name}: " + ", ".join(out))

    times("before any profiler")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(4, device="cuda").sum()
        torch.cuda.synchronize()
    times("after a profiler window")


if __name__ == "__main__":
    main()
