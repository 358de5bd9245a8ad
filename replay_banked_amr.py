#!/usr/bin/env python3
"""Run the port's CLI with the grain draw the banked block-AMR runs were
made with.

    python3 replay_banked_amr.py [config/params_amr.cfg] [key=value ...]
                                 [--device cuda|cpu]

docs/runs/amr and docs/runs/amr_r2 were banked before the grain generator's
uniform_int was made bit-exact with libstdc++ (Lemire's multiply-shift; both
packages draw so now, as the C++ reference does). They drew with the
two-division downscaling, which moves some precipitates, and with them the
solid's diffusivity map, from the first step on. This script puts that
draw back for one run, so the rest of a trajectory can be held against the
bank with compare_banked.py; everything else is ``cli.run`` as it is.

``two_division_uniform_int`` also serves the calibration banks: the port's
calibration scripts install it for one run with ``--grain-draw=banked``
(scripts/calibration_torch.py). docs/runs/calib_3d was banked with it (the
whole twoanchor-c point gives the bank's rows with it, not without);
docs/runs/calib_2d gives the same run under either draw.

After the run it prints one JSON line of the run's totals: wall seconds,
flow solves, iterations and seconds, implicit steps and seconds, and the
launches of each CUDA kernel in the run.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def two_division_uniform_int(self, b: int) -> int:
    """Uniform int in [0, b] by two-division downscaling with rejection
    (the draw of the banked runs)."""
    urange = b + 1
    if urange >= 2**32:
        return self.next_u32()
    scaling = (2**32 - 1) // urange
    past = urange * scaling
    while True:
        r = self.next_u32()
        if r < past:
            return r // scaling


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from pd_mg_pin_corrosion_tpu_torch import cli, grains, kernels
    from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable

    grains._MT19937Stream.uniform_int = two_division_uniform_int
    kernels.reset_launch_counts()
    t0 = time.time()
    try:
        s = cli.run(argv)
    except DeviceUnavailable as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "wall_s": time.time() - t0, "cycles": s.cycles,
        "flow_solves": s.flow_solve_count, "flow_iters": s.flow_iters,
        "flow_s": s.flow_seconds, "implicit_steps": s.total_implicit_steps,
        "implicit_s": s.implicit_seconds, "assemble_s": s.assemble_seconds,
        "dissolved": s.total_dissolved,
        "launches": kernels.launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
