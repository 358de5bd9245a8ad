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
"""

import os
import sys

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
    from pd_mg_pin_corrosion_tpu_torch import cli, grains

    grains._MT19937Stream.uniform_int = two_division_uniform_int
    return cli.main(argv)


if __name__ == "__main__":
    sys.exit(main())
