"""The coarse-grid warm start of the initial flow solve
(``flow_warm_start``, ``solvers.coarse_warm_start``) in the port against
the JAX package's, in float64 on the CPU.

Cases:

* 2D: tests/golden/parity.cfg with flow_warm_start = 2; the coarse solve
  (29 x 23 nodes) runs to convergence;
* 3D: config/params_3d.cfg on tests/test_torch_3d_slice.py's geometry at
  dx = 4e-6 (39 x 31 x 31 = 37,479 nodes), whose coarse twin at 2 dx is
  the 8,303-node grid of tests/test_pallas_interpret.py; the coarse solve
  is capped at 200 iterations (it does not converge there), which both
  packages share;
* the "no solid nodes at coarse spacing" branch: parity.cfg with a wire of
  radius 4e-6 (a single column of SOLID nodes at dx) and a ratio of 3.

Gates: the same coarse iteration count and the same printed warm-start
line; rho, vel and pressure of the started state to round-off (rtol
1e-10, atol 1e-10 of the field's largest value: up to thousands of f64
flow steps, the 3D ones in the act-static form of the port's NS step
against the JAX package's XLA form, which round differently; measured
1.6e-12 of the largest velocity in 3D)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_3d_slice import CFG_3D, SMALL

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.solvers import coarse_warm_start as j_warm
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.solvers import coarse_warm_start as t_warm

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
CASES = {
    "2d": (PARITY, ["flow_warm_start=2"]),
    "3d": (CFG_3D, [*SMALL, "dx=4e-6", "flow_max_iters=200",
                    "flow_warm_start=2"]),
    "no_solid": (PARITY, ["R_wire=4e-6", "flow_warm_start=3"]),
}


def _run(case, capsys):
    """(JAX, port) of (started state, coarse iterations, printed lines)."""
    path, overrides = CASES[case]
    out = []
    for Config, build_grid, build_kit in (
            (JConfig, j_build_grid, j_build_kit),
            (TConfig, t_build_grid, None)):
        cfg = Config.load(path)
        cfg.apply_overrides([*overrides, "precision=f64"])
        grid = build_grid(cfg)
        if build_kit is not None:
            kit = build_kit(grid, cfg)
            state = j_initialize_state(grid, cfg, dtype=kit.jdtype)
            capsys.readouterr()
            state, iters = j_warm(state, grid, kit, cfg)
            host = {f.name: np.asarray(getattr(state, f.name))
                    for f in dataclasses.fields(state)}
            init = j_initialize_state(grid, cfg, dtype=jnp.float64)
            init = {f.name: np.asarray(getattr(init, f.name))
                    for f in dataclasses.fields(init)}
        else:
            kit = t_build_kit(grid, cfg, device="cpu")
            state = state_from_numpy(init, dtype=torch.float64, device="cpu")
            capsys.readouterr()
            state, iters = t_warm(state, grid, kit, cfg)
            host = {f.name: getattr(state, f.name).numpy()
                    for f in dataclasses.fields(state)}
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "Warm start" in ln]
        out.append((host, iters, lines, init))
    return out


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_coarse_warm_start_equals_jax(case, capsys):
    (jst, j_it, j_lines, init), (tst, t_it, t_lines, _) = _run(case, capsys)
    assert int(j_it) == t_it > 0
    assert len(t_lines) == 1 and t_lines == j_lines
    if case == "2d":
        assert "converged=True" in t_lines[0]
    fluid = init["node_type"] == 0
    for f in ("rho", "vel", "pressure"):
        ref = jst[f]
        np.testing.assert_allclose(tst[f], ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=f)
        # FLUID nodes only are overwritten
        np.testing.assert_array_equal(tst[f][~fluid], init[f][~fluid]
                                      if f != "pressure" else tst[f][~fluid])
    assert not np.array_equal(tst["vel"][fluid], init["vel"][fluid])
    for f in ("node_type", "C", "phase", "is_gb"):
        np.testing.assert_array_equal(tst[f], init[f])


def test_coarse_warm_start_without_coarse_solid(capsys):
    (jst, j_it, j_lines, init), (tst, t_it, t_lines, _) = _run("no_solid",
                                                              capsys)
    assert int(j_it) == t_it == 0
    assert t_lines == j_lines == [
        "  Warm start skipped: no solid nodes at coarse spacing"]
    for f in ("rho", "vel", "pressure", "C"):
        np.testing.assert_array_equal(tst[f], init[f])
