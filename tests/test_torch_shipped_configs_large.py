"""params_fine.cfg (dx = 2 um, 157 x 707 = 110,999 nodes) and
params_calibration_v2.cfg (177 x 287 = 50,799 nodes) through both CLIs on
the CPU in float64, as tests/test_torch_shipped_configs.py (its gates and
helpers), and params_fine.cfg's grid and grains against the JAX
package's."""

import os

import numpy as np
import pytest

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import grains as t_grains
from test_torch_shipped_configs import CONFIG, line, run_both

CAPS = {
    # the flow capped at 10 iterations; T_final = 1e-8 s as shipped: one
    # implicit step at the 0.6 s floor
    "params_fine": ["flow_max_iters=10"],
    # two 30 s steps of one cycle
    "params_calibration_v2": ["flow_max_iters=10", "T_final=60"],
}


@pytest.mark.parametrize("name", sorted(CAPS))
def test_shipped_config_matches_jax(name, tmp_path, capsys, monkeypatch):
    solver, rows, lines = run_both(name, CAPS[name], tmp_path, capsys,
                                   monkeypatch)
    assert line(lines, "Using ").startswith("Using IMPLICIT ARD solver")
    if name == "params_fine":
        assert line(lines, "Grid:") == ("Grid: Nx=157 Ny=707 Nz=1  "
                                        "N_total=110999")
        assert line(lines, "Initial solid nodes:") == "Initial solid nodes: 8200"
        assert solver.cycle_steps == [1]
        np.testing.assert_allclose(rows["time_s"], [0.6], rtol=1e-12)
        # after 11 flow iterations the step at the 0.6 s floor leaves GMRES
        # at a residual of 13.6 in both packages (their same warning line)
        assert solver.gmres_warnings == 1
        assert line(lines, "WARNING: GMRES") == ("WARNING: GMRES did not "
                                                 "converge (|res|=1.36e+01)")
    else:
        # 1,280 solid nodes on this grid in both packages (docs/PARITY.md's
        # record of the JAX package's run says 1,359)
        assert line(lines, "Grid:") == ("Grid: Nx=177 Ny=287 Nz=1  "
                                        "N_total=50799")
        assert line(lines, "Initial solid nodes:") == "Initial solid nodes: 1280"
        assert solver.gmres_warnings == 0 and solver.cycle_steps == [2]
        np.testing.assert_array_equal(rows["time_s"], [30.0, 60.0])


def test_fine_grid_and_grains_equal_jax():
    cfg = os.path.join(CONFIG, "params_fine.cfg")
    j, t = JConfig.load(cfg), TConfig.load(cfg)
    jg, tg = j_build_grid(j), t_build_grid(t)
    assert (tg.Nx, tg.Ny, tg.N_total) == (157, 707, 110_999)
    np.testing.assert_array_equal(tg.node_type, jg.node_type)
    np.testing.assert_array_equal(tg.pos, jg.pos)
    assert tg.type_counts() == jg.type_counts()
    assert tg.type_counts()["SOLID_MG"] == 8200    # docs/PARITY.md
    jgr, tgr = j_grains.generate(jg, j), t_grains.generate(tg, t)
    assert tgr.n_grains == jgr.n_grains
    for f in ("grain_id", "is_grain_boundary", "is_precipitate"):
        np.testing.assert_array_equal(getattr(tgr, f), getattr(jgr, f))
