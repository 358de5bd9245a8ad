"""params_poiseuille.cfg and params_transport_viz.cfg through both CLIs on
the CPU in float64, as tests/test_torch_shipped_configs.py (its gates and
helpers): the flow validation with no wire on the explicit path, the
fast-dissolving configuration on the implicit path as shipped (a phase
change and a flow re-solve in every cycle) and on the explicit path with
use_implicit=0."""

import numpy as np
import pytest

from test_torch_shipped_configs import line, run_both

CAPS = {
    # no wire: the flow capped at 100 iterations, then one explicit step
    "params_poiseuille": ["flow_max_iters=100"],
    # two implicit steps at the 0.6 s floor, each ending its cycle with a
    # phase change
    "params_transport_viz": ["flow_max_iters=30", "T_final=1.2"],
    # ~29 explicit steps at the capped flow's CFL dt, a row every 10
    "params_transport_viz_explicit": ["use_implicit=0", "flow_max_iters=30",
                                      "T_final=1e-4", "output_every_corr=10"],
}


@pytest.mark.parametrize("case", sorted(CAPS))
def test_shipped_config_matches_jax(case, tmp_path, capsys, monkeypatch):
    name = case.replace("_explicit", "")
    solver, rows, lines = run_both(name, CAPS[case], tmp_path, capsys,
                                   monkeypatch)
    assert solver.gmres_warnings == 0
    if name == "params_poiseuille":
        # the JAX package's lines: the upstream profile's L2 error, a 100 %
        # loss of the 0 initial solid nodes, the end after one explicit step
        assert line(lines, "Grid:") == "Grid: Nx=87 Ny=127 Nz=1  N_total=11049"
        assert line(lines, "Initial solid nodes:") == "Initial solid nodes: 0"
        assert line(lines, "Using ") == "Using EXPLICIT ARD solver"
        err = float(line(lines, "Poiseuille validation").split("= ")[1])
        assert err < 0.05     # tests/test_flow.py's gate
        assert "pin_mass_loss=100.00%  solid=0" in line(lines, "t=")
        assert line(lines, "=== All solid nodes dissolved").startswith(
            "=== All solid nodes dissolved at t=0.0 s")
        assert solver.explicit_steps == 1 and solver.cycles == 1
        np.testing.assert_array_equal(rows["pin_mass_loss_pct"], [100.0])
        return
    assert line(lines, "Grid:") == "Grid: Nx=67 Ny=287 Nz=1  N_total=19229"
    assert line(lines, "Initial solid nodes:") == "Initial solid nodes: 1280"
    if case == "params_transport_viz":
        # implicit as shipped (no use_implicit key): two cycles of one step
        # at the 0.6 s floor, each ended by a phase change and followed by
        # a flow re-solve
        assert line(lines, "Using ").startswith("Using IMPLICIT ARD solver")
        assert solver.cycle_steps == [1, 1]
        np.testing.assert_allclose(rows["time_s"], [0.6, 1.2], rtol=1e-12)
        assert rows["solid_nodes"][0] == 1280 > rows["solid_nodes"][1]
        assert solver.total_dissolved > 0 and solver.flow_solve_count == 2
    else:
        assert line(lines, "Using ") == "Using EXPLICIT ARD solver"
        assert solver.explicit_steps == 29 and len(rows) == 3
        assert np.all(np.diff(rows["pin_mass_loss_pct"]) > 0)
