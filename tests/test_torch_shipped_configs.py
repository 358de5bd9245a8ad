"""The shipped configurations through both CLIs on the CPU, in float64: the
port's ``python -m pd_mg_pin_corrosion_tpu_torch config/<name>.cfg``
(``cli.run``) against the JAX package's (``cli.main``), each with no
override but caps of its flow and its physical time, ``precision=f64``
and ``output_dir``.

Gates: tests/test_parity.py's, row by row (solid_nodes exact, time_s to
1e-9, the rest to 1e-6 relative), and the console lines both CLIs print
(SHARED: the grid, its node types and grains, the initial solid, the
solver, each flow solve's iterations and residual, the Poiseuille check,
the explicit dt, each cycle's steps, phase changes and rows, GMRES's
warnings) equal line for line.

The seven configurations are split over three files to keep each under
about 90 s on one worker: this one holds the three 2D implicit ones on the
7,973- and 19,229-node grids; test_torch_shipped_configs_flow.py
params_poiseuille.cfg (no wire, explicit) and params_transport_viz.cfg
(implicit as shipped, and explicit with use_implicit=0);
test_torch_shipped_configs_large.py params_fine.cfg (110,999 nodes) and
params_calibration_v2.cfg (50,799)."""

import os

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import cli as j_cli
from pd_mg_pin_corrosion_tpu_torch import cli as t_cli

torch.set_num_threads(2)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config")
# the console lines both CLIs print, by their first words
SHARED = ("Grid:", "Node types:", "Grain generation:", "Initial solid nodes:",
          "Using ", "=== Coupling cycle", "Flow re-solve", "Flow:",
          "Poiseuille validation", "Corrosion dt", "t=", "Implicit cycle:",
          "Phase change:", "No phase changes", "Skipping flow solve",
          "WARNING: GMRES", "=== All solid nodes dissolved", "Final time:")
# caps of each configuration's run: the initial flow solve and each
# re-solve, and the physical time (its first implicit steps at the 30 s
# step of the 60 s ceiling, or at the 0.6 s floor of the fast-dissolving
# ones); each run's rows, cycles and dissolutions are held in its test
CAPS = {
    # the CLI's default configuration: three 30 s steps of one cycle
    "params": ["flow_max_iters=30", "T_final=90"],
    "params_diagnostic": ["flow_max_iters=30", "T_final=90"],
    # gb_width_cells = 1
    "params_calibration": ["flow_max_iters=30", "T_final=90"],
}


def lines_of(out):
    """The SHARED console lines of a run's output, stripped."""
    return [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith(SHARED)]


def read_csv(out):
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def assert_rows_match(ours, ref):
    """tests/test_parity.py's gates, row by row."""
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6,
                                   err_msg=col)


def run_both(name, caps, tmp_path, capsys, monkeypatch):
    """config/<name>.cfg with ``caps`` through both CLIs in float64. Checks
    the rows and the shared console lines; returns (the port's solver, its
    rows, its shared lines)."""
    cfg = os.path.join(CONFIG, f"{name}.cfg")
    args = [cfg, *caps, "precision=f64"]
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setenv("PD_TPU_CACHE", "")    # no compilation cache outside
        assert j_cli.main([*args, f"output_dir={tmp_path / 'jax'}"]) == 0
    jax_lines = lines_of(capsys.readouterr().out)
    solver = t_cli.run([*args, f"output_dir={tmp_path / 'port'}",
                        "--device", "cpu"])
    port_lines = lines_of(capsys.readouterr().out)
    rows = read_csv(tmp_path / "port")
    assert_rows_match(rows, read_csv(tmp_path / "jax"))
    assert port_lines == jax_lines
    return solver, rows, port_lines


def line(lines, start):
    """The one shared line that starts with ``start``."""
    found = [ln for ln in lines if ln.startswith(start)]
    assert len(found) == 1, (start, found)
    return found[0]


@pytest.mark.parametrize("name", sorted(CAPS))
def test_shipped_config_matches_jax(name, tmp_path, capsys, monkeypatch):
    solver, rows, lines = run_both(name, CAPS[name], tmp_path, capsys,
                                   monkeypatch)
    grid, solid = {
        "params": ("Grid: Nx=67 Ny=287 Nz=1  N_total=19229", 1280),
        "params_diagnostic": ("Grid: Nx=67 Ny=119 Nz=1  N_total=7973", 1296),
        "params_calibration": ("Grid: Nx=67 Ny=119 Nz=1  N_total=7973",
                               1296)}[name]
    assert line(lines, "Grid:") == grid
    assert line(lines, "Initial solid nodes:") == f"Initial solid nodes: {solid}"
    assert line(lines, "Using ").startswith("Using IMPLICIT ARD solver")
    assert solver.gmres_warnings == 0
    # one cycle of three 30 s steps, the flow capped, nothing dissolved
    assert solver.cycles == 1 and solver.cycle_steps == [3]
    np.testing.assert_array_equal(rows["time_s"], [30.0, 60.0, 90.0])
    assert (rows["solid_nodes"] == solid).all()
    assert 0.0 < rows["pin_mass_loss_pct"][0] < rows["pin_mass_loss_pct"][-1]
    assert solver.flow_results[0][0] == 31       # the breaking iteration
    if name == "params_calibration":
        # gb_width_cells = 1 widens the boundaries: more GB nodes than the
        # same grid without it (params_diagnostic: 619 of 1,296)
        n_gb = int(line(lines, "Grain generation:").split("GB nodes: ")[1]
                   .split()[0])
        assert n_gb > 619
