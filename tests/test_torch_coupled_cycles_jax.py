"""The port's fused coupling cycles (``coupling.CycleRunner``) against the
JAX package on the CPU.

parity.cfg in float64, capped: the port's CLI with coupled_fused_cycles =
3 against the JAX CLI's host loop (its fused machine's CSVs equal its
host loop's, tests/test_coupling_fused.py): the rows to
tests/test_parity.py's gates. The ``slow`` form holds the port's fused
route against the JAX CLI's own fused route (``coupled_cycles_chunk``)
with launch caps and implicit_extrapolate_x0 (whose start history both
re-seed at each launch): the ``=== Fused chunk`` lines, which count each
launch's cycles, steps, flow iterations, solves, dissolutions and time,
equal line for line, and the rows to the same gates.
"""

import os

import pytest
import torch
from test_torch_shipped_configs import assert_rows_match, read_csv

from pd_mg_pin_corrosion_tpu import cli as j_cli
from pd_mg_pin_corrosion_tpu_torch import cli as t_cli

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
F64 = [PARITY, "precision=f64", "flow_max_iters=300",
       "dissolution_batch=20"]


def _both(tmp_path, capsys, monkeypatch, jax_args, port_args):
    capsys.readouterr()
    monkeypatch.setenv("PD_TPU_CACHE", "")
    assert j_cli.main([*jax_args, f"output_dir={tmp_path / 'jax'}"]) == 0
    jax_out = capsys.readouterr().out
    solver = t_cli.run([*port_args, f"output_dir={tmp_path / 'port'}",
                        "--device", "cpu"])
    port_out = capsys.readouterr().out
    return solver, jax_out, port_out


def test_fused_cycles_against_the_jax_host_loop(tmp_path, capsys,
                                                monkeypatch):
    """The port's fused route against the JAX CLI's host loop in float64:
    three cycles, each ended by a dissolution batch of 20, the rows to
    tests/test_parity.py's gates and the same phase changes."""
    args = [*F64, "T_final=3.0"]
    solver, jax_out, _ = _both(
        tmp_path, capsys, monkeypatch, [*args, "coupled_fused_cycles=0"],
        [*args, "coupled_fused_cycles=3"])
    assert_rows_match(read_csv(tmp_path / "port"), read_csv(tmp_path / "jax"))
    assert solver.cycle_graph["eager_launches"] >= 1
    assert solver.cycles == jax_out.count("=== Coupling cycle") >= 2
    assert solver.total_dissolved > 0


def _fused_lines(out):
    return [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith("=== Fused chunk")]


@pytest.mark.slow
def test_fused_cycles_against_the_jax_fused_route(tmp_path, capsys,
                                                  monkeypatch):
    """Both CLIs' fused routes in float64 with launches of at most 2 steps
    (a cycle of 3 split across launches) and 50 flow iterations and the extrapolated GMRES start: the same
    launches (the ``=== Fused chunk`` lines equal) and the rows to
    tests/test_parity.py's gates."""
    args = [*F64, "T_final=4.2", "coupled_fused_cycles=4",
            "coupled_launch_steps=2", "coupled_launch_flow_iters=50",
            "implicit_extrapolate_x0=1"]
    solver, jax_out, port_out = _both(tmp_path, capsys, monkeypatch, args,
                                      args)
    assert_rows_match(read_csv(tmp_path / "port"), read_csv(tmp_path / "jax"))
    jax_lines, port_lines = _fused_lines(jax_out), _fused_lines(port_out)
    assert port_lines == jax_lines
    assert len(port_lines) >= 6
    assert solver.cycle_graph["eager_launches"] == len(port_lines)
