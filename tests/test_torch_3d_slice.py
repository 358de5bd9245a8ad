"""The port's 3D slice against the JAX package: ``cli.run`` (the
``python -m pd_mg_pin_corrosion_tpu_torch`` path, on the CPU) and the JAX
``CoupledSolver.run`` on config/params_3d.cfg cut to the small 3D grid of
tests/test_pallas_interpret.py (8,303 nodes, S = 178), with faster solid
diffusivities so that five coupling cycles dissolve the wire within 21 s
of physics, and the flow capped at 100 iterations (50 per re-solve).

In float32 the JAX side's NS step is its Pallas kernel (ns_step_pallas_3d,
the act-static form its TPU runs and the port's ns3d computes) through the
Pallas interpreter, as tests/test_pallas_interpret.py runs it on the CPU;
the XLA form rounds differently, and its f32 C_max_fluid differs from the
port's by 1.8e-4 here. float64 runs compare with the XLA form (the Pallas
kernel is f32 only).

Gates: f64 as tests/test_parity.py (solid_nodes exact, time_s 1e-9, the
rest 1e-6 relative); f32 solid_nodes exact, the rest 1e-4 relative."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu_torch import cli

torch.set_num_threads(2)

CFG_3D = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config", "params_3d.cfg")
# the small grid, tests/test_3d.py's cfg3d() flow rate, solid
# diffusivities 10x below cfg3d()'s, one dissolved node ends a cycle, and
# the JAX package's host loop (its fused loops give the same CSVs)
SMALL = ["dx=8e-6", "R_wire=16e-6", "L_wire=64e-6", "R_tube=48e-6",
         "L_upstream=32e-6", "L_downstream=32e-6", "Q_flow=1.667e-10",
         "D_grain=5e-12", "D_gb=5e-10", "corrosion_accel_l=0",
         "dissolution_batch=1", "flow_max_iters=100",
         "flow_max_iters_resolve=50", "implicit_fused_chunk=0",
         "coupled_fused_cycles=0", "T_final=21"]


def run_jax(out, overrides):
    cfg = JConfig.load(CFG_3D)
    cfg.apply_overrides([*SMALL, f"output_dir={out}", *overrides])
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    state = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                               dtype=kit.jdtype)
    JSolver().run(grid, state, kit, cfg)
    return read_csv(out)


def run_port(out, overrides):
    solver = cli.run([CFG_3D, *SMALL, f"output_dir={out}", *overrides,
                      "--device", "cpu"])
    return solver, read_csv(out)


def read_csv(out):
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def assert_rows_match(ours, ref, f64):
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"],
                               rtol=1e-9 if f64 else 1e-4)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col],
                                   rtol=1e-6 if f64 else 1e-4, err_msg=col)


def run_jax_pallas_ns(out, overrides, monkeypatch):
    """run_jax with the f32 3D NS step on the Pallas kernel, interpreted.
    jit caches are cleared on both sides so that no other run in this
    process reuses a trace of the other NS step."""
    jax.clear_caches()
    try:
        with monkeypatch.context() as m:
            m.setattr(pk, "INTERPRET", True)
            m.setattr(pk, "pallas_applicable_3d", lambda kit: (
                kit.dim == 3 and kit.jdtype == jnp.float32))
            return run_jax(out, overrides)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_slice_3d_matches_jax(precision, tmp_path, capsys, monkeypatch):
    ov = [f"precision={precision}"]
    if precision == "f32":
        ref = run_jax_pallas_ns(tmp_path / "jax", ov, monkeypatch)
    else:
        ref = run_jax(tmp_path / "jax", ov)
    solver, ours = run_port(tmp_path / "port", ov)
    out = capsys.readouterr().out
    # five cycles, each ended by dissolution (the wire's last 3 nodes stay)
    assert solver.cycles == 5 and solver.total_dissolved == 96
    assert np.count_nonzero(np.diff(ours["solid_nodes"])) == 4
    assert solver.gmres_warnings == 0
    assert len(ours) == 7 and ours["solid_nodes"][-1] == 4
    assert_rows_match(ours, ref, precision == "f64")
    # the Poiseuille validation is a 2D check: no line in 3D, in either package
    assert "Poiseuille" not in out
    files = set(os.listdir(tmp_path / "port"))
    assert {"simulation.pvd", "flow.pvd", "mass_loss.csv"} <= files
    assert any(f.startswith("final_") and f.endswith(".vti") for f in files)
