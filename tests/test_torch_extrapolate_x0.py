"""implicit_extrapolate_x0 in the port: each implicit step after the first of
a coupling cycle starts GMRES from 2 C_n - C_{n-1} (clipped to
[0, C_solid_init] on the unknown rows, C on the others), C_n taken after
the step's BCs and C_{n-1} before the previous step's; the first step of a
cycle starts from C.

In the JAX package the knob acts only inside its fused device loop, which
re-seeds the history at the start of every launch; with
implicit_fused_chunk >= corrosion_steps_per_check a launch is a cycle
(coupling.py:852-854), and parity.cfg's implicit_output_every lies beyond
the run, so no output boundary ends a launch early. Gates:
tests/test_parity.py's (solid_nodes exact, time_s 1e-9, the rest 1e-6) in
float64; with the knob off the CSVs are those the port wrote before the
knob existed, byte for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu_torch import cli, coupling
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
# tests/test_torch_slice.py's cap: 300 flow iterations a solve
BASE = ["precision=f64", "flow_max_iters=300"]
KNOB = [*BASE, "implicit_extrapolate_x0=1"]
# the port's CSVs of parity.cfg with BASE and T_final = 2.4 s (three
# cycles, the first of two steps), as the CLI wrote them before
# implicit_extrapolate_x0 was ported
BEFORE = {
    "diagnostics.csv": (
        "time_s,time_h,pin_mass_loss_pct,solid_nodes,v_max,C_max_fluid\n"
        "6.000000e-01,1.666667e-04,2.346784e+01,180,1.882253e+00,8.319930e-03\n"
        "1.200000e+00,3.333333e-04,3.647072e+01,180,1.882253e+00,5.079639e-03\n"
        "1.800000e+00,5.000000e-04,4.583791e+01,168,1.617254e+00,5.794556e-03\n"
        "2.400000e+00,6.666667e-04,5.950567e+01,122,1.668393e+00,6.711327e-03\n"),
    "mass_loss.csv": (
        "time_h,pin_mass_loss_pct\n"
        "0.000167,23.467839\n"
        "0.000333,36.470715\n"
        "0.000500,45.837913\n"
        "0.000667,59.505671\n"),
}


def _rows(out):
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def _run_jax(out, overrides):
    cfg = JConfig.load(PARITY)
    cfg.apply_overrides([f"output_dir={out}", *overrides])
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    state = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                               dtype=kit.jdtype)
    JSolver().run(grid, state, kit, cfg)
    return _rows(out)


def _run_port(out, overrides):
    solver = cli.run([PARITY, f"output_dir={out}", *overrides,
                      "--device", "cpu"])
    return solver, _rows(out)


def test_extrapolated_start_f64_matches_jax(tmp_path):
    """The whole capped parity.cfg run with the knob on, against the JAX
    package's fused loop, one launch a cycle."""
    ref = _run_jax(tmp_path / "jax", [*KNOB, "implicit_fused_chunk=50"])
    solver, ours = _run_port(tmp_path / "port", KNOB)
    assert solver.total_dissolved == 180 and len(ours) == len(ref) >= 6
    assert max(solver.cycle_steps) >= 2  # a cycle the knob acts in
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6, err_msg=col)


def _spied_run(tmp_path, monkeypatch, overrides):
    """Per implicit step: C before the step, C after its BCs (what the
    solve is handed), the unknown rows, and the start GMRES was given,
    read from the step runner's buffers around its head segment."""
    steps, starts = [], []
    real_head = coupling.StepRunner.head

    def head(self, kit, sys):
        steps.append({"C_pre": self.state.C.clone()})
        out = real_head(self, kit, sys)
        steps[-1].update(C_bc=self.state.C.clone(),
                         unknown=sys.unknown.clone())
        starts.append(self.run.x.clone())
        return out

    monkeypatch.setattr(coupling.StepRunner, "head", head)
    solver, _ = _run_port(tmp_path, [*overrides, "T_final=1.2"])
    assert solver.cycle_steps == [2] and len(steps) == len(starts) == 2
    return solver, steps, starts


def test_second_step_starts_from_the_extrapolation(tmp_path, monkeypatch):
    """The first cycle of parity.cfg has two steps: the first starts GMRES
    from C, the second from the clipped 2 C_n - C_{n-1}."""
    solver, steps, starts = _spied_run(tmp_path, monkeypatch, KNOB)
    c_max = solver.final_state.C.new_tensor(1.0)  # C_solid_init
    assert torch.equal(starts[0], steps[0]["C_bc"])
    s1 = steps[1]
    want = torch.where(s1["unknown"], torch.clamp(
        2.0 * s1["C_bc"] - steps[0]["C_pre"], 0.0, c_max), s1["C_bc"])
    assert torch.equal(starts[1], want)
    moved = (starts[1] != s1["C_bc"])
    assert bool(moved.any()) and bool(s1["unknown"][moved].all())


def test_knob_off_starts_every_step_from_c(tmp_path, monkeypatch):
    _, steps, starts = _spied_run(tmp_path, monkeypatch, BASE)
    for s, x0 in zip(steps, starts):
        assert torch.equal(x0, s["C_bc"])


def test_knob_off_csvs_are_unchanged(tmp_path):
    _run_port(tmp_path, [*BASE, "T_final=2.4"])
    for name, text in BEFORE.items():
        assert (tmp_path / name).read_text() == text, name


def test_block_step_with_a_start_equals_jax():
    """amr_blocks.implicit_step's x0 against the JAX package's, on
    tests/test_torch_amr_blocks.py's block configuration in float64: an
    overshooting start (clipped on the unknown rows, C elsewhere) reaches
    the solution of the step from C, to the solve's tolerance."""
    from test_torch_amr_blocks import _states

    from pd_mg_pin_corrosion_tpu import amr_blocks as jab
    from pd_mg_pin_corrosion_tpu_torch import amr_blocks as tab

    jk, js, tk, ts, _ = _states("coupled", "f64")
    jop, top = jab.assemble(js, jk, 0.05), tab.assemble(ts, tk, 0.05)
    dt = float(jab.compute_adaptive_dt(js, jop, jk))
    x0 = 2.0 * ts.C - 0.5 * ts.C.flip(0)
    js2, res_j = jab.implicit_step(js, jop, jk, dt,
                                   x0=jnp.asarray(x0.numpy()))
    ts2, res_t = implicit_step(tab.linear_system, ts, top, tk, dt, x0=x0)
    ts_c, _ = implicit_step(tab.linear_system, ts, top, tk, dt)
    assert res_t <= 1e-10 and float(res_j) <= 1e-10
    scale = float(np.abs(np.asarray(js2.C)).max())
    # the same start: tests/test_torch_amr_blocks.py's gate
    np.testing.assert_allclose(ts2.C.numpy(), np.asarray(js2.C), rtol=0,
                               atol=1e-10 * scale)
    # another start: the same solution to what a 1e-10 residual leaves
    np.testing.assert_allclose(ts2.C.numpy(), ts_c.C.numpy(), rtol=0,
                               atol=1e-9 * scale)
    assert not torch.equal(ts2.C, ts_c.C)
