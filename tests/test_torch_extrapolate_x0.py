"""implicit_extrapolate_x0 in the port, by the JAX package's rule: the knob
acts only in the device loops. In a chunk of implicit_fused_chunk steps
(the JAX package's ``implicit_inner_chunk``) each step starts GMRES from
2 C_n - C_{n-1} (clipped to [0, C_solid_init] on the unknown rows, C on the
others), C_n taken after the step's BCs and C_{n-1} before the previous
step's, the history seeded with C at the start of every chunk (the JAX
launch's ``init + (state.C,)``); one step at a time every step starts from
C after its BCs, whatever the knob says (the JAX CLI calls
``implicit_inner_step(state, op, kit)``).

Against the JAX CLI in float64 with the knob on: a launch a cycle, chunks
of 2 that end inside a cycle and at an output boundary, the step-at-a-time
route, and gs_parity (whose host sweeps step one at a time in the port,
the history re-seeded where a JAX chunk starts). Gates:
tests/test_parity.py's (solid_nodes exact, time_s 1e-9, the rest 1e-6);
with the knob off the CSVs are those the port wrote before the knob
existed, byte for byte.
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


def _assert_gates(ours, ref):
    """tests/test_parity.py's gates, row by row."""
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6, err_msg=col)


def test_extrapolated_start_f64_matches_jax(tmp_path):
    """The whole capped parity.cfg run with the knob on, both CLIs with
    implicit_fused_chunk = 50: a launch (a chunk) a cycle."""
    overrides = [*KNOB, "implicit_fused_chunk=50"]
    ref = _run_jax(tmp_path / "jax", overrides)
    solver, ours = _run_port(tmp_path / "port", overrides)
    assert solver.total_dissolved == 180 and len(ours) == len(ref) >= 6
    assert max(solver.cycle_steps) >= 2  # a cycle the knob acts in
    assert solver.step_graph["chunks"] == solver.cycles
    _assert_gates(ours, ref)


# chunks of 2 in cycles of 5 steps (no dissolution ends one) with a VTI
# every 3 steps: cycle 1 runs chunks [1, 2], [3] (output boundary), [4, 5];
# cycle 2 [6] (output boundary), [7]
SHORT_CHUNKS = [*KNOB, "implicit_fused_chunk=2", "implicit_output_every=3",
                "dissolution_batch=1000", "corrosion_steps_per_check=5",
                "T_final=4.2"]


def test_chunks_inside_a_cycle_f64_match_jax(tmp_path):
    """Chunks that end inside a cycle, at the launch cap and at an output
    boundary, each re-seeding the history: the port's CLI against the JAX
    CLI in float64, the same VTI snapshots."""
    ref = _run_jax(tmp_path / "jax", SHORT_CHUNKS)
    solver, ours = _run_port(tmp_path / "port", SHORT_CHUNKS)
    assert solver.cycle_steps == [5, 2]
    assert solver.step_graph["chunks"] == 5
    _assert_gates(ours, ref)
    vti = sorted(p.name for p in (tmp_path / "port").glob("corr_*.vti"))
    assert vti == sorted(p.name for p in (tmp_path / "jax").glob(
        "corr_*.vti")) and len(vti) == 2


def test_step_at_a_time_f64_matches_jax(tmp_path):
    """implicit_fused_chunk = 0 with the knob on: both CLIs start every
    step from C after its BCs; the rows to the gates."""
    overrides = [*KNOB, "T_final=1.2"]
    ref = _run_jax(tmp_path / "jax", overrides)
    solver, ours = _run_port(tmp_path / "port", overrides)
    assert solver.step_graph["chunks"] == 0 and solver.cycle_steps == [2]
    _assert_gates(ours, ref)


# gs_parity with chunks of 2 in cycles of 3 steps: the port steps one at a
# time (host sweeps) and re-seeds after the cap, where JAX's chunk ends
GS_CHUNKS = [*KNOB, "gs_parity=1", "implicit_fused_chunk=2",
             "dissolution_batch=1000", "corrosion_steps_per_check=3",
             "T_final=2.4"]


def test_gs_parity_chunks_f64_match_jax(tmp_path, monkeypatch):
    """gs_parity under implicit_fused_chunk = 2 with the knob on: the JAX
    CLI runs chunks, the port steps one at a time and re-seeds the history
    wherever a JAX chunk starts (seen in the runner's ``reseed`` calls);
    the rows to the gates."""
    seeds = []
    real = coupling.StepRunner.reseed

    def reseed(self):
        seeds.append(self.C_prev is not None)
        return real(self)

    monkeypatch.setattr(coupling.StepRunner, "reseed", reseed)
    ref = _run_jax(tmp_path / "jax", GS_CHUNKS)
    solver, ours = _run_port(tmp_path / "port", GS_CHUNKS)
    assert solver.cycle_steps == [3, 1]
    assert solver.step_graph["chunks"] == 0
    # after step 2 of cycle 1 (the cap); the cycles' starts seed in begin
    assert seeds == [True]
    _assert_gates(ours, ref)


def _spied_run(tmp_path, monkeypatch, overrides, cycle_steps=(2,)):
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
    n = sum(cycle_steps)   # steps of 0.6 s: T_final halfway into the last
    solver, _ = _run_port(tmp_path, [*overrides,
                                     f"T_final={0.6 * n - 0.3:.1f}"])
    assert solver.cycle_steps == list(cycle_steps)
    assert len(steps) == len(starts) == n
    return solver, steps, starts


def _extrapolated(step, C_prev):
    """The start the JAX rule gives a step whose history holds C_prev."""
    c_max = step["C_bc"].new_tensor(1.0)  # C_solid_init
    return torch.where(step["unknown"], torch.clamp(
        2.0 * step["C_bc"] - C_prev, 0.0, c_max), step["C_bc"])


def test_second_step_starts_from_the_extrapolation(tmp_path, monkeypatch):
    """The first cycle of parity.cfg has two steps, one chunk: the first
    starts GMRES from C, the second from the clipped 2 C_n - C_{n-1}."""
    _, steps, starts = _spied_run(tmp_path, monkeypatch,
                                  [*KNOB, "implicit_fused_chunk=50"])
    assert torch.equal(starts[0], steps[0]["C_bc"])
    s1 = steps[1]
    assert torch.equal(starts[1], _extrapolated(s1, steps[0]["C_pre"]))
    moved = (starts[1] != s1["C_bc"])
    assert bool(moved.any()) and bool(s1["unknown"][moved].all())


def test_a_chunk_inside_a_cycle_reseeds(tmp_path, monkeypatch):
    """Chunks of 2 in a cycle of 3 steps: the third step, the first of the
    second chunk, starts from its own C (the history re-seeded), not from
    the extrapolation of the second step's C that a carried history would
    give."""
    _, steps, starts = _spied_run(
        tmp_path, monkeypatch, [*KNOB, "implicit_fused_chunk=2",
                                "dissolution_batch=1000"], cycle_steps=(3,))
    assert torch.equal(starts[1], _extrapolated(steps[1], steps[0]["C_pre"]))
    s2 = steps[2]
    assert torch.equal(starts[2], _extrapolated(s2, s2["C_pre"]))
    assert torch.equal(starts[2], s2["C_bc"])
    assert not torch.equal(starts[2], _extrapolated(s2, steps[1]["C_pre"]))


def test_knob_off_starts_every_step_from_c(tmp_path, monkeypatch):
    _, steps, starts = _spied_run(tmp_path, monkeypatch, BASE)
    for s, x0 in zip(steps, starts):
        assert torch.equal(x0, s["C_bc"])


def test_knob_step_at_a_time_starts_every_step_from_c(tmp_path, monkeypatch):
    """implicit_fused_chunk = 0 with the knob on: every step starts GMRES
    from C after its BCs, as with the knob off."""
    _, steps, starts = _spied_run(tmp_path, monkeypatch, KNOB)
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
