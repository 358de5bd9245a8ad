"""``implicit_fused_chunk``: a cycle's implicit steps in chunks whose exits,
time and diagnostic rows the device decides (``coupling.StepRunner.chunk``,
the JAX package's ``implicit_inner_chunk``), one host read a chunk.

Within the port, on the CPU (each gate a host read of gmres_qr's flag),
the CLI with chunks against the CLI one step at a time on parity.cfg f32:
diagnostics.csv and mass_loss.csv byte for byte, the same VTI files (names
and bytes), the same steps a cycle and the same console lines, with a
chunk that ends at the step budget, at T_final, at the dissolution batch,
at an output boundary inside it, with the extrapolated start (re-seeded
at each chunk, as the JAX package's launches do: the steps at a time
follow that rule on the route gs_parity's host sweeps take), and at the
default launch cap (implicit_fused_chunk = 1).

Against the JAX CLI, both with implicit_fused_chunk = 4 in float64,
capped: the rows to tests/test_parity.py's gates and the console lines
both print equal, GMRES's per-chunk warning included (forced in both by a
chunk that reports a residual above 100 tol).
"""

import os

import pytest
import torch
from test_torch_shipped_configs import assert_rows_match, lines_of, read_csv

from pd_mg_pin_corrosion_tpu import cli as j_cli
from pd_mg_pin_corrosion_tpu import coupling as j_coupling
from pd_mg_pin_corrosion_tpu_torch import cli as t_cli
from pd_mg_pin_corrosion_tpu_torch import coupling

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
BASE = [PARITY, "precision=f32", "flow_max_iters=300"]
# overrides of each case; parity.cfg's steps are 0.6 s at this state
CASES = {
    # 6 steps a cycle: a chunk of 4, then one of the 2 left; T_final
    # inside the next cycle's first chunk
    "budget_and_T_final": ["corrosion_steps_per_check=6",
                           "dissolution_batch=1000", "T_final=5.4"],
    "batch": ["dissolution_batch=20", "T_final=3.6"],
    # a VTI every 3 steps, a row every 2: a chunk of 4 stops at step 3
    "output_boundary": ["implicit_output_every=3", "diagnostic_every=2",
                        "dissolution_batch=1000",
                        "corrosion_steps_per_check=7", "T_final=4.2"],
    "extrapolated_start": ["implicit_extrapolate_x0=1",
                           "dissolution_batch=1000", "T_final=4.2"],
}
# the console lines of a run that both routes print
SHARED = ("=== Coupling cycle", "Flow", "t=", "Implicit cycle:",
          "Phase change:", "No phase changes", "Skipping flow solve",
          "WARNING: GMRES", "=== All solid nodes dissolved", "Final time:")


def _run(tmp, tag, extra, capsys):
    capsys.readouterr()
    solver = t_cli.run([*BASE, *extra, f"output_dir={tmp / tag}",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln.strip() for ln in out.splitlines()
             if ln.strip().startswith(SHARED)]
    return solver, lines


def _files(path):
    """{name: bytes} of a run's CSVs and VTI snapshots."""
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))
            if n.endswith((".csv", ".vti"))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_equal_steps_at_a_time(case, tmp_path, capsys, monkeypatch):
    """The CLI with implicit_fused_chunk = 4 against the same run one step
    at a time: the same CSV bytes, VTI files, steps a cycle and console
    lines; the chunks read the host once each. With the extrapolated
    start, the steps at a time follow the JAX chunk's rule: the run takes
    implicit_fused_chunk = 4 on gs_parity's step-at-a-time route (forced
    on this kit, which has no gs_parity tables), whose history is
    re-seeded where a chunk of 4 starts."""
    extra = CASES[case]
    route = "implicit_fused_chunk=0"
    with monkeypatch.context() as m:
        if case == "extrapolated_start":
            m.setattr(coupling, "parity_tables", lambda kit: True)
            route = "implicit_fused_chunk=4"
        step, step_lines = _run(tmp_path, "step", [*extra, route], capsys)
    chunk, chunk_lines = _run(tmp_path, "chunk", [*extra,
                                                  "implicit_fused_chunk=4"],
                              capsys)
    assert chunk.cycle_steps == step.cycle_steps
    assert chunk_lines == step_lines
    files = _files(tmp_path / "chunk")
    assert files == _files(tmp_path / "step")
    assert step.step_graph["chunks"] == 0 < chunk.step_graph["chunks"]
    assert chunk.step_graph["steps"] == step.step_graph["steps"] == sum(
        step.cycle_steps)
    # a chunk holds at most 4 steps, a cycle takes ceil(steps / 4) at least
    assert chunk.step_graph["chunks"] >= sum(-(-n // 4)
                                             for n in step.cycle_steps)
    rows = files["diagnostics.csv"].decode().count("\n") - 1
    if case == "budget_and_T_final":
        assert step.cycle_steps[0] == 6 and sum(step.cycle_steps) == 9
    if case == "batch":
        assert max(step.cycle_steps) > 1 and step.total_dissolved >= 20
    if case == "extrapolated_start":
        assert max(step.cycle_steps) > 4   # a chunk starts inside a cycle
    if case == "output_boundary":
        vti = [n for n in files if n.startswith("corr_")]
        assert len(vti) == sum(step.cycle_steps) // 3 > 0
        assert rows == sum(step.cycle_steps) // 2
        # a chunk ended at each boundary inside a cycle
        assert chunk.step_graph["chunks"] > sum(-(-n // 4)
                                                for n in step.cycle_steps)
    else:
        assert rows == sum(step.cycle_steps)


def test_default_launch_cap(tmp_path, capsys):
    """implicit_fused_chunk = 1 takes chunks of up to 50 steps (the JAX
    package's default cap): a cycle of more than 4 steps (T_final ends it)
    is one chunk, the same rows as one step at a time."""
    extra = ["dissolution_batch=1000", "corrosion_steps_per_check=12",
             "T_final=7.2"]
    step, step_lines = _run(tmp_path, "step", extra, capsys)
    chunk, chunk_lines = _run(tmp_path, "chunk",
                              [*extra, "implicit_fused_chunk=1"], capsys)
    assert step.cycle_steps == chunk.cycle_steps
    assert len(step.cycle_steps) == 1 and step.cycle_steps[0] > 4
    assert chunk.step_graph["chunks"] == 1 and chunk_lines == step_lines
    assert _files(tmp_path / "chunk") == _files(tmp_path / "step")


def _force_residual(monkeypatch, value):
    """Both packages' first chunk reports max |res| = value (GMRES's
    telemetry only: the states and rows are the chunk's own)."""
    calls = {"port": 0, "jax": 0}
    real_port = coupling.StepRunner.chunk

    def port_chunk(self, *a, **k):
        t, n, dis, mr, rows = real_port(self, *a, **k)
        calls["port"] += 1
        return t, n, dis, (value if calls["port"] == 1 else mr), rows

    real_jax = j_coupling.implicit_inner_chunk

    def jax_chunk(*a, **k):
        out = real_jax(*a, **k)
        calls["jax"] += 1
        if calls["jax"] == 1:
            out = (*out[:4], value, *out[5:])
        return out

    monkeypatch.setattr(coupling.StepRunner, "chunk", port_chunk)
    monkeypatch.setattr(j_coupling, "implicit_inner_chunk", jax_chunk)
    return calls


def test_chunks_against_the_jax_cli(tmp_path, capsys, monkeypatch):
    """parity.cfg in float64, capped, through both CLIs with
    implicit_fused_chunk = 4 and a VTI every 3 steps, each first chunk
    reporting a residual above 100 tol: the rows to tests/test_parity.py's
    gates and the console lines both print equal (grid, cycles, rows,
    phase changes, GMRES's per-chunk warning once)."""
    calls = _force_residual(monkeypatch, 1.5e-3)
    args = [PARITY, "precision=f64", "flow_max_iters=300", "T_final=2.4",
            "implicit_fused_chunk=4", "implicit_output_every=3"]
    capsys.readouterr()
    monkeypatch.setenv("PD_TPU_CACHE", "")
    assert j_cli.main([*args, f"output_dir={tmp_path / 'jax'}"]) == 0
    jax_lines = lines_of(capsys.readouterr().out)
    solver = t_cli.run([*args, f"output_dir={tmp_path / 'port'}",
                        "--device", "cpu"])
    port_lines = lines_of(capsys.readouterr().out)
    assert_rows_match(read_csv(tmp_path / "port"), read_csv(tmp_path / "jax"))
    assert port_lines == jax_lines
    assert solver.step_graph["chunks"] >= solver.cycles >= 2
    assert calls["port"] > 1 and calls["jax"] > 1
    assert [ln for ln in port_lines if ln.startswith("WARNING")] == [
        "WARNING: GMRES did not converge in at least one step (max "
        "|res|=1.50e-03)"]
    assert solver.gmres_warnings == 1
