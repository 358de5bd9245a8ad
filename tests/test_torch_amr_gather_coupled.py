"""The gather AMR backend end to end: the port's CLI (``cli.run`` on the CPU)
against the JAX package's ``CoupledSolver.run`` on
tests/test_amr_coupled.py::test_amr_coupled_run's configuration, plus the
VTU and PVD bytes, checkpoint/resume, and the warm start, which the gather
backend leaves out.

The runs stop at T_final = 2.4 s, the first four coupling cycles (four
flow solves that converge, 111 of the wire's 128 nodes dissolved). From
the fifth cycle on, the flow of this configuration exhausts its cap and
then trips the blow-up guard in both packages alike, as on the block grid
(tests/test_torch_amr_coupled.py). Gates: float64 to
tests/test_parity.py's (solid_nodes exact, time_s 1e-9, the rest 1e-6),
float32 within 1e-4.
"""

import dataclasses
import os

import numpy as np
import torch
from test_torch_amr_blocks import COUPLED

from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import unstructured as ju
from pd_mg_pin_corrosion_tpu.amr import build_amr_grid as j_build_amr_grid
from pd_mg_pin_corrosion_tpu.config import Config as JConfig
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu.fields import initialize_state as j_init
from pd_mg_pin_corrosion_tpu.io_vtk import VTKWriter as JWriter
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import cli, coupling, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.amr import build_amr_grid
from pd_mg_pin_corrosion_tpu_torch.io_vtk import VTKWriter as TWriter
from pd_mg_pin_corrosion_tpu_torch.unstructured import UKit

torch.set_num_threads(2)

GATHER = COUPLED + ["amr_backend=gather"]
RUN = GATHER + ["flow_max_iters=3000", "T_final=2.4",
                "corrosion_steps_per_check=10", "use_implicit=1",
                "implicit_output_every=1000000000", "diagnostic_every=1"]
# a cheap run for checkpoint/resume: both solves capped
CAPPED = GATHER + ["flow_max_iters=300", "flow_max_iters_resolve=100",
                   "corrosion_steps_per_check=10", "use_implicit=1",
                   "implicit_output_every=2", "precision=f32"]


def _rows(out):
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def _run_jax(out, overrides):
    """tests/test_amr_coupled.py's chain: build_amr_grid, grains.generate,
    build_ukit, initialize_state, CoupledSolver.run."""
    cfg = JConfig()
    cfg.apply_overrides([*overrides, f"output_dir={out}"])
    cfg.compute_derived()
    grid = j_build_amr_grid(cfg)
    kit = ju.build_ukit(grid, cfg)
    state = j_init(grid, cfg, grains=j_grains.generate(grid, cfg),
                   dtype=kit.jdtype)
    final = JSolver().run(grid, state, kit, cfg)
    return grid, final, _rows(out)


def _run_port(out, overrides):
    # an empty config file: the overrides apply to the defaults, as on the
    # JAX side
    solver = cli.run([os.devnull, *overrides, f"output_dir={out}",
                      "--device", "cpu"])
    return solver, _rows(out)


def _compare(ours, ref, rtol):
    assert len(ours) == len(ref) >= 4
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"],
                               rtol=min(rtol, 1e-9))
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=rtol, err_msg=col)


def test_gather_run_f64_matches_jax(tmp_path, capsys):
    ov = [*RUN, "precision=f64"]
    jgrid, jfinal, ref = _run_jax(tmp_path / "jax", ov)
    jax_out = capsys.readouterr().out
    solver, ours = _run_port(tmp_path / "port", ov)
    port_out = capsys.readouterr().out
    _compare(ours, ref, 1e-6)
    assert solver.flow_solve_count == 4 and solver.total_dissolved == 128 - int(
        (np.asarray(jfinal.node_type) == 1).sum())
    assert all(r[2] for r in solver.flow_results)  # every solve converged
    # the same grid and grain lines and flow solves, no Poiseuille check
    for key in ("AMR:", "Grain generation", "Flow:"):
        assert ([ln for ln in jax_out.splitlines() if key in ln]
                == [ln for ln in port_out.splitlines() if key in ln]), key
    assert "Poiseuille" not in port_out
    final = solver.final_state
    np.testing.assert_array_equal(final.node_type.numpy(),
                                  np.asarray(jfinal.node_type))
    np.testing.assert_allclose(final.C.numpy(), np.asarray(jfinal.C),
                               rtol=0, atol=1e-9)

    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert {"simulation.pvd", "flow.pvd"} <= set(files)
    vtu = [f for f in files if f.endswith(".vtu")]
    assert vtu and not any(f.endswith(".vti") for f in files)
    # the initial state's snapshot (equal inputs) and the collections
    for name in [f for f in vtu if f.startswith("state_")] + [
            "simulation.pvd", "flow.pvd"]:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name

    # write_vtu of one f64 state gives the JAX writer's bytes
    host = {f.name: np.asarray(getattr(jfinal, f.name))
            for f in dataclasses.fields(jfinal)}
    cfg = TConfig()
    cfg.apply_overrides(ov)
    tgrid = build_amr_grid(cfg.compute_derived())
    JWriter().write_vtu(str(tmp_path / "j.vtu"), jgrid, jfinal, None)
    TWriter().write_vtu(str(tmp_path / "t.vtu"), tgrid, state_from_numpy(
        host, dtype=torch.float64, device="cpu"))
    assert (tmp_path / "j.vtu").read_bytes() == (tmp_path / "t.vtu").read_bytes()


def test_gather_run_f32_matches_jax(tmp_path):
    ov = [*RUN, "precision=f32"]
    _, _, ref = _run_jax(tmp_path / "jax", ov)
    solver, ours = _run_port(tmp_path / "port", ov)
    _compare(ours, ref, 1e-4)
    assert all(t.dtype in (torch.float32, torch.uint8, torch.int32,
                           torch.bool) for t in solver.final_state.tensors())
    assert solver.gmres_warnings == 0


def test_gather_resume_gives_the_uninterrupted_rows(tmp_path):
    """A checkpoint after the second cycle, resumed to T_final, gives the
    CSV rows of one uninterrupted run."""
    whole, whole_rows = _run_port(tmp_path / "whole",
                                  [*CAPPED, "T_final=3.0"])
    _, first = _run_port(tmp_path / "cut", [*CAPPED, "T_final=1.2",
                                            "checkpoint_every=2"])
    assert len(first) == 2 and os.path.exists(tmp_path / "cut" /
                                              "checkpoint.npz")
    resumed, rows = _run_port(tmp_path / "cut", [
        *CAPPED, "T_final=3.0",
        f"resume_from={tmp_path / 'cut' / 'checkpoint.npz'}"])
    assert len(rows) == len(whole_rows) >= 4
    for name in ("diagnostics.csv", "mass_loss.csv"):
        assert ((tmp_path / "cut" / name).read_text()
                == (tmp_path / "whole" / name).read_text()), name
    assert resumed.cycles == whole.cycles


def test_gather_leaves_the_first_solve_cold(tmp_path, monkeypatch, capsys):
    """flow_warm_start under the gather backend: the JAX package warm-starts
    only uniform grids and block AMR (coupling.py:659-662, :799-803), so
    the first solve runs cold from the initial state, as without the knob."""
    calls = []
    monkeypatch.setattr(coupling, "coarse_warm_start",
                        lambda *a: calls.append(a) or (a[0], 0))
    base = [*GATHER, "flow_max_iters=150", "T_final=0.6",
            "precision=f64"]
    warm, warm_rows = _run_port(tmp_path / "warm",
                                base + ["flow_warm_start=2"])
    assert calls == [] and warm.coarse_iters == 0
    assert "Warm start" not in capsys.readouterr().out
    cold, cold_rows = _run_port(tmp_path / "cold", base)
    assert warm.flow_results == cold.flow_results
    assert ((tmp_path / "warm" / "diagnostics.csv").read_text()
            == (tmp_path / "cold" / "diagnostics.csv").read_text())


def test_cli_refuses_no_amr_backend(tmp_path):
    """Both AMR backends build: ``amr_backend = structured`` gives the
    block kit, any other value the gather one (the JAX CLI's branches)."""
    from pd_mg_pin_corrosion_tpu_torch.amr_blocks import BKit
    for backend, kind in (("gather", UKit), ("structured", BKit)):
        cfg = TConfig()
        cfg.apply_overrides([*COUPLED, f"amr_backend={backend}"])
        _, kit, state = cli.build(cfg.compute_derived(), torch.device("cpu"))
        assert isinstance(kit, kind)
        assert state.rho.shape == kit.initial_solid_mask.shape
