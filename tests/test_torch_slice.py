"""The port's whole slice against the JAX package: ``cli.run`` (the
``python -m pd_mg_pin_corrosion_tpu_torch`` path, on the CPU) and the JAX
``CoupledSolver.run`` on tests/golden/parity.cfg, capped the same way, give
the same diagnostics.csv; plus the configurations the CLI runs since
gs_parity, the warm start, the sub-cell mirror, 3D explicit transport, the
gather AMR backend and implicit_extrapolate_x0 were ported, and the VTI
writer."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu.io_vtk import VTKWriter as JWriter
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import cli, coupling, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.io_vtk import VTKWriter as TWriter

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
# flow capped at 300 iterations per solve (the JAX package needs ~10^4 to
# converge here); T_final stays 100 s, so all 180 solid nodes dissolve
CAPS = ["flow_max_iters=300"]


def _run_jax(out, overrides):
    cfg = JConfig.load(PARITY)
    cfg.apply_overrides([f"output_dir={out}", *overrides])
    grid = j_build_grid(cfg)
    g = j_grains.generate(grid, cfg)
    kit = j_build_kit(grid, cfg)
    state = j_initialize_state(grid, cfg, grains=g, dtype=kit.jdtype)
    JSolver().run(grid, state, kit, cfg)
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def _run_port(out, overrides):
    solver = cli.run([PARITY, f"output_dir={out}", *overrides,
                      "--device", "cpu"])
    rows = np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))
    return solver, rows


def test_slice_f64_matches_jax(tmp_path, capsys):
    ov = ["precision=f64", *CAPS]
    ref = _run_jax(tmp_path / "jax", ov)
    jax_out = capsys.readouterr().out
    solver, ours = _run_port(tmp_path / "port", ov)
    # the 2D in-path Poiseuille validation prints the same line per flow solve
    lines = [[ln for ln in out.splitlines() if "Poiseuille" in ln]
             for out in (jax_out, capsys.readouterr().out)]
    assert len(lines[0]) == solver.flow_solve_count and lines[0] == lines[1]
    assert solver.total_dissolved == 180 and len(ours) == len(ref) >= 6
    # tests/test_parity.py's gates
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6, err_msg=col)
    files = set(os.listdir(tmp_path / "port"))
    assert {"simulation.pvd", "flow.pvd", "mass_loss.csv"} <= files
    assert any(f.startswith("final_") and f.endswith(".vti") for f in files)


def test_slice_f32_first_cycle_matches_jax(tmp_path):
    # T_final = 1.2 s: exactly the first coupling cycle (two 0.6 s steps)
    ov = ["precision=f32", "T_final=1.2", *CAPS]
    ref = _run_jax(tmp_path / "jax", ov)
    solver, ours = _run_port(tmp_path / "port", ov)
    assert solver.cycles == 1 and len(ours) == len(ref) == 2
    assert solver.gmres_warnings == 0
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-4, err_msg=col)


# tests/test_pallas_interpret.py's 3D geometry for the 3D cases
GRID_3D = ("dim=3 dx=8e-6 R_wire=16e-6 L_wire=64e-6 R_tube=48e-6 "
           "L_upstream=32e-6 L_downstream=32e-6")


RUNS = ["gs_parity=1", "flow_warm_start=2", "dim=3 wall_mirror_subcell=1",
        "dim=3 use_implicit=0", "dim=3 gs_parity=1"]


@pytest.mark.parametrize("override", [
    ov.replace("dim=3", GRID_3D) for ov in RUNS], ids=RUNS)
def test_cli_runs_configs_of_the_uniform_grid(override, tmp_path):
    """The configurations the CLI refused before gs_parity, the warm start,
    the sub-cell mirror and 3D explicit transport were ported: a short run
    (20 flow iterations a solve, one coupling cycle) writes its
    diagnostics."""
    _short_run(override, tmp_path)


def _short_run(override, tmp_path):
    t_final = "T_final=1e-5" if "use_implicit=0" in override else "T_final=0.6"
    assert cli.main([PARITY, f"output_dir={tmp_path}", *override.split(),
                     "flow_max_iters=20", t_final, "--device", "cpu"]) == 0
    rows = np.atleast_1d(np.genfromtxt(f"{tmp_path}/diagnostics.csv",
                                       delimiter=",", names=True))
    assert len(rows) >= 1 and all(np.isfinite(rows[c]).all()
                                  for c in rows.dtype.names)


@pytest.mark.parametrize("override", [
    pytest.param("use_amr=1 amr_backend=gather", id="use_amr=1"),
    "implicit_extrapolate_x0=1"])
def test_cli_runs_the_configs_it_refused(override, tmp_path):
    """The two configurations the CLI refused until the gather AMR backend
    and implicit_extrapolate_x0 were ported (the cases of the former
    test_cli_refuses_configs_outside_the_slice): a short run writes its
    diagnostics. The CLI now refuses no configuration the JAX package
    runs."""
    _short_run(override, tmp_path)


def test_cli_names_the_flow_warm_start_item(tmp_path, capsys):
    """The CLI runs the warm start of the initial flow solve and prints the
    JAX package's warm-start line (solvers.coarse_warm_start) for the
    same configuration."""
    from pd_mg_pin_corrosion_tpu.solvers import coarse_warm_start

    ov = ["flow_warm_start=2", "flow_max_iters=20", "T_final=0.6"]
    cfg = JConfig.load(PARITY)
    cfg.apply_overrides(ov)
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    capsys.readouterr()
    coarse_warm_start(j_initialize_state(grid, cfg, dtype=kit.jdtype), grid,
                      kit, cfg)
    ref = [ln for ln in capsys.readouterr().out.splitlines()
           if "Warm start" in ln]
    solver = cli.run([PARITY, f"output_dir={tmp_path}", *ov,
                      "--device", "cpu"])
    ours = [ln for ln in capsys.readouterr().out.splitlines()
            if "Warm start" in ln]
    assert len(ref) == 1 and ours == ref
    assert ref[0].startswith("  Warm start: coarse (2x dx, 667 nodes) "
                             "solve 21 iters")
    assert solver.coarse_iters == 21 and solver.flow_solve_count >= 1


def test_run_flushes_the_flow_writer_with_the_state_writer(tmp_path,
                                                           monkeypatch):
    """Both writers are flushed before each checkpoint and at exit: one
    cycle (T_final = 1.2 s), a flow snapshot, a checkpoint, binary VTI."""
    flushed = []

    class Counting(TWriter):
        def flush(self):
            flushed.append(self)
            super().flush()

    monkeypatch.setattr(coupling, "VTKWriter", Counting)
    solver, rows = _run_port(tmp_path, [
        "precision=f32", "flow_max_iters=30", "T_final=1.2",
        "checkpoint_every=1", "vtk_binary=1"])
    assert solver.cycles == 1 and len(rows) == 2
    assert {"flow.pvd", "checkpoint.npz"} <= set(os.listdir(tmp_path))
    # (the state writer also joins its last write before each new one)
    assert sum(w is solver.flow_writer for w in flushed) == 2
    assert sum(w is solver.writer for w in flushed) >= 2


def test_cli_without_cuda_fails_unless_cpu_is_asked(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PD_TORCH_DEVICE", raising=False)
    assert cli.main([PARITY, f"output_dir={tmp_path}"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "diagnostics.csv")
    assert cli.parse_args([PARITY, "a=1", "--device", "cpu"]) == (
        PARITY, ["a=1"], "cpu")
    monkeypatch.setenv("PD_TORCH_DEVICE", "cpu")
    assert cli.parse_args([])[2] == "cpu"


@pytest.mark.parametrize("binary", [0, 1])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_vti_bytes_match_jax_writer(precision, binary, tmp_path):
    cfg = JConfig.load(PARITY)
    cfg.apply_overrides([f"precision={precision}", f"vtk_binary={binary}"])
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    js = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                            dtype=kit.jdtype)
    rng = np.random.default_rng(4)
    js = dataclasses.replace(js, C=jnp.asarray(rng.random(kit.shape), kit.jdtype))
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)},
                          dtype=torch.float32 if precision == "f32" else torch.float64,
                          device="cpu")
    tgrid = t_build_grid(TConfig.load(PARITY))
    a, b = str(tmp_path / "jax.vti"), str(tmp_path / "port.vti")
    jw, tw = JWriter(), TWriter()
    jw.write(a, grid, js, cfg)
    tw.write(b, tgrid, ts, cfg)
    jw.flush()
    tw.flush()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
