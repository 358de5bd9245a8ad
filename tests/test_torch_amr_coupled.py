"""Block AMR end to end: the port's CLI (``cli.run`` on the CPU) against the
JAX package's ``CoupledSolver.run`` on tests/test_amr_coupled.py's block
configuration, plus the VTU writer, checkpoint/resume, the warm start on a
block grid and the CLI's refusal of the gather backend.

The runs stop at T_final = 2.4 s: the first four coupling cycles, 128 of
the wire's nodes down to 30, four flow solves that converge. From the
fifth cycle on the flow solve of this configuration (cfl_factor 0.25)
exhausts its cap and then trips the blow-up guard (v_max > 100 U_in) in
both packages alike; rows computed on such a flow field carry no meaning
in float32. Gates: float64 to tests/test_parity.py's (solid_nodes exact,
time_s 1e-9, the rest 1e-6), float32 within 1e-4.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_amr_blocks import COUPLED

from pd_mg_pin_corrosion_tpu import amr_blocks as jab
from pd_mg_pin_corrosion_tpu.config import Config as JConfig
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu.io_vtk import VTKWriter as JWriter
from pd_mg_pin_corrosion_tpu.solvers import coarse_warm_start as j_warm
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import amr_blocks as tab
from pd_mg_pin_corrosion_tpu_torch import cli, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.io_vtk import VTKWriter as TWriter
from pd_mg_pin_corrosion_tpu_torch.solvers import coarse_warm_start as t_warm

torch.set_num_threads(2)

RUN = COUPLED + ["flow_max_iters=3000", "T_final=2.4",
                 "corrosion_steps_per_check=10", "use_implicit=1",
                 "implicit_output_every=1000000000", "diagnostic_every=1"]
# a cheap run for checkpoint/resume: both solves capped
CAPPED = COUPLED + ["flow_max_iters=300", "flow_max_iters_resolve=100",
                    "corrosion_steps_per_check=10", "use_implicit=1",
                    "implicit_output_every=2", "precision=f32"]


def _rows(out):
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


def _run_jax(out, overrides):
    cfg = JConfig()
    cfg.apply_overrides([*overrides, f"output_dir={out}"])
    cfg.compute_derived()
    grid = jab.build_amr_block_grid(cfg)
    kit = jab.build_bkit(grid, cfg)
    state = jab.initialize_state_b(grid, cfg,
                                   grains=jab.generate_grains_b(grid, cfg),
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


def test_block_run_f64_matches_jax(tmp_path, capsys):
    ov = [*RUN, "precision=f64"]
    jgrid, jfinal, ref = _run_jax(tmp_path / "jax", ov)
    jax_out = capsys.readouterr().out
    solver, ours = _run_port(tmp_path / "port", ov)
    port_out = capsys.readouterr().out
    _compare(ours, ref, 1e-6)
    assert solver.flow_solve_count == 4 and solver.total_dissolved == 128 - int(
        (np.asarray(jfinal.node_type) == 1).sum())
    # the same grid line and flow solves, and no Poiseuille check under AMR
    for key in ("AMR(blocks)", "Flow:"):
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
    tgrid = tab.build_amr_block_grid(_port_cfg(ov))
    JWriter().write_vtu(str(tmp_path / "j.vtu"), jgrid, jfinal, None)
    TWriter().write_vtu(str(tmp_path / "t.vtu"), tgrid, state_from_numpy(
        host, dtype=torch.float64, device="cpu"))
    assert (tmp_path / "j.vtu").read_bytes() == (tmp_path / "t.vtu").read_bytes()


def _port_cfg(overrides):
    cfg = TConfig()
    cfg.apply_overrides(list(overrides))
    return cfg.compute_derived()


def test_block_run_f32_matches_jax(tmp_path):
    ov = [*RUN, "precision=f32"]
    _, _, ref = _run_jax(tmp_path / "jax", ov)
    solver, ours = _run_port(tmp_path / "port", ov)
    _compare(ours, ref, 1e-4)
    assert all(t.dtype in (torch.float32, torch.uint8, torch.int32,
                           torch.bool) for t in solver.final_state.tensors())


def test_block_resume_gives_the_uninterrupted_rows(tmp_path):
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


def test_block_warm_start_equals_jax(capsys):
    """flow_warm_start on a block grid: the coarse solve is the uniform
    grid's at 2 dx, sampled at the flat grid's positions."""
    ov = [*COUPLED, "flow_warm_start=2", "precision=f64"]
    jc = JConfig()
    jc.apply_overrides(ov)
    jc.compute_derived()
    jg = jab.build_amr_block_grid(jc)
    jk = jab.build_bkit(jg, jc)
    init = jab.initialize_state_b(jg, jc, dtype=jnp.float64)
    host = {f.name: np.asarray(getattr(init, f.name))
            for f in dataclasses.fields(init)}
    capsys.readouterr()
    js, j_iters = j_warm(init, jg, jk, jc)
    j_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if "Warm start" in ln]

    tc = _port_cfg(ov)
    tg = tab.build_amr_block_grid(tc)
    tk = tab.build_bkit(tg, tc, device="cpu")
    capsys.readouterr()
    ts, t_iters = t_warm(state_from_numpy(host, dtype=torch.float64,
                                          device="cpu"), tg, tk, tc)
    t_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if "Warm start" in ln]
    assert t_iters == j_iters > 0 and t_lines == j_lines and len(j_lines) == 1
    for f in ("rho", "vel", "pressure"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-10,
                                   atol=1e-10 * np.abs(a).max(), err_msg=f)


def test_cli_refuses_the_gather_backend(tmp_path, capsys):
    args = [os.devnull, *COUPLED, "amr_backend=gather",
            f"output_dir={tmp_path}"]
    with pytest.raises(NotImplementedError,
                       match="port order: 'gather AMR backend'"):
        cli.run(args + ["--device", "cpu"])
    assert cli.main(args + ["--device=cpu"]) == 1
    assert "gather AMR backend" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "diagnostics.csv")
