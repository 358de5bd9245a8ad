"""The coupled run under a mesh: ``CoupledSolver.run`` on the port's
sharded state and kit (two ranks, gloo, on the CPU) against one rank and
against the JAX package's CSV, and its checkpoint resumed at one and at
four ranks.

JAX tests/test_sharding.py's test_sharded_coupled_run_matches_single_device
configuration (2D small_cfg with R_tube 80 um, f64, implicit transport,
a diagnostics row a step), padded to a multiple of 4 rows (52). The short
form stops after two cycles (T_final 1 s: two flow solves, one
dissolution event); the resumed runs and the one-rank run go on to the
third (T_final 1.5 s). Gates as the JAX test's: solid_nodes exact, the
other columns within 1e-9 relative (f64 sums in another order)."""

import os
import shutil

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu.grid import pad_grid_axial as j_pad
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import grains as t_grains
from pd_mg_pin_corrosion_tpu_torch import initialize_state as t_initialize_state
from pd_mg_pin_corrosion_tpu_torch.checkpoint import load_checkpoint
from pd_mg_pin_corrosion_tpu_torch.coupling import CoupledSolver as TSolver
from pd_mg_pin_corrosion_tpu_torch.grid import pad_grid_axial as t_pad
from pd_mg_pin_corrosion_tpu_torch.parallel import checks
from pd_mg_pin_corrosion_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

COLS = ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid")


def run_cfg(C, T_final, out_dir, **extra):
    cfg = C()
    cfg.dx = 5.0e-6
    cfg.R_wire = 20.0e-6
    cfg.L_wire = 100.0e-6
    cfg.R_tube = 80.0e-6
    cfg.L_upstream = 60.0e-6
    cfg.L_downstream = 60.0e-6
    cfg.D_grain = 5.0e-11
    cfg.D_gb = 5.0e-9
    cfg.precision = "f64"
    cfg.c0 = 0.5
    cfg.cfl_factor = 0.25
    cfg.flow_conv_tol = 1.0e-4
    cfg.flow_max_iters = 4000
    cfg.gb_width_cells = 1
    cfg.T_final = T_final
    cfg.corrosion_steps_per_check = 20
    cfg.use_implicit = 1
    cfg.implicit_output_every = 10**9
    cfg.diagnostic_every = 1
    cfg.output_dir = str(out_dir)
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg.compute_derived()


def _same_rows(got, want, n=None):
    """solid_nodes exact, the other columns within 1e-9 (JAX's gates)."""
    got, want = got[:n], want[:n]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got["solid_nodes"], want["solid_nodes"])
    for col in COLS:
        np.testing.assert_allclose(got[col], want[col], rtol=1e-9,
                                   atol=1e-14, err_msg=col)


def _port_single(T_final, out_dir, **extra):
    cfg = run_cfg(TConfig, T_final, out_dir, **extra)
    grid = t_pad(t_build_grid(cfg), 4)
    kit = t_build_kit(grid, cfg, device="cpu")
    state = t_initialize_state(grid, cfg, grains=t_grains.generate(grid, cfg),
                               dtype=kit.dtype, device="cpu")
    solver = TSolver()
    final = solver.run(grid, state, kit, cfg)
    return solver, final, checks.rows(f"{out_dir}/diagnostics.csv")


def _port_mesh(n, T_final, out_dir, **extra):
    cfg = run_cfg(TConfig, T_final, out_dir, **extra)
    grid = t_pad(t_build_grid(cfg), 4)
    out = spawn(checks.coupled, n, "gloo", "cpu", grid, cfg,
                t_grains.generate(grid, cfg))
    return out, checks.rows(f"{out_dir}/diagnostics.csv")


def _jax_rows(T_final, out_dir):
    cfg = run_cfg(JConfig, T_final, out_dir)
    grid = j_pad(j_build_grid(cfg), 4)
    kit = j_build_kit(grid, cfg)
    state = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                               dtype=kit.jdtype)
    JSolver().run(grid, state, kit, cfg)
    return checks.rows(f"{out_dir}/diagnostics.csv")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's one-rank run to 1.5 s; the two-rank run
    to 1 s, with a checkpoint each cycle."""
    tmp = tmp_path_factory.mktemp("sharded_run")
    single = _port_single(1.5, tmp / "single")
    mesh, mesh_rows = _port_mesh(2, 1.0, tmp / "mesh2", checkpoint_every=1)
    return dict(tmp=tmp, jax=_jax_rows(1.5, tmp / "jax"), single=single,
                mesh=mesh, mesh_rows=mesh_rows)


def test_two_rank_run_matches_one_rank(runs):
    solver, final, rows = runs["single"]
    out = runs["mesh"][0]
    mesh_rows = runs["mesh_rows"]
    assert len(mesh_rows) == 2 and len(rows) == 3
    _same_rows(mesh_rows, rows, 2)
    # the short form ran the production machinery: two flow solves, a
    # dissolution event between them, every rank the same totals
    assert out["total_dissolved"] > 0 and out["flow_solve_count"] == 2
    for r in runs["mesh"]:
        assert (r["total_implicit_steps"], r["flow_solve_count"],
                r["total_dissolved"]) == (2, 2, out["total_dissolved"])
    assert [f[0] for f in out["flow_results"]] == [
        f[0] for f in solver.flow_results[:2]]


def test_two_rank_run_matches_the_jax_csv(runs):
    _same_rows(runs["mesh_rows"], runs["jax"], 2)
    _same_rows(runs["single"][2], runs["jax"])


def test_two_rank_run_writes_the_single_rank_files(runs):
    """Rank 0 writes the CSVs, the snapshots and the checkpoint from the
    gathered state: the checkpoint holds the whole padded grid and equals
    the run's final state."""
    d = runs["tmp"] / "mesh2"
    names = set(os.listdir(d))
    assert {"diagnostics.csv", "mass_loss.csv", "simulation.pvd",
            "flow.pvd", "checkpoint.npz"} <= names
    assert any(n.startswith("final_") and n.endswith(".vti") for n in names)
    final = runs["mesh"][0]["final"]
    with np.load(d / "checkpoint.npz") as z:
        assert float(z["t_corr"]) == pytest.approx(1.2)
        for k, v in final.items():
            np.testing.assert_array_equal(z[k], v, k)


def _resume(runs, name, n):
    d = runs["tmp"] / name
    shutil.copytree(runs["tmp"] / "mesh2", d)
    extra = dict(resume_from=str(d / "checkpoint.npz"))
    if n == 1:
        return _port_single(1.5, d, **extra)[2]
    return _port_mesh(n, 1.5, d, **extra)[1]


@pytest.mark.parametrize("n", [1, 4])
def test_two_rank_checkpoint_resumes_at_any_rank_count(runs, n):
    """The checkpoint written at two ranks resumes at one and at four: the
    two kept rows are the two-rank run's, the third the uninterrupted
    one-rank run's (and JAX's)."""
    rows = _resume(runs, f"resume{n}", n)
    assert len(rows) == 3
    np.testing.assert_array_equal(rows[:2], runs["mesh_rows"])
    _same_rows(rows, runs["single"][2])
    _same_rows(rows, runs["jax"])


def test_checkpoint_loads_as_a_one_rank_state(runs):
    """load_checkpoint with a one-rank template reads every field whole;
    with ``rows`` a rank's slab."""
    _, final, _ = runs["single"]
    path = runs["tmp"] / "mesh2" / "checkpoint.npz"
    whole, t, meta = load_checkpoint(str(path), final)
    assert meta["cycle"] == 2 and t == pytest.approx(1.2)
    part, _, _ = load_checkpoint(str(path), final, rows=slice(13, 26))
    for a, b in zip(whole.tensors(), part.tensors()):
        assert torch.equal(a[13:26], b)


@pytest.mark.slow
def test_whole_two_rank_run_matches_one_rank_and_jax(tmp_path):
    """JAX test_sharded_coupled_run_matches_single_device whole (T_final
    10 s: six cycles, 178 nodes dissolved)."""
    solver, final, rows = _port_single(10.0, tmp_path / "single")
    out, mesh_rows = _port_mesh(2, 10.0, tmp_path / "mesh")
    _same_rows(mesh_rows, rows)
    _same_rows(mesh_rows, _jax_rows(10.0, tmp_path / "jax"))
    m = out[0]
    assert (m["total_dissolved"], m["total_implicit_steps"],
            m["flow_solve_count"]) == (solver.total_dissolved,
                                       solver.total_implicit_steps,
                                       solver.flow_solve_count)
    np.testing.assert_array_equal(m["final"]["node_type"],
                                  final.node_type.numpy())
    np.testing.assert_allclose(m["final"]["C"], final.C.numpy(), rtol=1e-9,
                               atol=1e-14)
