"""End-to-end gate 2 of the port: the flagship's geometry at a coarser dx,
the port against the JAX package on the CPU, in float64.

config/params_3d.cfg with only ``dx`` changed, to 16e-6 (26 x 26 x 45 =
30,420 nodes, 500 SOLID_MG): the cheapest grid that keeps the flagship's
wire, tube and horizon (m_ratio 3) and is a valid grid (R_tube - R_wire =
110e-6 > delta + dx = 64e-6, build_grid's wall-mirror check). Both
packages build the same grid and grain boundaries; both CLIs' runs (the
port's ``cli.run``, the JAX package's ``cli.main`` with its host loop,
whose CSVs equal its fused machine's, tests/test_coupling_fused.py) give
the same rows to tests/test_parity.py's gates (solid_nodes exact, time_s
1e-9, the rest 1e-6 relative); a checkpoint written by each package in
the middle of the run (at the cycle end nearest T_final / 2, one after a
phase change where there is one) resumes in the other, and the two
resumed runs give the same rows (check_gate says how they relate to the
uninterrupted run's).

The short form caps the flow and raises the solid diffusivities, so that
each of its four cycles ends with a phase change (SHORT). The long form
(``slow``) runs the configuration as shipped to its T_final of 32,400 s:
no node dissolves at this dx by then."""

import itertools
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import checkpoint as j_ckpt
from pd_mg_pin_corrosion_tpu import cli as j_cli
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import cli as t_cli
from pd_mg_pin_corrosion_tpu_torch import coupling as t_coupling
from pd_mg_pin_corrosion_tpu_torch import grains as t_grains

torch.set_num_threads(2)

CFG_3D = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config", "params_3d.cfg")
COARSE = ["dx=16e-6", "precision=f64"]
# the JAX package's host loop (the configuration's fused machine gives the
# same CSVs and is not ported)
JAX_LOOP = ["implicit_fused_chunk=0", "coupled_fused_cycles=0"]
# a checkpoint at the end of every cycle (the middle one is chosen among
# them, ``middle``)
EVERY_CYCLE = ["checkpoint_every=1"]
# the short form: the flow capped, solid diffusivities 1,000 x the
# configuration's (every solid node is a grain-boundary node at this dx)
# and a cycle ended by each dissolution: four cycles (9, 1, 1 and 1
# implicit steps, to t = 105.33 s), each ended by a phase change, the
# middle checkpoint at the end of the second (t = 99.33 s)
SHORT = ["flow_max_iters=20", "flow_max_iters_resolve=10",
         "D_grain=2.218e-14", "D_gb=2.218e-12", "dissolution_batch=1",
         "T_final=105"]
CSV_FILES = ("diagnostics.csv", "mass_loss.csv", "simulation.pvd", "flow.pvd")


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


def _keeping_each(module, name, out):
    """module.<name> (a save_checkpoint, called at the end of every cycle)
    that also keeps a copy of each file as out/cycle_<n>.npz."""
    real = getattr(module, name)

    def save(path, state, t_corr, meta, *a, **k):
        real(path, state, t_corr, meta, *a, **k)
        shutil.copy(path, f"{out}/cycle_{meta['cycle']}.npz")
    return save


def middle(out, t_mid):
    """(cycle, path, whether that cycle dissolved nodes) of the kept
    checkpoint of the run in ``out`` nearest t_mid, among those written
    after a cycle that dissolved nodes if there are any."""
    ends, dissolved = [], 0
    for n in itertools.count(1):
        path = f"{out}/cycle_{n}.npz"
        if not os.path.exists(path):
            break
        with np.load(path) as f:
            t, meta = float(f["t_corr"]), json.loads(str(f["meta"]))
        ends.append((meta["total_dissolved"] == dissolved, abs(t - t_mid),
                     n, path))
        dissolved = meta["total_dissolved"]
    assert ends, "no checkpoint kept"
    still, _, n, path = min(ends)
    return n, path, not still


def run_port(out, overrides, monkeypatch, keep=False):
    """The port's CLI on the CPU; with ``keep``, each cycle's checkpoint
    kept in ``out``. Returns (rows, seconds)."""
    t0 = time.time()
    with monkeypatch.context() as m:
        if keep:
            m.setattr(t_coupling, "save_checkpoint", _keeping_each(
                t_coupling, "save_checkpoint", out))
        t_cli.run([CFG_3D, *COARSE, *overrides, f"output_dir={out}",
                   "--device", "cpu"])
    return read_csv(out), time.time() - t0


def run_jax(out, overrides, monkeypatch, keep=False):
    """The JAX package's CLI (its host loop); as run_port."""
    t0 = time.time()
    with monkeypatch.context() as m:
        m.setenv("PD_TPU_CACHE", "")    # no compilation cache outside
        if keep:
            m.setattr(j_ckpt, "save_checkpoint", _keeping_each(
                j_ckpt, "save_checkpoint", out))
        assert j_cli.main([CFG_3D, *COARSE, *JAX_LOOP, *overrides,
                           f"output_dir={out}"]) == 0
    return read_csv(out), time.time() - t0


def resumed(runner, full_out, out, ckpt, overrides, monkeypatch):
    """``runner`` resumed from ``ckpt`` in a copy of a whole run's CSVs and
    collections (trimmed back to the checkpoint's time by the resume)."""
    os.makedirs(out)
    for name in CSV_FILES:
        shutil.copy(f"{full_out}/{name}", f"{out}/{name}")
    rows, _ = runner(out, [*overrides, f"resume_from={ckpt}"], monkeypatch)
    return rows


def jax_kept(rows, t_ck):
    """The rows of a whole run that the JAX package's resume at t_ck keeps
    and writes again: it compares each printed time with t_ck + 1e-6 s and
    so drops the row written at the checkpoint when its printed time (7
    digits) rounds up past that; the port keeps it (its _resume_csv)."""
    at_ck = np.isclose(rows["time_s"], t_ck, rtol=1e-6, atol=0.0)
    return rows[~(at_ck & (rows["time_s"] > t_ck + 1e-6))]


def check_gate(tmp_path, overrides, monkeypatch, t_mid):
    """Both packages' whole runs and the crossed resumes from their
    checkpoints at the cycle end nearest t_mid (``middle``).

    Every resume, in both packages, solves the flow before its first
    cycle; the uninterrupted run solves it there only after a phase
    change. So a resume after a cycle that dissolved nodes continues the
    uninterrupted run, and its rows must equal that run's; after a cycle
    that dissolved none, the resumed runs solve the converged flow once
    more, and must equal each other (the port's resume of the JAX
    package's file against the JAX package's resume of the port's), keep
    the uninterrupted run's rows up to the checkpoint and its times and
    solid counts after it. Returns (port rows, JAX rows, seconds of each,
    the middle checkpoint's cycle and time, and the largest relative
    difference of each column between the port's resumed and
    uninterrupted rows)."""
    jax_rows, j_s = run_jax(tmp_path / "jax", overrides, monkeypatch, True)
    port_rows, p_s = run_port(tmp_path / "port", overrides, monkeypatch, True)
    assert_rows_match(port_rows, jax_rows)
    # the same middle cycle in each package, at the same time
    cycle, p_mid, continues = middle(tmp_path / "port", t_mid)
    assert middle(tmp_path / "jax", t_mid)[::2] == (cycle, continues)
    j_mid = middle(tmp_path / "jax", t_mid)[1]
    with np.load(p_mid) as p, np.load(j_mid) as j:
        t_ck = float(p["t_corr"])
        assert float(j["t_corr"]) == pytest.approx(t_ck, rel=1e-9)
    assert 0 < t_ck < port_rows["time_s"][-1]
    # the JAX package resumes the port's file, the port the JAX package's
    jax_res = resumed(run_jax, tmp_path / "jax", tmp_path / "jax_from_port",
                      p_mid, overrides, monkeypatch)
    port_res = resumed(run_port, tmp_path / "port",
                       tmp_path / "port_from_jax", j_mid, overrides,
                       monkeypatch)
    assert_rows_match(jax_kept(port_res, t_ck), jax_res)
    if continues:
        assert_rows_match(port_res, port_rows)
        assert_rows_match(jax_res, jax_kept(jax_rows, t_ck))
    assert len(port_res) == len(port_rows)
    before = port_rows["time_s"] <= t_ck * (1 + 1e-6)
    np.testing.assert_array_equal(port_res[before], port_rows[before])
    np.testing.assert_array_equal(port_res["solid_nodes"],
                                  port_rows["solid_nodes"])
    np.testing.assert_allclose(port_res["time_s"], port_rows["time_s"],
                               rtol=1e-9)
    drift = {c: float(np.max(np.abs(port_res[c] / port_rows[c] - 1.0)))
             for c in ("pin_mass_loss_pct", "v_max", "C_max_fluid")}
    return port_rows, jax_rows, p_s, j_s, (cycle, t_ck), drift


def test_coarse_flagship_grid_and_grains_equal_jax():
    j, t = JConfig.load(CFG_3D), TConfig.load(CFG_3D)
    for c in (j, t):
        c.apply_overrides(COARSE)
    jg, tg = j_build_grid(j), t_build_grid(t)
    assert (tg.Nx, tg.Ny, tg.Nz, tg.N_total) == (26, 26, 45, 30_420)
    np.testing.assert_array_equal(tg.node_type, jg.node_type)
    np.testing.assert_array_equal(tg.pos, jg.pos)
    assert tg.type_counts() == jg.type_counts()
    assert tg.type_counts()["SOLID_MG"] == 500
    jgr, tgr = j_grains.generate(jg, j), t_grains.generate(tg, t)
    assert tgr.n_grains == jgr.n_grains == 61
    for f in ("is_grain_boundary", "is_precipitate"):
        np.testing.assert_array_equal(getattr(tgr, f), getattr(jgr, f))
    # every solid node is a grain-boundary node here, so D_map is the same;
    # the grain ids differ only at nodes equidistant from two seeds, where
    # the rounding of the squared distance decides (the port's explicit
    # fused multiply-adds, csrc/voronoi_fma.cpp, against the JAX package's
    # host build)
    assert tgr.is_grain_boundary[tg.node_type == 1].all()
    differ = np.flatnonzero(tgr.grain_id.ravel() != jgr.grain_id.ravel())
    assert differ.size <= 4
    solid = np.flatnonzero(tg.node_type.ravel() == 1)
    rng = t_grains._MT19937Stream(42)
    pos = tg.pos.reshape(-1, 3)
    seeds = np.array([pos[solid[rng.uniform_int(solid.size - 1)]]
                      for _ in range(tgr.n_grains)])
    for n in differ:
        d_port, d_jax = (((pos[n] - seeds[g.ravel()[n]]) ** 2).sum()
                         for g in (tgr.grain_id, jgr.grain_id))
        assert d_port == pytest.approx(d_jax, rel=1e-12)


def test_gate2_short(tmp_path, monkeypatch):
    port_rows, _, _, _, mid, _ = check_gate(
        tmp_path, [*SHORT, *EVERY_CYCLE], monkeypatch, t_mid=99)
    assert mid[0] == 2
    assert len(port_rows) == 12
    assert port_rows["time_s"][-1] == pytest.approx(105.33, abs=0.01)
    # a node dissolved in each cycle
    assert len(set(port_rows["solid_nodes"])) == 4


@pytest.mark.slow
def test_gate2_whole_run(tmp_path, monkeypatch):
    """params_3d.cfg as shipped but for dx, to T_final = 32,400 s."""
    torch.set_num_threads(6)
    port_rows, _, p_s, j_s, mid, drift = check_gate(
        tmp_path, EVERY_CYCLE, monkeypatch, t_mid=16_200)
    last = port_rows[-1]
    print(f"gate2 whole run: port {p_s:.1f} s, JAX {j_s:.1f} s; resumed "
          f"after cycle {mid[0]} at t={mid[1]:.6e} s, resumed rows against "
          f"the uninterrupted ones: max rel diff {json.dumps(drift)}; "
          f"{len(port_rows)} rows; last row t={last['time_s']:.6e} "
          f"loss={last['pin_mass_loss_pct']:.6e} % "
          f"solid={int(last['solid_nodes'])} v_max={last['v_max']:.6e} "
          f"C_max_fluid={last['C_max_fluid']:.6e}")
    assert last["time_s"] >= 32_400.0
