"""The port's calibration scripts (scripts/calibrate_3d_torch.py,
scripts/calibrate_2d_torch.py) against the JAX package's
(scripts/calibrate_3d.py, scripts/calibrate_2d.py), both loaded by path.

* ``run_one`` of each pair on the same inputs and seed, on the CPU in
  float32, rows of diagnostics.csv compared: solid_nodes exact, the rest
  within 1e-4 relative. 3D: params_3d.cfg cut to
  tests/test_torch_3d_slice.py's 8,303-node grid (its ``SMALL``
  overrides), D_grain 3e-14 / D_gb 3e-12 and T_final 22 s: six adaptive
  steps of 3-4.4 s, the first dissolution at 20.8 s, a flow re-solve and
  one more step (7 rows, 2 cycles); the JAX side's NS step through its
  Pallas kernel in the Pallas interpreter, as in that file. 2D:
  params_implicit_test.cfg (7,973 nodes) with the flow capped at 300
  iterations (50 a re-solve), D_grain 1e-14 / D_gb 1e-12 and T_final
  30 s: ten steps, the first dissolution at 28.3 s, a re-solve and one
  more step (11 rows, 2 cycles). Both packages' ``Config.load`` take the
  same caps, so both scripts' own overrides stay as they are.
* Both scripts' REPORT.md from the same banked diagnostics.csv, character
  for character, and the banked REPORT rows.
* The torch scripts refuse to write under docs/runs/, and refuse a
  switch they do not know.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_3d_slice import SMALL

from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.config import Config as JConfig
from pd_mg_pin_corrosion_tpu_torch.config import Config as TConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = os.path.join(ROOT, "docs", "runs")
CAPS_2D = ["flow_max_iters=300", "flow_max_iters_resolve=50", "T_final=30"]


def load(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def capped(monkeypatch):
    """Config.load of both packages with the given overrides applied."""
    def apply(overrides):
        for cls in (JConfig, TConfig):
            real = cls.load.__func__
            monkeypatch.setattr(cls, "load", classmethod(
                lambda c, fn, real=real: real(c, fn).apply_overrides(
                    overrides)))
    return apply


def rows_of(out):
    return np.atleast_2d(np.loadtxt(f"{out}/diagnostics.csv", delimiter=",",
                                    skiprows=1))


def assert_rows_match(ours, ref):
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])     # solid_nodes
    for col, name in ((0, "time_s"), (2, "pin_mass_loss_pct"), (4, "v_max"),
                      (5, "C_max_fluid")):
        np.testing.assert_allclose(ours[:, col], ref[:, col], rtol=1e-4,
                                   err_msg=name)


def jax_run_one_pallas(jax_drv, point, out, monkeypatch):
    """The JAX script's run_one with its f32 3D NS step on the Pallas
    kernel, interpreted (tests/test_torch_3d_slice.py's
    run_jax_pallas_ns); jit caches cleared on both sides."""
    jax.clear_caches()
    try:
        with monkeypatch.context() as m:
            m.setattr(pk, "INTERPRET", True)
            m.setattr(pk, "pallas_applicable_3d", lambda kit: (
                kit.dim == 3 and kit.jdtype == jnp.float32))
            return jax_drv.run_one(*point, str(out))
    finally:
        jax.clear_caches()


def test_run_one_3d_matches_jax(tmp_path, monkeypatch, capped):
    jax_drv, torch_drv = load("calibrate_3d"), load("calibrate_3d_torch")
    capped([*SMALL, "T_final=22"])
    monkeypatch.setattr(jax_drv, "T_FINAL", 22.0)
    monkeypatch.chdir(ROOT)         # the JAX script's config path
    point = ("pt", 8e-6, 3e-14, 3e-12, 0)
    ref = jax_run_one_pallas(jax_drv, point, tmp_path / "jax", monkeypatch)
    ours, solver = torch_drv.run_one(*point, str(tmp_path / "torch"),
                                     t_final=22.0, device="cpu")
    assert solver.cycles == 2 and solver.flow_solve_count == 2
    assert len(ours) == 7 and ours[-1, 3] < ours[0, 3]
    np.testing.assert_array_equal(ours, rows_of(tmp_path / "torch"))
    assert_rows_match(ours, ref)


def test_run_one_2d_matches_jax(tmp_path, monkeypatch, capped):
    jax_drv, torch_drv = load("calibrate_2d"), load("calibrate_2d_torch")
    capped(CAPS_2D)
    monkeypatch.chdir(ROOT)
    point = ("pt", 1e-14, 1e-12, None)
    ref = jax_drv.run_one(*point, str(tmp_path / "jax"))
    ours, solver = torch_drv.run_one(*point, str(tmp_path / "torch"),
                                     device="cpu")
    assert solver.cycles == 2 and solver.flow_solve_count == 2
    assert len(ours) == 11 and ours[-1, 3] < ours[0, 3]
    assert_rows_match(ours, ref)


@pytest.mark.parametrize("dim, label, row", [
    ("3d", "twoanchor-c", "| twoanchor-c | 2.1609e-17 | 2.1609e-15 | 0 | "
     "22.91 % | 50.15 % | 32427 s |"),
    ("2d", "twoanchor-a", "| twoanchor-a | 5.826e-17 | 5.826e-15 | "
     "None/None | 23.39 % | 50.02 % | 32414 s |")])
def test_report_rows_equal_jax(dim, label, row, tmp_path, monkeypatch):
    """Both scripts' main, their run_one replaced by the banked run's
    rows: the same REPORT.md, and the row the bank's REPORT.md holds."""
    bank = os.path.join(BANKS, f"calib_{dim}", label, "diagnostics.csv")
    rows = np.atleast_2d(np.loadtxt(bank, delimiter=",", skiprows=1))
    jax_drv = load(f"calibrate_{dim}")
    torch_drv = load(f"calibrate_{dim}_torch")
    monkeypatch.setattr(jax_drv, "run_one", lambda *a, **k: rows)
    monkeypatch.setattr(torch_drv, "run_one", lambda *a, **k: (rows, None))
    point = {"3d": f"{label}=2.1609e-17:2.1609e-15:0:40e-6:1.2790",
             "2d": f"{label}=5.826e-17:5.826e-15"}[dim]
    argv = (["8e-6", "--tfinal=32400", point] if dim == "3d" else [point])
    monkeypatch.chdir(tmp_path)     # the JAX script writes docs/runs/...
    monkeypatch.setattr(sys, "argv", ["calibrate", *argv])
    jax_drv.main()
    assert torch_drv.main([*argv, "--out", str(tmp_path / "torch")]) == 0
    with open(tmp_path / "docs" / "runs" / f"calib_{dim}" / "REPORT.md") as f:
        theirs = f.read()
    with open(tmp_path / "torch" / "REPORT.md") as f:
        ours = f.read()
    assert ours == theirs
    assert row in ours.splitlines()
    # the bank's own row: the same losses and end time (its 2D decay_l
    # cell predates the script's decay/accel form)
    with open(os.path.join(BANKS, f"calib_{dim}", "REPORT.md")) as f:
        banked = [ln for ln in f.read().splitlines()
                  if ln.startswith(f"| {label} |")]
    assert [ln.split("|")[5:8] for ln in banked] == [row.split("|")[5:8]]


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_scripts_never_write_under_docs_runs(dim, tmp_path, monkeypatch):
    drv = load(f"calibrate_{dim}_torch")
    monkeypatch.setattr(drv, "run_one", lambda *a, **k: pytest.fail(
        "ran a ladder point"))
    point = (["8e-6"] if dim == "3d" else []) + ["a=1e-16:1e-14"]
    for out in (os.path.join(BANKS, f"calib_{dim}"), BANKS,
                os.path.join(BANKS, "..", "runs", "x")):
        with pytest.raises(SystemExit, match="docs/runs"):
            drv.main([*point, "--out", out, "--device", "cpu"])
        with pytest.raises(SystemExit, match="docs/runs"):
            drv.main([f"--out={os.path.relpath(out)}", *point])
    assert drv.DEFAULT_OUT == os.path.join("output", f"calib_{dim}_torch")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(drv, "run_one", lambda *a, **k: (
        np.array([[30.0, 30 / 3600, 0.5, 10, 0.1, 0.0]]), None))
    assert drv.main([*point, "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / drv.DEFAULT_OUT / "REPORT.md")


@pytest.mark.parametrize("dim, switch", [
    ("3d", "--grain_draw=banked"), ("3d", "--tfinal"), ("2d", "--tfinal=9")])
def test_scripts_refuse_unknown_switches(dim, switch, tmp_path, monkeypatch):
    """A misspelt switch stops the script before a ladder point runs (3D
    takes --tfinal=S; 2D runs to the config's T_final)."""
    drv = load(f"calibrate_{dim}_torch")
    monkeypatch.setattr(drv, "run_one", lambda *a, **k: pytest.fail(
        "ran a ladder point"))
    point = (["8e-6"] if dim == "3d" else []) + ["a=1e-16:1e-14"]
    with pytest.raises(SystemExit, match="unknown switch"):
        drv.main([*point, switch, "--out", str(tmp_path / "out"),
                  "--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_script_runs_from_anywhere_and_refuses_a_missing_card(dim, tmp_path):
    """``python scripts/calibrate_<dim>_torch.py``, from another directory
    and with no PYTHONPATH, finds the port; without a card it stops with
    the CLI's error (no fallback to the CPU) before writing a row."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import subprocess

    script = os.path.join(ROOT, "scripts", f"calibrate_{dim}_torch.py")
    point = (["8e-6"] if dim == "3d" else []) + ["a=1e-16:1e-14"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PD_TORCH_DEVICE")}
    out = subprocess.run([sys.executable, script, *point, "--out",
                          str(tmp_path / "out")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "no CUDA device available" in out.stderr
    assert not os.path.exists(tmp_path / "out" / "a" / "diagnostics.csv")



def test_banked_grain_draw_is_installed_for_the_run_only():
    """--grain-draw=banked installs replay_banked_amr's two-division draw
    while the grains are generated, and nothing else is accepted."""
    from pd_mg_pin_corrosion_tpu_torch import grains

    calib = load("calibrate_3d_torch").calib
    import replay_banked_amr

    current = grains._MT19937Stream.uniform_int
    assert calib.parse_switches(["--grain-draw=banked"], "out")[4] == "banked"
    with calib.grain_draw("banked"):
        assert (grains._MT19937Stream.uniform_int
                is replay_banked_amr.two_division_uniform_int)
    assert grains._MT19937Stream.uniform_int is current
    with calib.grain_draw("current"):
        assert grains._MT19937Stream.uniform_int is current
    with pytest.raises(SystemExit, match="grain-draw"):
        calib.parse_switches(["--grain-draw=old"], "out")
