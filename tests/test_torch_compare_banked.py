"""The two scripts that hold a whole block-AMR run against the banked
docs/runs/amr: compare_banked.py (numpy only; the banked run against itself
passes, the amr_ratio 2 run against it fails on the final rows) and
replay_banked_amr.py (the CLI with the banked runs' grain draw)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "compare_banked.py")
AMR = os.path.join(ROOT, "docs", "runs", "amr", "diagnostics.csv")
AMR_R2 = os.path.join(ROOT, "docs", "runs", "amr_r2", "diagnostics.csv")


def _run(*args):
    return subprocess.run([sys.executable, SCRIPT, *args], capture_output=True,
                          text=True, timeout=120)


def test_a_run_against_itself_passes():
    out = _run(AMR, AMR)
    assert out.returncode == 0, out.stderr
    assert "final rel diff: pin_mass_loss_pct 0.000e+00, solid_nodes 0.000e+00" in out.stdout
    assert "max |diff| 0 " in out.stdout


def test_another_run_fails_on_its_final_rows():
    out = _run(AMR_R2, AMR, "--limit", "0.01")
    assert out.returncode == 1
    assert "final rows within 0.01: False" in out.stdout
    # the same curves pass a limit above their final differences
    assert _run(AMR_R2, AMR, "--limit", "0.2").returncode == 0


def test_the_banked_grain_draw_gives_the_banked_first_row(tmp_path):
    """replay_banked_amr.py (the two-division draw the banked AMR runs were
    made with) gives docs/runs/amr's first mass loss to the last printed
    digit; the CLI's draw (bit-exact with libstdc++) gives another. The
    first 30 s step's loss is set by the solid's diffusivity map, not by
    the flow, so a 20-iteration flow solve is enough."""
    import numpy as np

    banked = np.genfromtxt(AMR, delimiter=",", names=True)[0]
    cfg = os.path.join(ROOT, "config", "params_amr.cfg")
    first = {}
    for name, script in (("banked_draw", os.path.join(ROOT,
                                                      "replay_banked_amr.py")),
                         ("cli", "-m")):
        out = tmp_path / name
        cmd = ([sys.executable, script] if script != "-m" else
               [sys.executable, "-m", "pd_mg_pin_corrosion_tpu_torch"])
        run = subprocess.run(
            cmd + [cfg, "flow_max_iters=20", "T_final=30", "precision=f32",
                   f"output_dir={out}", "--device", "cpu"],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
        assert run.returncode == 0, run.stderr
        first[name] = np.genfromtxt(out / "diagnostics.csv", delimiter=",",
                                    names=True)
    assert float(first["banked_draw"]["time_s"]) == banked["time_s"] == 30.0
    assert (f"{float(first['banked_draw']['pin_mass_loss_pct']):.6e}"
            == f"{banked['pin_mass_loss_pct']:.6e}")
    assert abs(float(first["cli"]["pin_mass_loss_pct"])
               / banked["pin_mass_loss_pct"] - 1.0) > 0.2
