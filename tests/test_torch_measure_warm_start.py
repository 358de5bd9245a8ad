"""scripts/measure_warm_start_torch.py (the port's counterpart of
scripts/measure_warm_start.py) against the JAX script, both run live on
the CPU on the same configuration.

The configuration is tests/golden/parity.cfg (2D, 2,565 nodes, its own
flow_conv_tol of 1e-5), written to a temporary .cfg with its output
directory set. The JAX script runs as a script in a second process
(``python3 scripts/measure_warm_start.py <that .cfg>``, the JAX CPU
backend, no compile cache) while the port's ``main`` runs here, so the
test takes about as long as the slower of the two (~1 min). Both print
their JSON line; the port's must say "ok": true, as the JAX one must, with
the same cold, coarse and fine iteration counts (the solves test
convergence every 100 iterations, so the count is exact), and the
FLUID-node relative L2 between the warm and the cold field within 1e-4
relative of the JAX script's (both in f32; the two NS forms round
differently).

The 3D grids do not fit this budget: the 8,303-node grid of
tests/test_torch_3d_slice.py has no valid coarse twin at 2 dx (the tube
wall's horizon would reach the wire), and a cold 3D solve at the
configuration's tolerance takes the JAX package minutes on the CPU.
The 3D warm start is held against the JAX package's in
tests/test_torch_warm_start.py, and the script's 3D counts on the card
in chip_smoke.py's phase warm3d."""

import json
import os
import subprocess
import sys

from test_torch_calibrate import load
from test_torch_gs_parity import keep_the_heap  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(ROOT, "tests", "golden", "parity.cfg")


def test_measure_warm_start_matches_the_jax_script(tmp_path, capsys,
                                                   keep_the_heap):  # noqa: F811
    import torch

    torch.set_num_threads(2)
    with open(PARITY) as f:
        text = f.read().replace("__SET_BY_TEST__", str(tmp_path / "out"))
    cfg = tmp_path / "warm.cfg"
    cfg.write_text(text)

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PD_TPU_CACHE": ""}
    jax_run = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "measure_warm_start.py"),
         str(cfg)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        module = load("measure_warm_start_torch")
        assert module.main([str(cfg), "--device", "cpu"]) == 0
    finally:
        out, err = jax_run.communicate(timeout=600)
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_run.returncode == 0, err[-2000:]
    theirs = json.loads(out.strip().splitlines()[-1])

    assert ours["ok"] is True and theirs["ok"] is True
    for key in ("cold_iters", "warm_coarse_iters", "warm_fine_iters"):
        assert ours[key] == theirs[key] > 0, key
    assert abs(ours["field_rel_l2"] / theirs["field_rel_l2"] - 1) < 1e-4
