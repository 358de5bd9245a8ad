"""The PyTorch port (its multi-GPU ``parallel`` package included), and its
scripts in scripts/ (the calibration scripts, the warm-start measurement,
the profiler-window probe, the conditional-node and step-route costs,
gmres_qr's per-mode times),
must import without JAX and without the JAX package (the machine with the
card has no JAX), and must build nothing on import."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = [os.path.join(ROOT, "scripts", name) for name in (
    "calibration_torch.py", "calibrate_3d_torch.py", "calibrate_2d_torch.py",
    "measure_warm_start_torch.py", "profiler_windows_torch.py",
    "cond_graph_costs_torch.py", "step_route_costs_torch.py",
    "gmres_qr_modes_torch.py")]

_PROBE = """
import importlib, pkgutil, sys
import pd_mg_pin_corrosion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
# the port's scripts in scripts/, loaded by path as chip_smoke.py loads them
import importlib.util, os
for script in SCRIPTS:
    spec = importlib.util.spec_from_file_location(
        os.path.basename(script)[:-3], script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import pd_mg_pin_corrosion_tpu_torch.kernels.build as build
assert build._LIBRARY is None, "a kernel library was loaded at import"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "pd_mg_pin_corrosion_tpu"
             or m.startswith("pd_mg_pin_corrosion_tpu."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    probe = f"SCRIPTS = {SCRIPTS!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module of the port was imported (35 since the mesh:
    # parallel and its sharding, shard_kernels, launch and checks)
    assert int(out.stdout.strip().splitlines()[-1]) >= 35
