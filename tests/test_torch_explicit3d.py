"""3D explicit transport in the port (``ops/ard.ard_step`` in 3D, plain
PyTorch: the JAX package has no Pallas kernel there either) against the
JAX package's XLA ``ard_step``, on the CPU.

Grid: the 8,303-node 3D grid of tests/test_pallas_interpret.py (S = 178),
with grains, a seeded C (FLUID nodes uniform in [0, 1), so some FLUID
neighbours of the wire reach C_sat and salt-block their solid neighbours)
and seeded FLUID velocities, handed to both packages. The CLIs run
config/params_3d.cfg cut to that grid (tests/test_torch_3d_slice.py's
SMALL) with use_implicit = 0.

Tolerances: float64 to round-off (rtol 1e-12 of each C, 1e-14 of max C),
float32 as tests/test_torch_explicit.py holds the 2D step (rtol 1e-5, atol
1e-7); the CLI runs with tests/test_torch_explicit.py's gates."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_3d_slice import (CFG_3D, SMALL, read_csv, run_jax,
                                 run_jax_pallas_ns)

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.ops import ard as j_ard
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import cli, kernels, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.ops import ard as t_ard

torch.set_num_threads(2)

GEOMETRY = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "corrosion_decay_l=0.5"]
VOL_LOSS = 0.1


def _states(precision, seed=0):
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides([*GEOMETRY, f"precision={precision}"])
    jg = j_build_grid(j)
    jk, tk = j_build_kit(jg, j), t_build_kit(t_build_grid(t), t, device="cpu")
    js = j_initialize_state(jg, j, grains=j_grains.generate(jg, j),
                            dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    fluid = host["node_type"] == 0
    host["vel"] = np.where(fluid[..., None],
                           host["vel"] + rng.normal(0, 0.05, fluid.shape + (3,)),
                           host["vel"])
    host["C"] = np.where(host["node_type"] == 1,
                         1.0 - 0.5 * rng.random(fluid.shape),
                         np.where(fluid, 0.92 * rng.random(fluid.shape), 0.0))
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy(host, dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_ard_step_3d_matches_xla(precision):
    jk, js, tk, ts = _states(precision, seed=1)
    salt = t_ard.compute_salt_blocked(ts, tk)
    np.testing.assert_array_equal(
        salt.numpy(), np.asarray(j_ard.compute_salt_blocked(js, jk)))
    assert 0 < int(salt.sum()) < int((ts.node_type == 1).sum())
    dt = 2e-6
    ref = jax.jit(lambda s: j_ard.ard_step(s, jk, dt, VOL_LOSS))(js)
    before = kernels.launch_counts()
    out = t_ard.ard_step(ts, tk, dt, VOL_LOSS)
    assert kernels.launch_counts() == before
    a, b = out.C.numpy().astype(np.float64), np.asarray(ref.C, np.float64)
    if precision == "f64":
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-14 * np.abs(b).max())
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert not torch.equal(out.C, ts.C)
    for f in ("rho", "vel", "node_type"):
        assert torch.equal(getattr(out, f), getattr(ts, f))


# 0.0025 s of physics at the 4.04e-5 s CFL dt of the capped flow: 62
# explicit steps in cycles of 25, a row every 10 steps
EXPLICIT_3D = ["use_implicit=0", "T_final=0.0025",
               "corrosion_steps_per_check=25", "output_every_corr=10"]


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_explicit_3d_slice_matches_jax(precision, tmp_path, capsys,
                                       monkeypatch):
    ov = [f"precision={precision}", *EXPLICIT_3D]
    if precision == "f32":
        ref = run_jax_pallas_ns(tmp_path / "jax", ov, monkeypatch)
    else:
        ref = run_jax(tmp_path / "jax", ov)
    jax_out = capsys.readouterr().out
    solver = cli.run([CFG_3D, *SMALL, f"output_dir={tmp_path / 'port'}",
                      *ov, "--device", "cpu"])
    port_out = capsys.readouterr().out
    ours = read_csv(tmp_path / "port")
    assert "Using EXPLICIT ARD solver" in port_out
    dts = [[ln for ln in out.splitlines() if "Corrosion dt" in ln]
           for out in (jax_out, port_out)]
    assert len(dts[1]) == solver.cycles >= 3
    assert solver.explicit_steps == 62 and solver.total_implicit_steps == 0
    assert len(ours) == len(ref) >= 6
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    if precision == "f64":
        assert dts[0] == dts[1]
        np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-12)
        for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
            np.testing.assert_allclose(ours[col], ref[col], rtol=1e-9,
                                       err_msg=col)
    else:
        for col in ("time_s", "v_max", "C_max_fluid"):
            np.testing.assert_allclose(ours[col], ref[col], rtol=1e-4,
                                       err_msg=col)
        # 4 units in the last place of the f32 sum over the n0 initially
        # solid nodes, as a loss in % (tests/test_torch_explicit.py)
        n0 = int(ours["solid_nodes"][0])
        atol = 4 * 100.0 * float(np.spacing(np.float32(n0))) / n0
        np.testing.assert_allclose(ours["pin_mass_loss_pct"],
                                   ref["pin_mass_loss_pct"], rtol=0.0,
                                   atol=atol)
