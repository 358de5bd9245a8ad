"""The port's explicit transport (``ops/ard.ard_step`` with the ``ard2d``
kernel's plain twin, ``ops/ard.compute_dt``, the explicit branch of
``CoupledSolver.run``) against the JAX package, on the CPU.

Grid: the small 2D f32 grid of tests/test_pallas_interpret.py
(``_small_f32_2d``), with grains, a seeded C (FLUID nodes uniform in [0, 1),
so some FLUID neighbours of the wire reach C_sat and salt-block their solid
neighbours' bonds) and seeded FLUID velocities, handed to both packages.
Tolerances: float64 to round-off; float32 as tests/test_pallas_interpret.py
holds the Pallas kernel to the XLA form (rtol 1e-5, atol 1e-7)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.coupling import CoupledSolver as JSolver
from pd_mg_pin_corrosion_tpu.ops import ard as j_ard
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import cli, kernels, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.ops import ard as t_ard

torch.set_num_threads(2)

# tests/test_pallas_interpret.py's _small_f32_2d geometry; a volume-loss
# decay so the micro-diffusivity factor is not 1
GEOMETRY = ["dx=4e-6", "R_wire=20e-6", "L_wire=80e-6", "R_tube=60e-6",
            "L_upstream=60e-6", "L_downstream=60e-6", "corrosion_decay_l=0.5"]
VOL_LOSS = 0.1
PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


def _states(precision, seed=0):
    """JAX and port (kit, state) from one seeded state."""
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
                           host["vel"] + rng.normal(0, 0.05, fluid.shape + (2,)),
                           host["vel"])
    host["C"] = np.where(host["node_type"] == 1,
                         1.0 - 0.5 * rng.random(fluid.shape),
                         np.where(fluid, rng.random(fluid.shape), 0.0))
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy(host, dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


def _close(a, b, rtol, atol_rel=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * np.abs(b).max())


def test_ard_step_f64_matches_xla():
    jk, js, tk, ts = _states("f64", seed=1)
    salt = t_ard.compute_salt_blocked(ts, tk)
    np.testing.assert_array_equal(
        salt.numpy(), np.asarray(j_ard.compute_salt_blocked(js, jk)))
    # the salt-blocked and the open interface bonds are both taken
    assert 0 < int(salt.sum()) < int((ts.node_type == 1).sum())
    dt = 2e-6
    ref = jax.jit(lambda s: j_ard.ard_step(s, jk, dt, VOL_LOSS))(js)
    out = t_ard.ard_step(ts, tk, dt, VOL_LOSS)
    _close(out.C, ref.C, 1e-12, 1e-14)
    assert not torch.equal(out.C, ts.C)
    for f in ("rho", "vel", "node_type"):
        assert torch.equal(getattr(out, f), getattr(ts, f))


def test_ard_step_f32_matches_the_pallas_kernel():
    """ard_step in float32 (the ard2d twin on the CPU) against the JAX
    package's Pallas kernel (ard_step_pallas) run in interpret mode."""
    jk, js, tk, ts = _states("f32", seed=2)
    dt = 2e-6
    pk.INTERPRET = True
    try:
        ref = pk.ard_step_pallas(js, jk, dt, VOL_LOSS)
    finally:
        pk.INTERPRET = False
    before = kernels.ard2d.launches
    out = t_ard.ard_step(ts, tk, dt, VOL_LOSS)
    np.testing.assert_allclose(out.C.numpy(), np.asarray(ref.C), rtol=1e-5,
                               atol=1e-7)
    assert kernels.ard2d.launches == before   # CPU tensors: the plain twin
    # the JAX package's XLA form in float32, to the same tolerance
    xla = jax.jit(lambda s: j_ard.ard_step(s, jk, dt, VOL_LOSS))(js)
    np.testing.assert_allclose(out.C.numpy(), np.asarray(xla.C), rtol=1e-5,
                               atol=1e-7)


def test_ard2d_twin_is_the_wrapper_on_the_cpu():
    _, _, tk, ts = _states("f32", seed=3)
    vmag = torch.sqrt((ts.vel * ts.vel).sum(-1))
    Ds = torch.rand(tk.shape, generator=torch.Generator().manual_seed(3))
    salt = t_ard.compute_salt_blocked(ts, tk)
    args = (ts.C, ts.vel, vmag, ts.node_type, Ds * 1e-9, salt, 1e-6, tk)
    assert torch.equal(kernels.ard2d(*args), kernels.ard2d_plain(*args))
    # nodes that are neither FLUID nor SOLID_MG pass through
    other = (ts.node_type != 0) & (ts.node_type != 1)
    out = kernels.ard2d_plain(*args)
    assert torch.equal(out[other], ts.C[other]) and bool((out >= 0).all())


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_compute_dt_matches(precision):
    jk, js, tk, ts = _states(precision, seed=4)
    ref = float(j_ard.compute_dt(js, jk))
    out = t_ard.compute_dt(ts, tk)
    assert out.dtype == tk.dtype and out.dim() == 0
    if precision == "f64":
        assert float(out) == pytest.approx(ref, rel=1e-15)
    else:
        assert float(out) == ref


def test_3d_explicit_step_is_refused():
    cfg = TConfig()
    cfg.apply_overrides(["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
                         "R_tube=48e-6", "L_upstream=32e-6",
                         "L_downstream=32e-6", "precision=f32"])
    grid = t_build_grid(cfg)
    kit = t_build_kit(grid, cfg, device="cpu")
    from pd_mg_pin_corrosion_tpu_torch import initialize_state
    st = initialize_state(grid, cfg, device="cpu")
    # no longer refused: the 3D step is ops/ard.explicit_step in plain
    # PyTorch (tests/test_torch_explicit3d.py holds it against the JAX
    # package), and no kernel of the 2D step launches
    before = kernels.launch_counts()
    out = t_ard.ard_step(st, kit, 1e-6)
    assert kernels.launch_counts() == before
    assert out.C.shape == kit.shape and bool(torch.isfinite(out.C).all())
    assert torch.equal(out.C, t_ard.explicit_step(
        st.C, st.vel, torch.sqrt((st.vel * st.vel).sum(-1)), st.node_type,
        t_ard.solid_diffusivity(st.is_gb, st.is_precip, cfg,
                                t_ard.micro_d_factor(cfg, 0.0, kit.dtype,
                                                     "cpu")),
        t_ard.compute_salt_blocked(st, kit), 1e-6, kit))


# parity.cfg, explicit: flow capped at 300 iterations as in
# tests/test_torch_slice.py; T_final = 1e-4 s is 151 steps at the f64
# dt (6.641e-7 s), three cycles of corrosion_steps_per_check = 50 and one
# step cut by T_final, a row every 25 steps
EXPLICIT = ["use_implicit=0", "flow_max_iters=300", "T_final=1e-4",
            "output_every_corr=25"]


def _run_jax(out, overrides):
    cfg = JConfig.load(PARITY)
    cfg.apply_overrides([f"output_dir={out}", *overrides])
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    state = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                               dtype=kit.jdtype)
    JSolver().run(grid, state, kit, cfg)
    return np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_explicit_slice_matches_jax(precision, tmp_path, capsys):
    ov = [f"precision={precision}", *EXPLICIT]
    ref = _run_jax(tmp_path / "jax", ov)
    jax_out = capsys.readouterr().out
    before = kernels.ard2d.launches
    solver = cli.run([PARITY, f"output_dir={tmp_path / 'port'}", *ov,
                      "--device", "cpu"])
    port_out = capsys.readouterr().out
    ours = np.atleast_1d(np.genfromtxt(f"{tmp_path}/port/diagnostics.csv",
                                       delimiter=",", names=True))
    assert kernels.ard2d.launches == before
    assert "Using EXPLICIT ARD solver" in port_out
    dts = [[ln for ln in out.splitlines() if "Corrosion dt" in ln]
           for out in (jax_out, port_out)]
    assert len(dts[1]) == solver.cycles == 4
    assert solver.explicit_steps == 151 and solver.total_implicit_steps == 0
    assert len(ours) == len(ref) == 7
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    if precision == "f64":
        assert dts[0] == dts[1]
        np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-12)
        for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
            np.testing.assert_allclose(ours[col], ref[col], rtol=1e-9,
                                       err_msg=col)
    else:
        # the f32 flow steps (ns2d's form vs XLA's) round differently
        for col in ("time_s", "v_max", "C_max_fluid"):
            np.testing.assert_allclose(ours[col], ref[col], rtol=1e-4,
                                       err_msg=col)
        # the loss is 100 (1 - sum C / n0) over the 180 initially solid
        # nodes: at losses of 1e-3 % it keeps only the last bits of the f32
        # sum, which the two packages take in different orders; held to 4
        # units in the last place of that sum
        n0 = 180
        atol = 4 * 100.0 * float(np.spacing(np.float32(n0))) / n0
        np.testing.assert_allclose(ours["pin_mass_loss_pct"],
                                   ref["pin_mass_loss_pct"], rtol=0.0,
                                   atol=atol)
