"""PyTorch port vs the JAX package in 3D: implicit transport (assemble,
matvec operator, adaptive dt, implicit_step on the 3D f32 path with
Neumann-4 over bf16 weights and the f64 slot-sum refinement), the
boundary conditions, salt blocking and a short steady flow solve, on the
small 3D grid of tests/test_pallas_interpret.py and seeded inputs.

The JAX side runs its CPU (XLA) forms. Tolerances: float64 to 1e-12
relative where the arithmetic is the same; float32 assemble to 1e-6;
implicit_step as tests/test_pallas_interpret.py holds the JAX package's
own 3D kernel path (Neumann-4, bf16, double-single refinement) to its CPU
path: C to rtol 5e-6 atol 5e-8, both residuals below the f32 tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import boundary as j_bc
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import solvers as j_solvers
from pd_mg_pin_corrosion_tpu.ops import ard as j_ard
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import boundary as t_bc
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kit as t_kit_mod
from pd_mg_pin_corrosion_tpu_torch import solvers as t_solvers
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.ops import ard as t_ard
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

# tests/test_pallas_interpret.py's 3D geometry, with tests/test_3d.py's
# cfg3d() physics (flow rate, density diffusion, solid diffusivities)
SMALL_3D = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "Q_flow=1.667e-10", "eta_density=1.0", "D_grain=5e-11",
            "D_gb=5e-9"]


def _pair(precision, overrides=()):
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides([*SMALL_3D, f"precision={precision}", *overrides])
    jg, tg = j_build_grid(j), t_build_grid(t)
    return j_build_kit(jg, j), t_build_kit(tg, t, device="cpu"), jg, j


def _states(precision, seed=0):
    """Seeded transport state: the initial fields with a developed C, a
    perturbed velocity, a few GB / precipitate solid nodes and FLUID nodes
    at C >= C_sat next to the wire (salt blocking)."""
    jk, tk, jg, j = _pair(precision)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    h = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    solid = h["node_type"] == 1
    fluid = h["node_type"] == 0
    h["C"] = np.where(solid, 0.6 + 0.4 * rng.random(solid.shape),
                      0.05 * rng.random(solid.shape))
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95
    h["vel"] = np.where(fluid[..., None],
                        h["vel"] + rng.normal(0, 0.01, h["vel"].shape), h["vel"])
    h["rho"] = np.where(fluid, h["rho"] + rng.normal(0, 0.5, solid.shape),
                        h["rho"])
    h["is_gb"] = solid & (rng.random(solid.shape) < 0.3)
    h["is_precip"] = solid & ~h["is_gb"] & (rng.random(solid.shape) < 0.2)
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype) for k, v in h.items()})
    ts = state_from_numpy(h, dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


def _close(a, b, rtol, atol_rel=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_rel * np.abs(b).max())


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("f32", 1e-6)])
def test_assemble_3d_matches(precision, tol, monkeypatch):
    jk, js, tk, ts = _states(precision)
    jop = jax.jit(lambda s: j_ai.assemble(s, jk, 0.1))(js)
    top = t_ai.assemble(ts, tk, 0.1)
    np.testing.assert_array_equal(top.unknown.numpy(), np.asarray(jop.unknown))
    _close(top.W, jop.W, tol, tol)
    _close(top.diag, jop.diag, tol, tol)
    if precision == "f32":
        assert top.W16.dtype == torch.bfloat16
        assert torch.equal(top.W16, top.W.to(torch.bfloat16))
    else:
        assert top.W16 is None
    # the slot-chunked assemble equals the all-slots form bit for bit
    monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS", 11 * 8303)
    chunked = t_ai.assemble(ts, tk, 0.1)
    assert torch.equal(chunked.W, top.W) and torch.equal(chunked.diag, top.diag)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_adaptive_dt_and_implicit_step_3d_match(precision):
    jk, js, tk, ts = _states(precision, seed=1)
    jop = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    top = t_ai.assemble(ts, tk)
    jdt = jax.jit(lambda s: j_ai.compute_adaptive_dt(s, jop, jk))(js)
    tdt = t_ai.compute_adaptive_dt(ts, top, tk)
    _close(tdt, jdt, 1e-12 if precision == "f64" else 1e-6)

    for dt in (float(jdt), 60.0):   # the adaptive dt and the stiff cap
        js2, jres = j_ai.implicit_step(js, jop, jk, dt)
        ts2, tres = implicit_step(t_ai.linear_system, ts, top, tk, dt)
        if precision == "f64":
            _close(ts2.C, js2.C, 1e-9, 1e-12)
            assert tres < 1e-10 and float(jres) < 1e-10
        else:
            np.testing.assert_allclose(ts2.C.numpy(), np.asarray(js2.C),
                                       rtol=5e-6, atol=5e-8)
            assert tres < 1e-6 and float(jres) < 1e-6


def test_implicit_step_3d_f32_uses_bf16_preconditioner(monkeypatch):
    """The 3D f32 step streams the bf16 weights in exactly the Neumann-4
    sweeps (4 per preconditioner application) and the f32 weights
    elsewhere, and forms its refinement residual with the f64 slot sum."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    _, _, tk, ts = _states("f32", seed=2)
    op = t_ai.assemble(ts, tk)
    calls = {"f32": 0, "bf16": 0, "slots": 0}
    mv, sl = kernels.matvec3d_plain, kernels.slots3d_f64

    def counting_mv(x, W, *a):
        calls["bf16" if W.dtype == torch.bfloat16 else "f32"] += 1
        return mv(x, W, *a)

    def counting_slots(x, W, kit):
        calls["slots"] += 1
        return sl(x, W, kit)

    monkeypatch.setattr(t_ai, "matvec3d", counting_mv)
    monkeypatch.setattr(t_ai, "slots3d_f64", counting_slots)
    _, res = implicit_step(t_ai.linear_system, ts, op, tk, 60.0)
    assert res < 1e-6
    assert calls["bf16"] > 0 and calls["bf16"] % 4 == 0 and calls["slots"] >= 1
    # every preconditioner application is followed by one f32 operator
    # application (GMRES's A(M(v))), plus the residual checks
    assert calls["f32"] >= calls["bf16"] // 4


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_boundary_and_transport_helpers_3d_match(precision):
    jk, js, tk, ts = _states(precision, seed=3)
    tol = 1e-12 if precision == "f64" else 1e-6
    np.testing.assert_array_equal(
        t_ard.compute_salt_blocked(ts, tk).numpy(),
        np.asarray(jax.jit(lambda s: j_ard.compute_salt_blocked(s, jk))(js)))
    assert t_ard.compute_salt_blocked(ts, tk).any()
    for name in ("apply_inlet_bc", "apply_outlet_bc",
                 "apply_wall_concentration_bc",
                 "smooth_boundary_concentration", "apply_solid_surface_bc"):
        ref = jax.jit(lambda s: getattr(j_bc, name)(s, jk))(js)
        out = getattr(t_bc, name)(ts, tk)
        for a in ("rho", "vel", "C"):
            _close(getattr(out, a), getattr(ref, a), tol, tol)
    ref = jax.jit(lambda s: j_solvers._channel_flow_corrections(s, jk))(js)
    out = t_solvers._channel_flow_corrections(ts, tk)
    for a in ("rho", "vel"):
        _close(getattr(out, a), getattr(ref, a), tol, tol)


def test_boundary_sums_in_slot_chunks(monkeypatch):
    """Chunked neighbour sums only re-associate the per-node sums."""
    _, _, tk, ts = _states("f64", seed=4)
    names = ("apply_inlet_bc", "apply_outlet_bc", "apply_wall_concentration_bc",
             "smooth_boundary_concentration")
    whole = [getattr(t_bc, n)(ts, tk).C for n in names]
    monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS", 5 * 8303)
    assert len(tk.slot_chunks()) == 36
    for n, w in zip(names, whole):
        _close(getattr(t_bc, n)(ts, tk).C, w, 1e-13, 1e-15)


def test_solve_steady_3d_same_iterations_and_fields():
    """A short 3D flow solve on the same cadence: 120 iterations (checks at
    1-10 and 100), f64, against the JAX package's segmented loop."""
    jk, tk, jg, j = _pair("f64")
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)}, dtype=tk.dtype,
                          device="cpu")
    jst, jit_, jeps, jconv, jdiv = j_solvers.solve_steady(js, jk, max_iters=120)
    tst, tit, teps, tconv, tdiv = t_solvers.solve_steady(ts, tk, max_iters=120)
    assert (int(jit_), bool(jconv), bool(jdiv)) == (tit, tconv, tdiv) == (121, False, False)
    np.testing.assert_allclose(teps, float(jeps), rtol=1e-9)
    _close(tst.rho, jst.rho, 1e-9)
    _close(tst.vel, jst.vel, 1e-9, 1e-9)
    _close(tst.pressure, jst.pressure, 1e-9, 1e-9)
