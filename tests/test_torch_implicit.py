"""PyTorch port vs the JAX package: implicit transport (assemble, matvec
operator, GMRES, implicit_step, adaptive dt) and the steady flow solve, on
the same seeded inputs; plus tests/test_gmres.py's cases on the port's
gmres, with and without the basis-kernel path."""

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
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import solvers as j_solvers
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import initialize_state as t_initialize_state
from pd_mg_pin_corrosion_tpu_torch import solvers as t_solvers
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import gmres, implicit_step

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


def _pair(precision, overrides=()):
    j, t = JConfig.load(PARITY), TConfig.load(PARITY)
    for c in (j, t):
        c.apply_overrides([f"precision={precision}", *overrides])
    jg, tg = j_build_grid(j), t_build_grid(t)
    return j_build_kit(jg, j), t_build_kit(tg, t, device="cpu"), jg, j


def _states(precision, seed=0):
    """Seeded transport state: the initial fields with a developed C, a
    perturbed velocity and a few GB / precipitate solid nodes."""
    jk, tk, jg, j = _pair(precision)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    h = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    solid = h["node_type"] == 1
    fluid = h["node_type"] == 0
    h["C"] = np.where(solid, 0.6 + 0.4 * rng.random(solid.shape),
                      0.05 * rng.random(solid.shape))
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95  # C >= C_sat: salt blocking
    h["vel"] = np.where(fluid[..., None],
                        h["vel"] + rng.normal(0, 0.01, h["vel"].shape), h["vel"])
    h["is_gb"] = solid & (rng.random(solid.shape) < 0.3)
    h["is_precip"] = solid & ~h["is_gb"] & (rng.random(solid.shape) < 0.2)
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype) for k, v in h.items()})
    ts = state_from_numpy(h, dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


def _close(a, b, rtol, atol_rel=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_rel * np.abs(b).max())


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("f32", 1e-5)])
def test_assemble_matches(precision, tol):
    jk, js, tk, ts = _states(precision)
    jop = jax.jit(lambda s: j_ai.assemble(s, jk, 0.1))(js)
    top = t_ai.assemble(ts, tk, 0.1)
    np.testing.assert_array_equal(top.unknown.numpy(), np.asarray(jop.unknown))
    _close(top.W, jop.W, tol, tol)
    _close(top.diag, jop.diag, tol, tol)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_adaptive_dt_and_implicit_step_match(precision):
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
            _close(ts2.C, js2.C, 1e-10, 1e-12)
            assert tres < 1e-10 and float(jres) < 1e-10
        else:
            np.testing.assert_allclose(ts2.C.numpy(), np.asarray(js2.C),
                                       rtol=5e-6, atol=5e-8)
            assert tres < 1e-6 and float(jres) < 1e-6


def test_solve_steady_same_iterations_and_eps():
    """Convergence at the check cadence: at tol 1.2e-3 parity.cfg's flow
    converges at the 400th iteration (eps 1.45e-3 at 300, 1.06e-3 at 400)."""
    jk, tk, jg, j = _pair("f64", ["flow_conv_tol=1.2e-3"])
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    ts = t_initialize_state(t_build_grid(tk.cfg), tk.cfg, dtype=tk.dtype,
                            device="cpu")
    jst, jit_, jeps, jconv, jdiv = j_solvers.solve_steady(js, jk)
    tst, tit, teps, tconv, tdiv = t_solvers.solve_steady(ts, tk)
    assert (int(jit_), bool(jconv), bool(jdiv)) == (tit, tconv, tdiv) == (400, True, False)
    np.testing.assert_allclose(teps, float(jeps), rtol=1e-9)
    _close(tst.rho, jst.rho, 1e-9)
    _close(tst.vel, jst.vel, 1e-9, 1e-9)
    _close(tst.pressure, jst.pressure, 1e-9, 1e-9)


# ---------------------------------------------------------------------------
# tests/test_gmres.py's cases on the port's gmres
# ---------------------------------------------------------------------------

def _random_system(n, seed=0, cond=10.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.linspace(1.0, cond, n)) @ Q.T  # SPD, condition = cond
    x_true = rng.normal(size=n)
    return torch.tensor(A), x_true, torch.tensor(A @ x_true)


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_solves_dense_system(flat):
    A, x_true, b = _random_system(80)
    x, (res, k) = gmres(lambda v: A @ v, b, torch.zeros(80, dtype=torch.float64), tol=1e-10,
                        restart=40, maxiter=400, flat_kernels=flat)
    assert res < 1e-10
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_restart_cycles_and_precond(flat):
    A, x_true, b = _random_system(120, cond=500.0)
    d = torch.diagonal(A).clone()
    x_np, (res_np, k_np) = gmres(lambda v: A @ v, b, torch.zeros(120, dtype=torch.float64), tol=1e-9,
                                 restart=20, maxiter=400, flat_kernels=flat)
    x_pc, (res_pc, k_pc) = gmres(lambda v: A @ v, b, torch.zeros(120, dtype=torch.float64), tol=1e-9,
                                 restart=20, maxiter=400, M=lambda v: v / d,
                                 flat_kernels=flat)
    assert res_pc < 1e-9
    np.testing.assert_allclose(x_pc.numpy(), x_true, rtol=1e-4, atol=1e-6)
    assert k_np <= 20 and k_pc <= 20


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_respects_shape(flat):
    n = 16
    A2 = torch.eye(n * n, dtype=torch.float64) * 2.0
    x, (res, _) = gmres(lambda v: (A2 @ v.reshape(-1)).reshape(n, n),
                        torch.ones((n, n), dtype=torch.float64),
                        torch.zeros((n, n), dtype=torch.float64), tol=1e-12,
                        restart=10, maxiter=50, flat_kernels=flat)
    assert x.shape == (n, n)
    np.testing.assert_allclose(x.numpy(), 0.5, rtol=1e-10)


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_early_convergence(flat):
    A, x_true, b = _random_system(30)
    x, (res, k) = gmres(lambda v: A @ v, b, torch.tensor(x_true), tol=1e-8,
                        restart=10, maxiter=100, flat_kernels=flat)
    assert k == 0 and res < 1e-8


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_f32_matches_jax(flat):
    """f32 vectors with f64 scalars, as the JAX gmres under x64 (the
    flat_kernels case of test_pallas_interpret)."""
    from pd_mg_pin_corrosion_tpu.ops.gmres import gmres as j_gmres

    rng = np.random.default_rng(7)
    n = 96
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A_np = (Q @ np.diag(np.linspace(1.0, 40.0, n)) @ Q.T).astype(np.float32)
    x_true = rng.normal(size=n).astype(np.float32)
    b_np = (A_np @ x_true).reshape(12, 8)
    Aj = jnp.asarray(A_np)
    x_ref, (res_ref, _) = j_gmres(lambda v: (Aj @ v.ravel()).reshape(v.shape),
                                  jnp.asarray(b_np), jnp.zeros((12, 8), jnp.float32),
                                  tol=1e-5, restart=20, maxiter=200)
    At = torch.tensor(A_np)
    x, (res, _) = gmres(lambda v: (At @ v.reshape(-1)).reshape(v.shape),
                        torch.tensor(b_np), torch.zeros((12, 8)), tol=1e-5,
                        restart=20, maxiter=200, flat_kernels=flat)
    assert x.dtype == torch.float32 and res < 1e-5 and float(res_ref) < 1e-5
    np.testing.assert_allclose(x.numpy().ravel(), x_true, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_implicit_step_bits_do_not_depend_on_the_basis_pitch(precision,
                                                             monkeypatch):
    """GMRES keeps its Krylov basis in rows that start on 128-byte lines;
    the same step over a basis stored back to back gives the same bits."""
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres as gmres_mod

    _, _, tk, ts = _states(precision, seed=1)
    top = t_ai.assemble(ts, tk)
    n = ts.C.numel()
    assert n % 32 != 0
    pitched, res = implicit_step(t_ai.linear_system, ts, top, tk, 60.0)
    made = []

    def back_to_back(rows, m, dtype, device):
        made.append((rows, m))
        return torch.empty((rows, m), dtype=dtype, device=device)

    monkeypatch.setattr(gmres_mod, "pitched_basis", back_to_back)
    # the kit's runner keeps its basis: a fresh runner makes a new one
    gmres_mod._runners.pop(tk, None)
    flat, res_flat = implicit_step(t_ai.linear_system, ts, top, tk, 60.0)
    assert made and all(m == n for _, m in made)
    assert res == res_flat and torch.equal(pitched.C, flat.C)


def test_gmres_f32_stiff_dt_reaches_tol():
    """tests/test_gmres.py's stiff-dt regression on the port: the real 2D
    transport operator at dt = implicit_dt_max = 60 s in f32 must reach the
    1e-6 production tolerance (f64 scalars + f64 refinement)."""
    cfg = TConfig()
    cfg.dx = 5.0e-6
    cfg.R_wire = 20.0e-6
    cfg.L_wire = 100.0e-6
    cfg.R_tube = 60.0e-6
    cfg.L_upstream = 60.0e-6
    cfg.L_downstream = 60.0e-6
    cfg.D_grain = 5.0e-11
    cfg.D_gb = 5.0e-9
    cfg.precision = "f32"
    cfg.compute_derived()
    grid = t_build_grid(cfg)
    kit = t_build_kit(grid, cfg, device="cpu")
    assert kit.dtype == torch.float32
    state = t_initialize_state(grid, cfg, dtype=kit.dtype, device="cpu")
    op = t_ai.assemble(state, kit)
    s1, _ = implicit_step(t_ai.linear_system, state, op, kit, 10.0)
    s2, res = implicit_step(t_ai.linear_system, s1, op, kit, 60.0)
    assert torch.isfinite(s2.C).all()
    assert res <= 1e-6, f"stiff-dt f32 GMRES stalled at {res:.2e}"
