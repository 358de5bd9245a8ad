"""Block AMR (``amr_blocks``) in the port against the JAX package's, on the
CPU: the grid's arrays, the kit's tables, and the ops one by one.

Grids: tests/test_amr.py's ``make_amr_test_config`` (with the reference's
goldens of tests/test_amr_blocks.py), config/params_amr.cfg at full size,
tests/test_amr3d.py's 3D config, and config/params_3d.cfg cut to
chip_smoke.py's SMALL_3D geometry with block AMR. The grid half is numpy in
both packages, so its arrays must be equal; the ops are held to f64
round-off (rtol 1e-10; the 3D NS step's act-static form rounds differently
from the JAX package's XLA form, at 1e-12 of the largest value in the
port's 3D tests) and the reference's AMR transport goldens to their own
tolerances.
"""

import dataclasses
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_amr import exact, l2_weighted, make_amr_test_config
from test_amr3d import make_3d_amr_config

from pd_mg_pin_corrosion_tpu import amr_blocks as jab
from pd_mg_pin_corrosion_tpu import dispatch as j_dispatch
from pd_mg_pin_corrosion_tpu.config import Config as JConfig
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import amr_blocks as tab
from pd_mg_pin_corrosion_tpu_torch import dispatch, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.grid import FICTITIOUS, FLUID, OUTSIDE
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMR = os.path.join(ROOT, "config", "params_amr.cfg")
FLAGSHIP = os.path.join(ROOT, "config", "params_3d.cfg")
# chip_smoke.py's SMALL_3D geometry of params_3d.cfg
SMALL_3D = ["dx=8e-6", "R_wire=16e-6", "L_wire=64e-6", "R_tube=48e-6",
            "L_upstream=32e-6", "L_downstream=32e-6", "Q_flow=1.667e-10"]
# tests/test_amr_coupled.py's block config: a wire, walls, both BC bands
COUPLED = ["dx=5e-6", "use_amr=1", "amr_ratio=2", "amr_buffer=30e-6",
           "R_wire=20e-6", "L_wire=80e-6", "R_tube=100e-6",
           "L_upstream=80e-6", "L_downstream=80e-6", "c0=0.5",
           "cfl_factor=0.25", "flow_conv_tol=1e-4", "D_grain=5e-11",
           "D_gb=5e-9", "gb_width_cells=1"]


def _configs(case, precision="f64"):
    """(JAX Config, port Config) of a named case."""
    out = []
    for Config in (JConfig, TConfig):
        if case == "test_amr":
            cfg = make_amr_test_config(1.0e-9, 1.667e-9)
            cfg = Config(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})
        elif case == "test_amr3d":
            cfg = make_3d_amr_config()
            cfg = Config(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})
        elif case == "params_amr":
            cfg = Config.load(AMR)
        elif case == "params_3d_small":
            cfg = Config.load(FLAGSHIP)
            cfg.apply_overrides(SMALL_3D + ["use_amr=1", "amr_ratio=2",
                                            "amr_buffer=16e-6"])
        else:  # "coupled"
            cfg = Config()
            cfg.apply_overrides(COUPLED)
        cfg.precision = precision
        out.append(cfg.compute_derived())
    return out


GRID_CASES = ["test_amr", "params_amr", "test_amr3d", "params_3d_small"]


@pytest.fixture(scope="module")
def grids():
    cache = {}

    def get(case):
        if case not in cache:
            jc, tc = _configs(case)
            cache[case] = (jab.build_amr_block_grid(jc),
                           tab.build_amr_block_grid(tc))
        return cache[case]
    return get


@pytest.mark.parametrize("case", GRID_CASES)
def test_block_grid_arrays_equal_jax(grids, case):
    jg, tg = grids(case)
    for a in ("dim", "dx", "delta", "m", "n_fine", "N_total", "shape"):
        assert getattr(jg, a) == getattr(tg, a), a
    for a in ("pos", "node_type", "dx_local", "delta_local", "grid_level",
              "fict_idx", "fict_src", "fict_w"):
        ja, ta = getattr(jg, a), getattr(tg, a)
        assert ja.dtype == ta.dtype, a
        np.testing.assert_array_equal(ja, ta, err_msg=a)
    for block in ("fine_grid", "coarse_grid"):
        jb, tb = getattr(jg, block), getattr(tg, block)
        for a in ("dim", "Nx", "Ny", "Nz", "dx", "delta", "m", "origin",
                  "shape"):
            assert getattr(jb, a) == getattr(tb, a), (block, a)
        for a in ("node_type", "pos", "mirror_idx"):
            np.testing.assert_array_equal(getattr(jb, a), getattr(tb, a),
                                          err_msg=f"{block}.{a}")
        for a in ("offsets", "dist", "evec", "vol"):
            np.testing.assert_array_equal(getattr(jb.stencil, a),
                                          getattr(tb.stencil, a))
    assert jg.type_counts() == tg.type_counts()


def test_block_grid_goldens(grids):
    """tests/test_amr_blocks.py's reference goldens (test_amr.cpp)."""
    cfg = _configs("test_amr")[1]
    g = grids("test_amr")[1]
    nt, lvl = g.node_type, g.grid_level
    real = (nt != OUTSIDE) & (nt != FICTITIOUS)
    assert int((real & (lvl == 0)).sum()) == 1600
    assert int((real & (lvl == 1)).sum()) == 2749
    assert int((nt == FICTITIOUS).sum()) == 948
    assert int((nt == FLUID).sum()) == 3600
    v = 1.5 * cfg.U_in * (1.0 - np.minimum(g.pos[:, 0] ** 2 / cfg.R_tube**2,
                                           1.0))
    vi = (v[g.fict_src] * g.fict_w).sum(axis=1)
    ve = v[g.fict_idx]
    mask = ve > 1e-6
    err = float((np.abs(vi[mask] - ve[mask]) / ve[mask]).max())
    assert err == pytest.approx(4.249e-02, rel=1e-3)
    assert np.allclose(g.fict_w.sum(axis=1), 1.0)


def test_params_amr_block_shapes(grids):
    """The production configuration's blocks (the kernels' AMR shapes)."""
    g = grids("params_amr")[1]
    assert g.fine_grid.shape == (208, 80) and g.coarse_grid.shape == (194, 120)
    assert g.N_total == 39_920 and g.fict_src.shape == (2_904, 29)
    g3 = grids("params_3d_small")[1]
    assert g3.N_total == 7_655 and g3.fict_idx.size == 3_366
    assert (g3.fine_grid.shape, g3.coarse_grid.shape) == ((20, 16, 16),
                                                          (15, 13, 13))


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("case", ["coupled", "params_3d_small"])
def test_bkit_tables_equal_jax(case, precision):
    jc, tc = _configs(case, precision)
    jg, tg = jab.build_amr_block_grid(jc), tab.build_amr_block_grid(tc)
    jk, tk = jab.build_bkit(jg, jc), tab.build_bkit(tg, tc, device="cpu")
    assert str(tk.dtype).split(".")[-1] == jk.dtype and tk.n_fine == jk.n_fine
    for a in ("fict_idx", "fict_src", "fict_w", "initial_solid_mask"):
        ja, ta = np.asarray(getattr(jk, a)), getattr(tk, a).numpy()
        assert ja.shape == ta.shape, a
        np.testing.assert_array_equal(ja, ta, err_msg=a)
    assert tk.fict_w.dtype == tk.dtype
    for block in ("fine", "coarse"):
        jb, tb = getattr(jk, block), getattr(tk, block)
        for a in ("inlet_mask", "outlet_mask", "wall_mask", "near_inlet_mask",
                  "near_outlet_mask", "v_pois", "initial_solid_mask",
                  "mirror_none_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, a)),
                                          getattr(tb, a).numpy(),
                                          err_msg=f"{block}.{a}")
        for a in ("shape", "mext", "offsets", "dist", "vol", "inlet_rows",
                  "outlet_rows", "alpha", "V_H", "beta_lap"):
            assert getattr(jb, a) == getattr(tb, a), (block, a)
        # each block keeps its own cfg: the coarse one at dx_coarse with
        # alpha_art_diff scaled by dx / dx_coarse
        for a in ("dx", "delta", "alpha_art_diff", "use_amr"):
            assert getattr(jb.cfg, a) == getattr(tb.cfg, a), (block, a)
    assert tk.coarse.cfg.dx == tc.dx_coarse and tk.cfg.use_amr == 1


def _states(case, precision, seed=0):
    """(JAX BKit, JAX state, port BKit, port state, port grid): both from
    the same host arrays, with seeded velocities and concentrations."""
    jc, tc = _configs(case, precision)
    jg, tg = jab.build_amr_block_grid(jc), tab.build_amr_block_grid(tc)
    jk, tk = jab.build_bkit(jg, jc), tab.build_bkit(tg, tc, device="cpu")
    grains = jab.generate_grains_b(jg, jc)
    st = jab.initialize_state_b(jg, jc, grains=grains, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}
    rng = np.random.default_rng(seed)
    nt = host["node_type"]
    moving = (nt == FLUID) | (nt == FICTITIOUS)
    host["vel"] = np.where(moving[:, None], host["vel"] + rng.normal(
        0.0, 0.05 * jc.U_in, host["vel"].shape), host["vel"])
    host["C"] = np.where(nt == 1, 1.0 - 0.3 * rng.random(nt.shape),
                         np.where(moving, 0.2 * rng.random(nt.shape), 0.0))
    host["C"] = host["C"].astype(host["rho"].dtype)
    host["vel"] = host["vel"].astype(host["rho"].dtype)
    jst = type(st)(**{k: jnp.asarray(v) for k, v in host.items()})
    dtype = torch.float64 if precision == "f64" else torch.float32
    tst = state_from_numpy(host, dtype=dtype, device="cpu")
    return jk, jst, tk, tst, tg


def _assert_states_close(js, ts, rtol, fields=("rho", "vel", "pressure", "C")):
    for f in fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        scale = max(float(np.abs(a).max()), 1e-300)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=f)
    np.testing.assert_array_equal(np.asarray(js.node_type),
                                  ts.node_type.numpy())


@pytest.mark.parametrize("case", ["coupled", "params_3d_small"])
def test_flow_iteration_equals_jax(case):
    """BCs, ns_step, the wall BC and update_fictitious, op by op and over
    three iterations, in float64."""
    jk, js, tk, ts, _ = _states(case, "f64")
    jops, tops = j_dispatch.ops_for(jk), dispatch.ops_for(tk)
    dt_j, dt_t = jops.compute_dt_ns(js, jk), tops.compute_dt_ns(ts, tk)
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    for _ in range(3):
        for name in ("apply_inlet_bc", "apply_outlet_bc", "apply_wall_bc",
                     "apply_solid_surface_bc"):
            js = getattr(jops, name)(js, jk)
            ts = getattr(tops, name)(ts, tk)
            _assert_states_close(js, ts, 1e-10)
        js = jops.ns_step(js, jk, dt_j)
        ts = tops.ns_step(ts, tk, dt_t)
        _assert_states_close(js, ts, 1e-10)
        js = jops.update_fictitious(jops.apply_wall_bc(js, jk), jk)
        ts = tops.update_fictitious(tops.apply_wall_bc(ts, tk), tk)
        _assert_states_close(js, ts, 1e-10)
    # (the port multiplies by 1 / rho_f where eager JAX divides: ROADMAP
    # queue C, "Two differences of rounding")
    p_j = np.asarray(jops.tait_pressure(js.rho, jk))
    np.testing.assert_allclose(tops.tait_pressure(ts.rho, tk).numpy(), p_j,
                               rtol=1e-10, atol=1e-10 * np.abs(p_j).max())


def test_update_fictitious_is_the_idw_sum():
    """The refresh writes sum_k w_k a[src_k] on the fictitious rows and
    nothing else."""
    _, _, tk, ts, tg = _states("coupled", "f64")
    out = tab.update_fictitious(ts, tk)
    for f in ("C", "rho", "pressure"):
        a = getattr(ts, f).numpy()
        want = a.copy()
        want[tg.fict_idx] = (a[tg.fict_src] * tg.fict_w).sum(1)
        np.testing.assert_allclose(getattr(out, f).numpy(), want, rtol=0,
                                   atol=1e-14 * np.abs(a).max())
    v = ts.vel.numpy()
    want = v.copy()
    want[tg.fict_idx] = (v[tg.fict_src] * tg.fict_w[..., None]).sum(1)
    # (numpy and torch sum the K terms in other orders)
    np.testing.assert_allclose(out.vel.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(v).max())
    assert out.phase is ts.phase and out.node_type is ts.node_type


def test_per_block_joins_only_what_changed():
    """A coarse-only BC keeps every flat tensor it did not change."""
    _, _, tk, ts, _ = _states("coupled", "f64")
    out = tab.apply_wall_bc(ts, tk)
    changed = {f.name for f in dataclasses.fields(out)
               if getattr(out, f.name) is not getattr(ts, f.name)}
    assert changed and changed <= {"rho", "vel", "C"}
    fine = slice(0, tk.n_fine)
    for f in changed:
        torch.testing.assert_close(getattr(out, f)[fine], getattr(ts, f)[fine],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("precision,rtol", [("f64", 1e-10), ("f32", 2e-4)])
@pytest.mark.parametrize("case", ["coupled", "params_3d_small"])
def test_implicit_ops_equal_jax(case, precision, rtol):
    """assemble, matvec_M, compute_adaptive_dt and implicit_step with its
    IDW constraint rows (float32: GMRES to 1e-6 with f64 refinement lands
    on a different but equally converged answer, so 2e-4 of the largest C;
    the dt to round-off)."""
    jk, js, tk, ts, tg = _states(case, precision)
    vl = 0.05
    jop, top = jab.assemble(js, jk, vl), tab.assemble(ts, tk, vl)
    np.testing.assert_array_equal(np.asarray(jop.unknown), top.unknown.numpy())
    np.testing.assert_array_equal(np.asarray(jop.fict), top.fict.numpy())
    mv_rtol = 1e-12 if precision == "f64" else 1e-5
    x = ts.C
    np.testing.assert_allclose(
        tab.matvec_M(top, tk, x).numpy(),
        np.asarray(jab.matvec_M(jop, jk, js.C)), rtol=mv_rtol,
        atol=mv_rtol * float(np.abs(np.asarray(jab.matvec_M(jop, jk, js.C))).max()))
    dt_j = float(jab.compute_adaptive_dt(js, jop, jk))
    dt_t = float(tab.compute_adaptive_dt(ts, top, tk))
    assert dt_t == pytest.approx(dt_j, rel=1e-12 if precision == "f64" else 1e-5)
    js2, res_j = jab.implicit_step(js, jop, jk, dt_j)
    ts2, res_t = implicit_step(tab.linear_system, ts, top, tk, dt_j)
    tol = 1e-10 if precision == "f64" else 1e-6
    assert res_t <= tol and float(res_j) <= tol
    a, b = np.asarray(js2.C), ts2.C.numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=rtol * float(np.abs(a).max()))
    # the constraint rows hold after the solve, to the solve's residual
    b_norm = float(np.linalg.norm(np.where(tg.node_type == FICTITIOUS, 0.0,
                                           ts.C.numpy())))
    idw = (b[tg.fict_src] * tg.fict_w).sum(1)
    np.testing.assert_allclose(b[tg.fict_idx], idw, rtol=0,
                               atol=2 * res_t * b_norm + 4 * np.finfo(b.dtype).eps)


def _golden_run(v_axial, sigma, z0, t_end, dt_max):
    """The reference's AMR transport test through the port's block backend
    (tests/test_amr_blocks.py's, float64): Gaussian on FLUID and
    FICTITIOUS nodes, implicit steps then the IDW refresh."""
    j = make_amr_test_config(1.0e-9, 0.0)
    cfg = TConfig(**{f.name: getattr(j, f.name)
                     for f in dataclasses.fields(j)}).compute_derived()
    g = tab.build_amr_block_grid(cfg)
    kit = tab.build_bkit(g, cfg, device="cpu")
    from pd_mg_pin_corrosion_tpu_torch.fields import initialize_state
    state = initialize_state(g, cfg, dtype=torch.float64, device="cpu")
    nt = g.node_type
    mask = (nt == FLUID) | (nt == FICTITIOUS)
    movers = mask | (nt == 3) | (nt == 4)
    vel = np.zeros((g.N_total, 2))
    vel[:, 1] = np.where(movers, v_axial, 0.0)
    gauss = np.exp(-(g.pos[:, 0] ** 2 + (g.pos[:, 1] - z0) ** 2)
                   / (2.0 * sigma**2))
    state = replace(state, vel=torch.tensor(vel),
                    C=torch.tensor(np.where(mask, gauss, 0.0)))
    op = tab.assemble(state, kit)
    t = 0.0
    while t < t_end - 1e-12:
        dt = min(dt_max, t_end - t)
        state = tab.update_fictitious(
            implicit_step(tab.linear_system, state, op, kit, dt)[0], kit)
        t += dt
    fluid = nt == FLUID
    return g, fluid, state.C.numpy()


def test_block_diffusion_golden():
    """test_amr.cpp:427-526 through the port: L2_ana = 2.1234e-02, mass
    drift 0.175 % (tests/test_amr_blocks.py's gates)."""
    D, sigma, t_end = 1.0e-9, 30e-6, 0.5
    g, fluid, C = _golden_run(0.0, sigma, 0.0, t_end, 0.01)
    vol = g.dx_local**2
    C0 = np.exp(-(g.pos[:, 0] ** 2 + g.pos[:, 1] ** 2) / (2.0 * sigma**2))
    mass0 = float((C0 * vol)[fluid].sum())
    Cex = np.where(fluid, exact(g.pos, 0.0, 0.0, sigma, D, t_end), 0.0)
    assert l2_weighted(C, Cex, fluid, vol) == pytest.approx(2.1234e-02,
                                                           rel=2e-3)
    mass1 = float((C * vol)[fluid].sum())
    assert abs(mass1 - mass0) / mass0 * 100.0 == pytest.approx(0.175,
                                                             rel=0.05)


def test_block_advection_diffusion_golden():
    """The reference's AMR advection-diffusion goldens through the port:
    L2_ana = 4.4286e-01, C_peak = 0.8370."""
    D, v, sigma, z0, t_end = 1.0e-9, 0.05, 20e-6, -20e-6, 0.0005
    g, fluid, C = _golden_run(v, sigma, z0, t_end, 5e-5)
    vol = g.dx_local**2
    Cex = np.where(fluid, exact(g.pos, 0.0, z0, sigma, D, t_end, v), 0.0)
    assert l2_weighted(C, Cex, fluid, vol) == pytest.approx(4.4286e-01,
                                                           rel=2e-3)
    assert float(C[fluid].max()) == pytest.approx(0.8370, rel=2e-3)


@pytest.mark.parametrize("case", ["coupled", "params_3d_small"])
def test_explicit_ops_equal_jax(case):
    """ard_compute_dt, ard_step per block and apply_phase_change on the
    flat state, in float64."""
    jk, js, tk, ts, _ = _states(case, "f64")
    dt_j = float(jab.ard_compute_dt(js, jk))
    assert float(tab.ard_compute_dt(ts, tk)) == pytest.approx(dt_j, rel=1e-12)
    js = jab.ard_step(js, jk, dt_j, 0.05)
    ts = tab.ard_step(ts, tk, dt_j, 0.05)
    _assert_states_close(js, ts, 1e-10, fields=("C",))
    (js, nj), (ts, nt_) = (jab.apply_phase_change(js, jk),
                           tab.apply_phase_change(ts, tk))
    assert int(nj) == int(nt_)
    _assert_states_close(js, ts, 1e-10)
