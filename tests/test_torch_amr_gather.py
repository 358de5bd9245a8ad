"""The gather AMR backend (``amr`` / ``unstructured``) in the port against
the JAX package's, on the CPU: the grids' arrays, the neighbour builders,
the kit's tables, every op, the grains, and the reference's AMR goldens.

Grids: tests/test_amr.py's configuration (the reference's goldens),
tests/test_native.py's, tests/test_gmres.py's f32 AMR one, and
config/params_amr.cfg at full size. The grid half is numpy in both
packages, so node sets, IDW tables, mirrors and neighbour indices must be
equal; distances, unit vectors and volumes come from the native cell-list
builder, which the two packages compile with other flags, so they are held
to a few ulp (``_assert_builder_floats_close``). Ops: float64 to rtol
1e-12, float32 to 1e-5 (the sums over K run in another order), both
relative to the largest value of a field.
"""

import dataclasses
import math
import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_amr import exact, l2_weighted, make_amr_test_config
from test_torch_amr_blocks import COUPLED

from pd_mg_pin_corrosion_tpu import amr as jamr
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import unstructured as ju
from pd_mg_pin_corrosion_tpu.config import Config as JConfig
from pd_mg_pin_corrosion_tpu.fields import initialize_state as j_init
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import amr as tamr
from pd_mg_pin_corrosion_tpu_torch import dispatch, native, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch import grains as t_grains
from pd_mg_pin_corrosion_tpu_torch import unstructured as tu
from pd_mg_pin_corrosion_tpu_torch.fields import initialize_state
from pd_mg_pin_corrosion_tpu_torch.grid import (FICTITIOUS, FLUID, OUTSIDE,
                                                WALL, build_grid)
from pd_mg_pin_corrosion_tpu_torch.kit import build_kit
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as tai
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMR = os.path.join(ROOT, "config", "params_amr.cfg")
# tests/test_native.py's configuration
NATIVE = ["dx=5e-6", "R_wire=0.0", "L_wire=0.0", "R_tube=100e-6",
          "L_upstream=100e-6", "L_downstream=100e-6", "use_amr=1",
          "amr_ratio=2", "amr_buffer=50e-6"]
# tests/test_gmres.py::test_gmres_f32_stiff_dt_amr_backend's
GMRES = ["dx=4e-6", "m_ratio=3", "R_wire=16e-6", "L_wire=80e-6",
         "R_tube=80e-6", "L_upstream=60e-6", "L_downstream=60e-6",
         "use_amr=1", "amr_ratio=3", "amr_buffer=24e-6", "D_grain=5e-11",
         "D_gb=5e-9"]
GATHER = ["amr_backend=gather"]


def _configs(case, precision="f64"):
    """(JAX Config, port Config) of a named case."""
    out = []
    for Config in (JConfig, TConfig):
        if case == "test_amr":
            j = make_amr_test_config(1.0e-9, 1.667e-9)
            cfg = Config(**{f.name: getattr(j, f.name)
                            for f in dataclasses.fields(j)})
        elif case == "params_amr":
            cfg = Config.load(AMR)
        else:
            cfg = Config()
            cfg.apply_overrides({"test_native": NATIVE, "test_gmres": GMRES,
                                 "coupled": COUPLED}[case])
        cfg.apply_overrides(GATHER)
        cfg.precision = precision
        out.append(cfg.compute_derived())
    return out


GRID_CASES = ["test_amr", "test_native", "test_gmres", "params_amr"]


@pytest.fixture(scope="module")
def grids():
    cache = {}

    def get(case):
        if case not in cache:
            jc, tc = _configs(case)
            cache[case] = (jamr.build_amr_grid(jc), tamr.build_amr_grid(tc))
        return cache[case]
    return get


def _ulps(a, b):
    """max |a - b| in ulps of max(|a|, |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float((np.abs(a - b) / np.maximum(sp, 1e-300)).max())


def _assert_builder_floats_close(jg, tg):
    """The native builder's floats: the packages compile it with other
    flags (the JAX package's Makefile with -march=native, which contracts
    sqrt(dx dx + dy dy) into a fused multiply-add on a host with FMA), so a
    distance may differ in its last ulp and a unit vector in two; the
    partial volume beta dx^2, beta = (delta + dx/2 - r) / dx, cancels, so
    its difference is held to 4 eps of the largest volume."""
    assert _ulps(jg.nbr_dist, tg.nbr_dist) <= 1
    assert _ulps(jg.nbr_evec, tg.nbr_evec) <= 2
    np.testing.assert_allclose(tg.nbr_vol, jg.nbr_vol, rtol=0, atol=4 * np.finfo(
        np.float64).eps * np.abs(jg.nbr_vol).max())


@pytest.mark.parametrize("case", GRID_CASES)
def test_gather_grid_arrays_equal_jax(grids, case):
    jg, tg = grids(case)
    for a in ("dim", "dx", "delta", "m", "N_total", "K", "shape",
              "axial_axis"):
        assert getattr(jg, a) == getattr(tg, a), a
    for a in ("pos", "node_type", "dx_local", "delta_local", "grid_level",
              "fict_nodes", "fict_src", "fict_w", "mirror_idx", "nbr_idx"):
        ja, ta = getattr(jg, a), getattr(tg, a)
        assert ja.dtype == ta.dtype and ja.shape == ta.shape, a
        np.testing.assert_array_equal(ja, ta, err_msg=a)
    _assert_builder_floats_close(jg, tg)
    assert jg.type_counts() == tg.type_counts()


def test_gather_grid_goldens(grids, capsys):
    """The reference's test_amr.cpp goldens (tests/test_amr.py) and the
    full-size params_amr.cfg grid with its console line."""
    cfg = _configs("test_amr")[1]
    g = grids("test_amr")[1]
    nt, lvl = g.node_type, g.grid_level
    assert int(((nt != FICTITIOUS) & (lvl == 0)).sum()) == 1600
    assert int(((nt != FICTITIOUS) & (lvl == 1)).sum()) == 2749
    assert int((nt == FICTITIOUS).sum()) == 948
    assert int((nt == FLUID).sum()) == 3600 and g.N_total == 5297
    assert bool((g.nbr_vol > 0).any(axis=1)[nt == FLUID].all())
    assert np.allclose(g.fict_w.sum(axis=1), 1.0)
    v = 1.5 * cfg.U_in * (1.0 - np.minimum(g.pos[:, 0] ** 2 / cfg.R_tube**2,
                                           1.0))
    vi = (v[g.fict_src] * g.fict_w).sum(axis=1)
    ve = v[g.fict_nodes]
    mask = ve > 1e-6
    err = float((np.abs(vi[mask] - ve[mask]) / ve[mask]).max())
    assert err == pytest.approx(4.249e-02, rel=1e-3)

    full_cfg = _configs("params_amr")[1]
    capsys.readouterr()
    full = tamr.build_amr_grid(full_cfg)
    assert capsys.readouterr().out.strip() == (
        "AMR: 14400 fine, 21672 coarse, 2904 fictitious nodes (total 38976);"
        " K=40")
    assert full.N_total == 38_976 and full.K == 40
    assert full.fict_src.shape == (2_904, 29)


def test_native_builder_equals_the_fallback(grids, monkeypatch):
    """The port's cell-list wrapper and its KD-tree fallback give the same
    bond set per node (the order of a node's bonds and the padding differ:
    K = max(8, ceil8) against ceil8)."""
    jg, g = grids("test_native")
    assert native.get_lib() is not None
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert native.cell_list_neighbors_2d(g.pos, g.node_type, g.dx_local,
                                         g.delta_local, g.grid_level) is None
    cfg = _configs("test_native")[1]
    idx_p, dist_p, evec_p, vol_p = tamr._build_neighbors_padded(
        cfg, g.pos, g.node_type, g.dx_local, g.delta_local, g.grid_level)
    assert idx_p.shape[1] % 8 == 0
    for i in range(g.N_total):
        s_native = {(int(j), round(float(d), 12), round(float(v), 24))
                    for j, d, v in zip(g.nbr_idx[i], g.nbr_dist[i],
                                       g.nbr_vol[i]) if v > 0}
        s_python = {(int(j), round(float(d), 12), round(float(v), 24))
                    for j, d, v in zip(idx_p[i], dist_p[i], vol_p[i]) if v > 0}
        assert s_native == s_python, f"bond set mismatch at node {i}"
    # the fallback's padding: idx = self, dist = 1, evec = 0, vol = 0
    pad = vol_p == 0
    assert (idx_p[pad] == np.nonzero(pad)[0]).all()
    assert (dist_p[pad] == 1.0).all() and (evec_p[pad] == 0.0).all()


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("case", ["coupled", "params_amr"])
def test_ukit_tables_equal_jax(grids, case, precision):
    jc, tc = _configs(case, precision)
    jg, tg = (grids(case) if case in GRID_CASES
              else (jamr.build_amr_grid(jc), tamr.build_amr_grid(tc)))
    jk, tk = ju.build_ukit(jg, jc), tu.build_ukit(tg, tc, device="cpu")
    assert str(tk.dtype).split(".")[-1] == jk.dtype
    assert (tk.dim, tk.N, tk.K, tk.shape) == (jk.dim, jk.N, jk.K, jk.shape)
    assert (tk.axial_comp, tk.alpha) == (jk.axial_comp, jk.alpha)
    derived = {"nbr_e", "valid", "inv_xi", "inv_xi2", "w_xi", "w_xi2"}
    for f in dataclasses.fields(tk):
        t = getattr(tk, f.name)
        if not isinstance(t, torch.Tensor) or f.name in derived:
            continue
        j = np.asarray(getattr(jk, f.name))
        assert j.shape == tuple(t.shape), f.name
        assert t.dtype in (tk.dtype, torch.bool, torch.int64), f.name
        if f.name in ("nbr_dist", "nbr_evec", "nbr_vol"):
            continue  # the builders' floats: test_gather_grid_arrays_equal_jax
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f.name)
    # the same neighbour floats, as the port's grid holds them
    for name in ("nbr_dist", "nbr_evec", "nbr_vol"):
        np.testing.assert_array_equal(
            getattr(tk, name).numpy(),
            getattr(tg, name).astype(np.asarray(getattr(jk, name)).dtype))
    # the per-bond constants the steps share, as the JAX steps form them
    inv_xi = 1.0 / tk.nbr_dist
    for name, want in (("nbr_e", tk.nbr_evec.permute(2, 0, 1)),
                       ("valid", tk.nbr_vol > 0), ("inv_xi", inv_xi),
                       ("inv_xi2", inv_xi * inv_xi),
                       ("w_xi", inv_xi * tk.nbr_vol),
                       ("w_xi2", inv_xi * inv_xi * tk.nbr_vol)):
        assert torch.equal(getattr(tk, name), want), name
    assert tk.nbr_e[0].is_contiguous()


def _states(case, precision, seed=0):
    """(JAX UKit, JAX state, port UKit, port state, port grid): both from
    the same host arrays (the JAX package's initial state and grains),
    with seeded velocities and concentrations."""
    jc, tc = _configs(case, precision)
    jg, tg = jamr.build_amr_grid(jc), tamr.build_amr_grid(tc)
    jk, tk = ju.build_ukit(jg, jc), tu.build_ukit(tg, tc, device="cpu")
    st = j_init(jg, jc, grains=j_grains.generate(jg, jc), dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}
    rng = np.random.default_rng(seed)
    nt = host["node_type"]
    moving = (nt == FLUID) | (nt == FICTITIOUS)
    host["vel"] = np.where(moving[:, None], host["vel"] + rng.normal(
        0.0, 0.05 * jc.U_in, host["vel"].shape), host["vel"])
    host["rho"] = np.where(nt != OUTSIDE, host["rho"] * (
        1.0 + 1e-3 * rng.normal(size=nt.shape)), host["rho"])
    host["C"] = np.where(nt == 1, 1.0 - 0.3 * rng.random(nt.shape),
                         np.where(moving, 0.2 * rng.random(nt.shape), 0.0))
    for k in ("C", "vel", "rho"):
        host[k] = host[k].astype(np.asarray(st.rho).dtype)
    jst = type(st)(**{k: jnp.asarray(v) for k, v in host.items()})
    dtype = torch.float64 if precision == "f64" else torch.float32
    return jk, jst, tk, state_from_numpy(host, dtype=dtype, device="cpu"), tg


RTOL = {"f64": 1e-12, "f32": 1e-5}


def _close(a, b, rtol, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max()), 1e-300)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _close_pressure(cfg, rho, pj, pt, rtol, what):
    """The Tait pressure B ((rho / rho_f)^gamma - 1) near rho_f cancels:
    besides rtol of its largest value, it may differ by the EOS's image of
    4 ulps of rho (dp/drho at the largest rho times 4 ulps of it), which is
    what a last-bit difference of a neighbour average of rho gives."""
    rho = np.asarray(rho)
    B = cfg.rho_f * cfg.c0 * cfg.c0 / cfg.gamma_eos
    ratio = min(float(rho.max()) / cfg.rho_f, 2.0)
    slope = B * cfg.gamma_eos / cfg.rho_f * ratio ** (cfg.gamma_eos - 1.0)
    pj, pt = np.asarray(pj), np.asarray(pt)
    atol = (rtol * float(np.abs(pj).max())
            + 4 * slope * float(np.spacing(rho.max())))
    np.testing.assert_allclose(pt, pj, rtol=rtol, atol=atol, err_msg=what)


def _assert_states_close(js, ts, rtol, what,
                         fields=("rho", "vel", "pressure", "C"), cfg=None):
    for f in fields:
        if f == "pressure" and cfg is not None:
            _close_pressure(cfg, js.rho, js.pressure, ts.pressure.numpy(),
                            rtol, f"{what}: pressure")
            continue
        _close(getattr(js, f), getattr(ts, f).numpy(), rtol, f"{what}: {f}")
    np.testing.assert_array_equal(np.asarray(js.node_type),
                                  ts.node_type.numpy())


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_flow_ops_equal_jax(precision):
    """compute_dt_ns, the BCs, ns_step, the wall BC and update_fictitious,
    op by op and over three iterations. The JAX side runs under jit, as in
    its solver: XLA then multiplies by 1 / rho_f where eager JAX divides,
    as the port does (ROADMAP queue C, "Two differences of rounding"); in
    float32 that last bit of rho / rho_f is ~4 % of a Tait pressure at
    rho within 1e-3 of rho_f."""
    rtol = RTOL[precision]
    jk, js, tk, ts, _ = _states("coupled", precision)
    jops = SimpleNamespace(**{name: jax.jit(getattr(ju, name)) for name in (
        "compute_dt_ns", "apply_inlet_bc", "apply_outlet_bc", "apply_wall_bc",
        "apply_solid_surface_bc", "ns_step", "update_fictitious",
        "tait_pressure")})
    tops = dispatch.ops_for(tk)
    assert tops.ns_step is tu.ns_step
    dt_j, dt_t = jops.compute_dt_ns(js, jk), tops.compute_dt_ns(ts, tk)
    assert float(dt_t) == pytest.approx(float(dt_j), rel=rtol)
    for it in range(3):
        for name in ("apply_inlet_bc", "apply_outlet_bc", "apply_wall_bc",
                     "apply_solid_surface_bc"):
            js = getattr(jops, name)(js, jk)
            ts = getattr(tops, name)(ts, tk)
            _assert_states_close(js, ts, rtol, f"{name} {it}", cfg=tk.cfg)
        js = jops.ns_step(js, jk, dt_j)
        ts = tops.ns_step(ts, tk, float(dt_j))
        _assert_states_close(js, ts, rtol, f"ns_step {it}", cfg=tk.cfg)
        js = jops.update_fictitious(jops.apply_wall_bc(js, jk), jk)
        ts = tops.update_fictitious(tops.apply_wall_bc(ts, tk), tk)
        _assert_states_close(js, ts, rtol, f"fictitious {it}", cfg=tk.cfg)
    # the same rho through both EOS: to rtol alone
    _close(jops.tait_pressure(jnp.asarray(ts.rho.numpy()), jk),
           tops.tait_pressure(ts.rho, tk).numpy(), rtol, "tait_pressure")


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_concentration_bcs_equal_jax(precision):
    rtol = RTOL[precision]
    jk, js, tk, ts, _ = _states("coupled", precision)
    for name in ("apply_wall_concentration_bc",
                 "smooth_boundary_concentration"):
        j2, t2 = getattr(ju, name)(js, jk), getattr(tu, name)(ts, tk)
        _assert_states_close(j2, t2, rtol, name, fields=("C",))
        assert not np.array_equal(np.asarray(j2.C), np.asarray(js.C)), name
    js, ts = _salted(js, ts)
    blocked = tu.compute_salt_blocked(ts, tk).numpy()
    assert blocked.any()
    np.testing.assert_array_equal(
        blocked, np.asarray(ju.compute_salt_blocked(js, jk)))


def _salted(js, ts):
    """Both states with the FLUID concentrations raised five-fold, so that
    some SOLID nodes see a neighbour at C >= C_sat."""
    fluid = ts.node_type == FLUID
    C = torch.where(fluid, ts.C * 5.0, ts.C)
    return replace(js, C=jnp.asarray(C.numpy())), replace(ts, C=C)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_explicit_ops_equal_jax(precision):
    """ard_compute_dt, ard_step (with salt-blocked SOLID nodes) and
    apply_phase_change."""
    rtol = RTOL[precision]
    jk, js, tk, ts, _ = _states("coupled", precision)
    js, ts = _salted(js, ts)
    blocked = np.asarray(ju.compute_salt_blocked(js, jk))
    assert blocked.any()
    np.testing.assert_array_equal(tu.compute_salt_blocked(ts, tk).numpy(),
                                  blocked)
    dt_j = float(ju.ard_compute_dt(js, jk))
    assert float(tu.ard_compute_dt(ts, tk)) == pytest.approx(dt_j, rel=rtol)
    js = ju.ard_step(js, jk, dt_j, 0.05)
    ts = tu.ard_step(ts, tk, dt_j, 0.05)
    _assert_states_close(js, ts, rtol, "ard_step", fields=("C",))
    (js, nj), (ts, nt_) = ju.apply_phase_change(js, jk), \
        tu.apply_phase_change(ts, tk)
    assert int(nj) == int(nt_)
    _assert_states_close(js, ts, rtol, "phase change")


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_implicit_ops_equal_jax(precision):
    """assemble, matvec_M, compute_adaptive_dt and implicit_step with its
    IDW constraint rows, and with an extrapolated start x0."""
    rtol = RTOL[precision]
    jk, js, tk, ts, tg = _states("coupled", precision)
    vl = 0.05
    jop, top = ju.assemble(js, jk, vl), tu.assemble(ts, tk, vl)
    np.testing.assert_array_equal(np.asarray(jop.unknown), top.unknown.numpy())
    np.testing.assert_array_equal(np.asarray(jop.fict), top.fict.numpy())
    _close(jop.W, top.W.numpy(), rtol, "W")
    _close(jop.diag, top.diag.numpy(), rtol, "diag")
    _close(ju.matvec_M(jop, jk, js.C), tu.matvec_M(top, tk, ts.C).numpy(),
           rtol, "matvec_M")
    dt_j = float(ju.compute_adaptive_dt(js, jop, jk))
    dt_t = float(tu.compute_adaptive_dt(ts, top, tk))
    assert dt_t == pytest.approx(dt_j, rel=rtol)
    tol = 1e-10 if precision == "f64" else 1e-6
    x0 = 1.02 * ts.C - 0.01
    for start in (None, x0):
        js2, res_j = ju.implicit_step(
            js, jop, jk, dt_j,
            x0=None if start is None else jnp.asarray(start.numpy()))
        ts2, res_t = implicit_step(tu.linear_system, ts, top, tk, dt_j,
                                   x0=start)
        assert res_t <= tol and float(res_j) <= tol
        _close(js2.C, ts2.C.numpy(), rtol, f"implicit_step x0={start is not None}")
    # the constraint rows hold after the solve, to the solve's residual
    c = ts2.C.numpy()
    b_norm = float(np.linalg.norm(np.where(tg.node_type == FICTITIOUS, 0.0,
                                           ts.C.numpy())))
    idw = (c[tg.fict_src] * tg.fict_w).sum(1)
    np.testing.assert_allclose(c[tg.fict_nodes], idw, rtol=0,
                               atol=2 * res_t * b_norm + 4 * np.finfo(c.dtype).eps)


def test_stiff_dt_f32_and_the_dt_floor():
    """tests/test_gmres.py's stiff-dt f32 case through the port: a 60 s
    step after a 10 s one reaches 1e-6 with the f64 refinement, and the
    adaptive dt honours implicit_dt_min_frac."""
    _, tc = _configs("test_gmres", "f32")
    g = tamr.build_amr_grid(tc)
    kit = tu.build_ukit(g, tc, device="cpu")
    assert kit.dtype == torch.float32
    state = initialize_state(g, tc, dtype=torch.float32, device="cpu")
    op = tu.assemble(state, kit)
    s1, _ = implicit_step(tu.linear_system, state, op, kit, 10.0)
    s2, res = implicit_step(tu.linear_system, s1, op, kit, 60.0)
    assert torch.isfinite(s2.C).all()
    assert res <= 1e-6, f"stiff-dt f32 AMR GMRES stalled at {res:.2e}"
    tc.implicit_dt_min_frac = 0.25
    kit = tu.build_ukit(g, tc, device="cpu")
    dt = float(tu.compute_adaptive_dt(s2, op, kit))
    assert dt >= 0.25 * tc.implicit_dt_max - 1e-9


@pytest.mark.parametrize("case", ["coupled", "params_amr"])
def test_grains_equal_jax(grids, case):
    """grains.generate on the gather grid, GB detection over the padded
    neighbour arrays (and its dilation) included."""
    jc, tc = _configs(case)
    jc.gb_width_cells = tc.gb_width_cells = 1
    jg, tg = (grids(case) if case in GRID_CASES
              else (jamr.build_amr_grid(jc), tamr.build_amr_grid(tc)))
    jgr, tgr = j_grains.generate(jg, jc), t_grains.generate(tg, tc)
    assert jgr.n_grains == tgr.n_grains
    for a in ("grain_id", "is_grain_boundary", "is_precipitate"):
        np.testing.assert_array_equal(getattr(jgr, a), getattr(tgr, a),
                                      err_msg=a)
    assert tgr.is_grain_boundary.any()


# ---------------------------------------------------------------------------
# the reference's AMR transport goldens (tests/test_amr.py) through the port
# ---------------------------------------------------------------------------

def _golden_setup(v_axial, sigma, z0, D):
    j = make_amr_test_config(D, 0.0)
    cfg = TConfig(**{f.name: getattr(j, f.name)
                     for f in dataclasses.fields(j)})
    cfg.amr_backend = "gather"
    cfg = cfg.compute_derived()
    g = tamr.build_amr_grid(cfg)
    nt = g.node_type
    mask = (nt == FLUID) | (nt == FICTITIOUS)
    vel = np.zeros((g.N_total, 2))
    vel[:, 1] = np.where(mask | (nt == 3) | (nt == 4), v_axial, 0.0)
    gauss = np.exp(-(g.pos[:, 0] ** 2 + (g.pos[:, 1] - z0) ** 2)
                   / (2.0 * sigma**2))
    state = initialize_state(g, cfg, dtype=torch.float64, device="cpu")
    state = replace(state, vel=torch.tensor(vel),
                    C=torch.tensor(np.where(mask, gauss, 0.0)))
    return cfg, g, state


def _golden_run(v_axial, sigma, z0, D, t_end, dt_max):
    """The reference's AMR transport test through the gather backend
    (float64): implicit steps, each followed by the IDW refresh."""
    cfg, g, state = _golden_setup(v_axial, sigma, z0, D)
    kit = tu.build_ukit(g, cfg, device="cpu")
    op = tu.assemble(state, kit)
    t = 0.0
    while t < t_end - 1e-12:
        dt = min(dt_max, t_end - t)
        state = tu.update_fictitious(
            implicit_step(tu.linear_system, state, op, kit, dt)[0], kit)
        t += dt
    return cfg, g, state.C.numpy()


def _uniform_run(cfg_amr, v_axial, sigma, z0, dt_max, t_end):
    """The uniform-fine reference run of the port's structured solver
    (test_amr.cpp:249-290)."""
    cfg = dataclasses.replace(cfg_amr)
    cfg.use_amr = 0
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, dtype=torch.float64, device="cpu")
    state = initialize_state(grid, cfg, dtype=torch.float64, device="cpu")
    nt = grid.node_type
    vel = np.zeros(grid.shape + (2,))
    vel[..., 1] = np.where((nt == FLUID) | (nt == 3) | (nt == 4), v_axial,
                           0.0)
    gauss = np.exp(-(grid.pos[..., 0] ** 2 + (grid.pos[..., 1] - z0) ** 2)
                   / (2.0 * sigma**2))
    state = replace(state, vel=torch.tensor(vel),
                    C=torch.tensor(np.where(nt == FLUID, gauss, 0.0)))
    op = tai.assemble(state, kit)
    t = 0.0
    while t < t_end - 1e-12:
        dt = min(dt_max, t_end - t)
        state = implicit_step(tai.linear_system, state, op, kit, dt)[0]
        t += dt
    return grid, state.C.numpy()


def _l2_vs_uniform(C, g, ug, uC):
    """tests/test_amr.py's l2_vs_uniform, vectorised."""
    fl = np.flatnonzero(g.node_type == FLUID)
    ii = np.rint((g.pos[fl, 0] - ug.origin[0]) / ug.dx).astype(int)
    jj = np.rint((g.pos[fl, 1] - ug.origin[1]) / ug.dx).astype(int)
    inside = (ii >= 0) & (ii < ug.Nx) & (jj >= 0) & (jj < ug.Ny)
    n = np.where(inside, jj * ug.Nx + ii, 0)
    nt = ug.node_type.ravel()[n]
    C_ref = np.where(inside & (nt != OUTSIDE) & (nt != WALL),
                     uC.ravel()[n], 0.0)
    vol = g.dx_local[fl] ** 2
    e = C[fl] - C_ref
    return math.sqrt((e * e * vol).sum() / ((C_ref * C_ref * vol).sum()
                                            + 1e-30))


# (v, D, sigma, z0, t_end, dt, L2_ana, L2_vs_uniform, C_peak or mass %)
GOLDENS = {
    "diffusion": (0.0, 1.0e-9, 30e-6, 0.0, 0.5, 0.01,
                  2.1234e-02, 5.4820e-03, None),
    "advection": (0.05, 1.0e-12, 20e-6, -20e-6, 0.0005, 5e-5,
                  4.4491e-01, 8.1940e-05, 0.8381),
    "advection_diffusion": (0.05, 1.0e-9, 20e-6, -20e-6, 0.0005, 5e-5,
                            4.4286e-01, 8.3000e-05, 0.8370),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_gather_transport_goldens(name):
    """test_amr.cpp's diffusion, advection and advection-diffusion tests
    through the port, to tests/test_amr.py's tolerances."""
    v, D, sigma, z0, t_end, dt, l2_ana, l2_uni, peak = GOLDENS[name]
    cfg, g, C = _golden_run(v, sigma, z0, D, t_end, dt)
    fluid = g.node_type == FLUID
    vol = g.dx_local**2
    Cex = np.where(fluid, exact(g.pos, 0.0, z0, sigma, D, t_end, v), 0.0)
    assert l2_weighted(C, Cex, fluid, vol) == pytest.approx(l2_ana, rel=2e-3)
    C0 = np.exp(-(g.pos[:, 0] ** 2 + (g.pos[:, 1] - z0) ** 2)
                / (2.0 * sigma**2))
    mass0 = float((C0 * vol)[fluid].sum())
    drift = abs(float((C * vol)[fluid].sum()) - mass0) / mass0
    if peak is None:
        assert drift * 100.0 == pytest.approx(0.175, rel=0.05)
    else:
        assert float(C[fluid].max()) == pytest.approx(peak, rel=2e-3)
        assert drift < 0.05
    ug, uC = _uniform_run(cfg, v, sigma, z0, dt, t_end)
    got = _l2_vs_uniform(C, g, ug, uC)
    assert got < 0.10
    assert got == pytest.approx(l2_uni, rel=5e-3 if peak is None else 0.05)
