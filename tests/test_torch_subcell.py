"""The sub-cell 3D wall mirror (wall_mirror_subcell = 1) in the port
against the JAX package.

The JAX kit holds the bilinear weights as columns of a float32 matrix
(``wm_G``) applied by matmuls over the cross-section; the port holds, per
wall node of a primary column, up to four (source, weight) pairs in the
node's own z-plane (``kit.mirror_sub_*``), the weights being the same
float32 numbers. Held here, on tests/test_3d.py's cfg3d() grid (the grid
of test_3d_subcell_mirror_oracle) and on the 8,303-node grid of
tests/test_pallas_interpret.py:

* the weights equal to the JAX kit's wm_G, entry for entry;
* test_3d_subcell_mirror_oracle's oracle: the weights of every column are
  non-negative and sum to 1 (within 1e-3), most columns are interpolated,
  and the mirrored values are the weighted sums (rtol 1e-12);
* ``apply_wall_bc`` against the JAX ``apply_wall_bc`` on a seeded state,
  to the round-off of a sum of up to four products (which XLA may fuse):
  4 units of the dtype's epsilon relative to each value or to the largest
  value of the field, whichever is larger (velocities of both signs
  cancel).
"""

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
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import boundary as t_bc
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy

torch.set_num_threads(2)

GRIDS = {
    # tests/test_3d.py cfg3d()
    "cfg3d": ["dim=3", "dx=5e-6", "R_wire=15e-6", "L_wire=60e-6",
              "R_tube=50e-6", "L_upstream=40e-6", "L_downstream=40e-6",
              "Q_flow=1.667e-10", "eta_density=1.0"],
    # tests/test_pallas_interpret.py's 3D grid
    "small": ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
              "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6"],
}


def _kits(grid, precision="f64", subcell=1):
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides([*GRIDS[grid], f"precision={precision}",
                           f"wall_mirror_subcell={subcell}"])
    jg = j_build_grid(j)
    return jg, j, j_build_kit(jg, j), t_build_kit(t_build_grid(t), t,
                                                 device="cpu")


def _dense_G(tk, jk):
    """The port's per-node weights as the JAX kit's [XS, P] matrix, read
    off the first z-plane holding each primary column's wall node."""
    XS = tk.shape[1] * tk.shape[2]
    dst_cols = np.asarray(jk.wm_dst_cols)
    G = np.zeros((XS, max(dst_cols.size, 1)), np.float32)
    dst = tk.mirror_sub_dst.numpy()
    src, w = tk.mirror_sub_src.numpy(), tk.mirror_sub_w.numpy()
    seen = set()
    for n, q in enumerate(dst):
        p = int(np.searchsorted(dst_cols, q % XS))
        assert dst_cols[p] == q % XS
        if p in seen:
            continue
        seen.add(p)
        for k in range(src.shape[0]):
            if w[k, n] != 0:
                assert src[k, n] // XS == q // XS   # the node's own plane
                G[src[k, n] % XS, p] = w[k, n]
    assert seen == set(range(dst_cols.size))
    return G


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_subcell_weights_equal_jax(grid):
    jg, _, jk, tk = _kits(grid)
    G = np.asarray(jk.wm_G)
    P = int(jk.wm_dst_cols.size)
    assert P > 0 and tk.mirror_sub_dst.numel() > 0
    np.testing.assert_array_equal(_dense_G(tk, jk), G)
    # every wall node of a primary column is covered once, none other
    XS = tk.shape[1] * tk.shape[2]
    mi = jg.mirror_idx.reshape(tk.shape[0], XS)
    primary = np.isin(np.arange(XS), np.asarray(jk.wm_dst_cols))
    want = np.flatnonzero(primary[None, :] & (mi >= 0))
    np.testing.assert_array_equal(np.sort(tk.mirror_sub_dst.numpy()), want)
    # the run dtype holds the float32 weights exactly
    np.testing.assert_array_equal(tk.mirror_sub_w.numpy(),
                                  tk.mirror_sub_w.numpy().astype(np.float32))
    # without the option there are no sub-cell terms
    assert t_build_kit(t_build_grid(_cfg_off(grid)), _cfg_off(grid),
                       device="cpu").mirror_sub_dst.numel() == 0


def _cfg_off(grid):
    t = TConfig()
    t.apply_overrides([*GRIDS[grid], "precision=f64"])
    return t


def test_subcell_mirror_oracle():
    """tests/test_3d.py::test_3d_subcell_mirror_oracle's checks on the
    port: weights non-negative and summing to 1 per column, most columns
    interpolated, and every mirrored wall value the weighted sum of its
    sources (rho symmetric, vel antisymmetric)."""
    jg, j, jk, tk = _kits("cfg3d")
    w = tk.mirror_sub_w.numpy()
    sums = w.sum(axis=0)
    assert np.all(sums > 0.999) and np.all(sums < 1.001)
    assert np.all(w >= 0)
    assert int(((w > 0).sum(axis=0) > 1).sum()) > 0.5 * w.shape[1]

    rng = np.random.default_rng(2)
    rho = rng.uniform(900.0, 1100.0, tk.shape)
    vel = rng.normal(size=tk.shape + (3,))
    js = j_initialize_state(jg, j, dtype=jnp.float64)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    host.update(rho=rho, vel=vel)
    out = t_bc.apply_wall_bc(state_from_numpy(host, dtype=torch.float64,
                                              device="cpu"), tk)
    dst, src = tk.mirror_sub_dst.numpy(), tk.mirror_sub_src.numpy()
    for n in rng.choice(dst.size, size=min(200, dst.size), replace=False):
        exp_rho = (rho.reshape(-1)[src[:, n]] * w[:, n]).sum()
        exp_vel = -(vel.reshape(-1, 3)[src[:, n]] * w[:, n, None]).sum(0)
        np.testing.assert_allclose(out.rho.numpy().reshape(-1)[dst[n]],
                                   exp_rho, rtol=1e-12)
        np.testing.assert_allclose(out.vel.numpy().reshape(-1, 3)[dst[n]],
                                   exp_vel, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_apply_wall_bc_equals_jax(grid, precision):
    jg, j, jk, tk = _kits(grid, precision)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(7)
    host["rho"] = host["rho"] + rng.normal(0, 5.0, tk.shape)
    host["vel"] = rng.normal(size=tk.shape + (3,))
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy(host, dtype=tk.dtype, device="cpu")
    ref = jax.jit(lambda s: j_bc.apply_wall_bc(s, jk))(js)
    out = t_bc.apply_wall_bc(ts, tk)
    eps = 4 * float(np.finfo(np.asarray(ref.rho).dtype).eps)
    for f in ("rho", "vel"):
        b = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(out, f).numpy(), b, rtol=eps,
                                   atol=eps * np.abs(b).max(), err_msg=f)
    # the weighted mirror differs from the staircase one
    stair = t_build_kit(t_build_grid(_cfg_off(grid)), _cfg_off(grid),
                        device="cpu")
    if precision == "f64":
        assert not torch.equal(t_bc.apply_wall_bc(ts, stair).rho, out.rho)
