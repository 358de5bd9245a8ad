"""The port's 3D kit and the plain twins of its three 3D CUDA kernels (ns3d,
matvec3d with f32 and bf16 weights, slots3d_f64) against the JAX package,
on the small 3D grid of tests/test_pallas_interpret.py (23 x 19 x 19 =
8,303 nodes, S = 178).

Inputs are made from a numpy seed and handed to both packages. The JAX
side runs its XLA (scan-over-slots) forms, the reference its own CPU tests
use, and for ns3d also its Pallas kernel through the Pallas interpreter
(the act-static form the port's ns3d computes). Tolerances: float64 to
round-off; float32 as tests/test_pallas_interpret.py holds the Pallas
kernels to the XLA forms."""

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
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu.ops import ns as j_ns
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import boundary as t_bc
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kernels
from pd_mg_pin_corrosion_tpu_torch import kit as t_kit_mod
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns

torch.set_num_threads(2)

# tests/test_pallas_interpret.py's 3D geometry
GEOMETRY = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6"]


def _configs(precision, overrides=()):
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides([*GEOMETRY, f"precision={precision}", *overrides])
    return j, t


def _kits(precision, overrides=()):
    j, t = _configs(precision, overrides)
    jg, tg = j_build_grid(j), t_build_grid(t)
    return j_build_kit(jg, j), t_build_kit(tg, t, device="cpu"), jg, j


def _states(precision, seed=0):
    """JAX and port (kit, state) from one seeded perturbation of the
    initial fields (FLUID rho and vel, C)."""
    jk, tk, jg, j = _kits(precision)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    fluid = host["node_type"] == 0
    host["rho"] = np.where(fluid, host["rho"] + rng.normal(0, 0.1, fluid.shape),
                           host["rho"])
    host["vel"] = np.where(fluid[..., None],
                           host["vel"] + rng.normal(0, 0.05, fluid.shape + (3,)),
                           host["vel"])
    host["C"] = np.where(host["node_type"] == 1, 1.0,
                         0.3 * rng.random(fluid.shape))
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in host},
                          dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


def _close(a, b, rtol, atol_rel=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * np.abs(b).max())


@pytest.mark.parametrize("legacy", [0, 1])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_kit_3d_arrays_equal(precision, legacy):
    jk, tk, jg, _ = _kits(precision, [f"legacy_3d_constants={legacy}"])
    assert tk.shape == (23, 19, 19) and tk.S == 178 and tk.mext == 4
    assert str(tk.dtype).split(".")[-1] == jk.dtype
    for a in ("inlet_mask", "outlet_mask", "wall_mask", "near_inlet_mask",
              "near_outlet_mask", "v_pois", "initial_solid_mask",
              "mirror_none_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jk, a)),
                                      getattr(tk, a).numpy(), err_msg=a)
    for a in ("dim", "shape", "mext", "offsets", "dist", "evec", "vol",
              "inlet_rows", "outlet_rows", "S", "alpha", "V_H", "beta_lap"):
        assert getattr(jk, a) == getattr(tk, a), a
    # the flat mirror gather is the grid's mirror table
    mi = jg.mirror_idx.ravel()
    np.testing.assert_array_equal(tk.mirror_mask.numpy().ravel(), mi >= 0)
    np.testing.assert_array_equal(tk.mirror_src.numpy().ravel(),
                                  np.where(mi >= 0, mi, np.arange(mi.size)))
    # the slot constants are the JAX scan's (Kit.stencil_jnp), rounded to
    # the run dtype the same way
    offs, dists, evecs, vols = jk.stencil_jnp()
    ixi = 1.0 / dists
    ixi_t, ixi2_t, e_t, vol_t = tk.coefs()
    np.testing.assert_array_equal(ixi_t.numpy().ravel(), np.asarray(ixi))
    np.testing.assert_array_equal(ixi2_t.numpy().ravel(),
                                  np.asarray(ixi * ixi))
    np.testing.assert_array_equal(
        np.stack([c.numpy().ravel() for c in e_t], -1), np.asarray(evecs))
    np.testing.assert_array_equal(vol_t.numpy().ravel(), np.asarray(vols))
    np.testing.assert_array_equal(tk.slot_offsets.numpy(), np.asarray(offs))

    # the act-static NS tables: the Pallas kernel's slot order (one chunk of
    # (dj, di) groups) and constants, and the JAX kit's pure-act sums
    order = [(dk, dj, di, xi, e, vol) for (dj, di), slots
             in pk._group_chunks_3d(jk, 1)[0] for dk, xi, e, vol in slots]
    np.testing.assert_array_equal(tk.ns_offsets.numpy(),
                                  [o[:3] for o in order])
    np.testing.assert_array_equal(tk.slot_offsets[tk.ns_slots].numpy(),
                                  tk.ns_offsets.numpy())
    np.testing.assert_array_equal(
        tk.ns_coefs.numpy(),
        np.asarray([[vol / (xi * xi) for *_, xi, e, vol in order]]
                   + [[e[d] * (vol / xi) for *_, xi, e, vol in order]
                      for d in range(3)], tk.ns_coefs.numpy().dtype))
    B = np.asarray(jk.actconv3d)
    if precision == "f32":
        np.testing.assert_array_equal(tk.actconv3d.numpy(), B)
    else:
        _close(tk.actconv3d, B, 1e-6, 1e-6)

    # shift / neighbors (in slot ranges and row bands) agree with the JAX
    # kit's padded slices
    rng = np.random.default_rng(1)
    a = rng.random(jk.shape)
    jp, tp = jk.pad(jnp.asarray(a), 0.0), tk.pad(torch.as_tensor(a), 0.0)
    nb = tk.neighbors(tp, 2, 9, 40, 100).numpy()
    for s in range(jk.S):
        ref = np.asarray(jk.shift(jp, s))
        np.testing.assert_array_equal(ref, tk.shift(tp, s).numpy())
        if 40 <= s < 100:
            np.testing.assert_array_equal(ref[2:9], nb[s - 40])


def test_kit_refuses_subcell_mirror():
    """The kit no longer refuses wall_mirror_subcell: it builds the
    bilinear mirror's terms, up to four a wall node of a primary column,
    with float32 weights that sum to 1 (tests/test_torch_subcell.py holds
    them against the JAX kit), and the staircase table stays as it was."""
    _, t = _configs("f64", ["wall_mirror_subcell=1"])
    grid = t_build_grid(t)
    tk = t_build_kit(grid, t, device="cpu")
    n = tk.mirror_sub_dst.numel()
    assert n > 0 and tk.mirror_sub_src.shape == tk.mirror_sub_w.shape == (4, n)
    w = tk.mirror_sub_w.numpy()
    np.testing.assert_array_equal(w, w.astype(np.float32))
    assert np.all(np.abs(w.sum(0) - 1.0) < 1e-3)
    assert bool(tk.mirror_mask.view(-1)[tk.mirror_sub_dst].all())
    mi = grid.mirror_idx.ravel()
    np.testing.assert_array_equal(tk.mirror_src.numpy().ravel(),
                                  np.where(mi >= 0, mi, np.arange(mi.size)))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_wall_mirror_equals_jax(precision):
    """boundary.apply_wall_bc (one flat gather) against the JAX package's
    one-hot cross-section matmuls (boundary._wall_mirror, 3D branch)."""
    jk, js, tk, ts = _states(precision, seed=4)
    rho, vel = jax.jit(lambda s: j_bc._wall_mirror(s, jk, s.rho, s.vel))(js)
    out = t_bc.apply_wall_bc(ts, tk)
    np.testing.assert_array_equal(out.rho.numpy(), np.asarray(rho))
    np.testing.assert_array_equal(out.vel.numpy(), np.asarray(vel))


def test_ns3d_plain_matches_the_pallas_kernel():
    """ns3d's act-static form against the JAX package's Pallas kernel
    (ns_step_pallas_3d) run through the Pallas interpreter, in float32:
    the same algebra, within 2 ulp of rho (XLA on the CPU may fuse a
    multiply-add the port rounds twice)."""
    jk, js, tk, ts = _states("f32", seed=3)
    dt = j_ns.compute_dt(js, jk)
    pk.INTERPRET = True
    try:
        ref = pk.ns_step_pallas_3d(js, jk, dt)
    finally:
        pk.INTERPRET = False
    out = t_ns.ns_step(ts, tk, t_ns.compute_dt(ts, tk))
    np.testing.assert_array_max_ulp(out.rho.numpy(), np.asarray(ref.rho), 2)
    _close(out.vel, ref.vel, 1e-6, 2e-9)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_ns3d_plain_matches_xla(precision):
    jk, js, tk, ts = _states(precision)
    jdt = j_ns.compute_dt(js, jk)
    tdt = t_ns.compute_dt(ts, tk)
    assert float(jdt) == float(tdt)
    ref = jax.jit(lambda s: j_ns.ns_step(s, jk, jdt))(js)
    out = t_ns.ns_step(ts, tk, tdt)
    if precision == "f64":
        for a in ("pressure", "rho", "vel"):
            _close(getattr(out, a), getattr(ref, a), 1e-10, 1e-12)
    else:
        _close(out.rho, ref.rho, 1e-6)
        np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                                   rtol=1e-4, atol=1e-9)
    # the dispatch on CPU tensors is the plain twin, and launches nothing
    before = kernels.ns3d.launches
    p = t_ns.tait_pressure(ts.rho, tk)
    r, v = kernels.ns3d(ts.rho, ts.vel, p, ts.node_type, tdt, tk)
    rp, vp = kernels.ns3d_plain(ts.rho, ts.vel, p, ts.node_type, tdt, tk)
    assert torch.equal(r, rp) and torch.equal(v, vp)
    assert torch.equal(r, out.rho) and torch.equal(v, out.vel)
    assert kernels.ns3d.launches == before


def _operator(precision, seed=2):
    jk, js, tk, ts = _states(precision, seed)
    op = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    x = np.random.default_rng(seed).random(jk.shape)
    args = (torch.tensor(np.asarray(op.W)), torch.tensor(np.asarray(op.diag)),
            torch.tensor(np.asarray(op.unknown)))
    return jk, op, tk, args, x


# bf16 weights exist in float32 runs only
@pytest.mark.parametrize("precision,weights",
                         [("f64", "f64"), ("f32", "f32"), ("f32", "bf16")])
def test_matvec3d_plain_matches_xla(precision, weights):
    jk, op, tk, (W, diag, unk), x = _operator(precision)
    if weights == "bf16":
        Wj = op.W.astype(jnp.bfloat16).astype(jnp.float32)
        op = j_ai.ImplicitOperator(W=Wj, diag=op.diag, unknown=op.unknown)
        W = W.to(torch.bfloat16)
        np.testing.assert_array_equal(W.float().numpy(), np.asarray(Wj))
    dt = jk.jdtype
    ref = jax.jit(lambda o, v: j_ai.matvec_M(o, jk, v))(op, jnp.asarray(x, dt))
    xt = torch.tensor(np.asarray(jnp.asarray(x, dt)))
    out = kernels.matvec3d_plain(xt, W, diag, unk, tk)
    assert out.dtype == xt.dtype
    tol = 1e-12 if precision == "f64" else 1e-5
    _close(out, ref, tol, tol)
    before = kernels.matvec3d.launches
    assert torch.equal(kernels.matvec3d(xt, W, diag, unk, tk), out)
    assert kernels.matvec3d.launches == before


def test_slots3d_f64_plain_matches_exact_sum():
    """test_pallas_interpret.py's exact f64 slot sum (no diag, no mask) of
    the f32 operator's weights, against the plain twin."""
    jk, op, tk, (W, _, _), _ = _operator("f32", seed=17)
    x64 = np.random.default_rng(17).random(jk.shape)
    W64 = np.asarray(op.W, np.float64)
    x_p = jk.pad(jnp.asarray(x64), 0.0)
    ref = jnp.zeros(jk.shape, jnp.float64)
    for s, _, _, _ in jk.bond_iter():
        ref = ref + jnp.asarray(W64[s]) * jk.shift(x_p, s)
    ref = np.asarray(ref)
    out = kernels.slots3d_f64(torch.tensor(x64), W, tk)
    assert out.dtype == torch.float64
    rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= 1e-14, rel
    assert torch.equal(out, kernels.slots3d_f64_plain(torch.tensor(x64), W, tk))


def test_slot_chunks_do_not_change_the_sums(monkeypatch):
    """The twins accumulate slot by slot in stencil order, so walking the
    stencil in chunks of 7 slots gives the same bits as one chunk."""
    _, _, tk, ts = _states("f32", seed=5)
    p = t_ns.tait_pressure(ts.rho, tk)
    dt = t_ns.compute_dt(ts, tk)
    W = torch.tensor(np.random.default_rng(5).random((tk.S,) + tk.shape),
                     dtype=torch.float32)
    x = ts.C
    args = (W, ts.rho, ts.C != 0, tk)

    def run():
        return (kernels.ns3d_plain(ts.rho, ts.vel, p, ts.node_type, dt, tk)
                + (kernels.matvec3d_plain(x, *args),
                   kernels.matvec3d_plain(x, W.to(torch.bfloat16), *args[1:]),
                   kernels.slots3d_f64_plain(x.double(), W, tk)))

    whole = run()
    assert len(tk.slot_chunks()) == 1
    monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS", 7 * 8303)
    assert len(tk.slot_chunks()) == 26
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_wrapper_rules_for_the_3d_kernels():
    _, _, tk, ts = _states("f32", seed=6)
    W = torch.zeros((tk.S,) + tk.shape)
    # f32 W with an f64 x is the slot sum's contract
    assert kernels.slots3d_f64(ts.C.double(), W, tk).dtype == torch.float64
    with pytest.raises(ValueError):
        kernels.slots3d_f64(ts.C.double(), W.to("meta"), tk)
    assert {"ns3d", "matvec3d", "slots3d_f64"} <= set(kernels.launch_counts())
