"""The plain PyTorch twins of the port's four CUDA kernels vs the JAX
package: its XLA ops and its Pallas kernels run through the interpreter.

Inputs are made from a numpy seed and handed to both packages. Tolerances:
float64 to 1e-12 relative (same arithmetic, reduction order may differ);
float32 as tests/test_pallas_interpret.py holds the Pallas kernels to their
XLA forms."""

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
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu.ops import ns as j_ns
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kernels
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.kernels.build import use_plain
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


def _setup(precision, seed=0):
    """JAX (kit, state) and port (kit, state) on parity.cfg, from one
    seeded perturbation of the initial fields (FLUID rho and vel, C)."""
    j, t = JConfig.load(PARITY), TConfig.load(PARITY)
    for c in (j, t):
        c.precision = precision
        c.compute_derived()
    jk = j_build_kit(j_build_grid(j), j)
    tk = t_build_kit(t_build_grid(t), t, device="cpu")
    js = j_initialize_state(j_build_grid(j), j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    fluid = host["node_type"] == 0
    host["rho"] = np.where(fluid, host["rho"] + rng.normal(0, 0.1, fluid.shape),
                           host["rho"])
    host["vel"] = np.where(fluid[..., None],
                           host["vel"] + rng.normal(0, 0.005, fluid.shape + (2,)),
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


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_ns_step_matches_xla(precision):
    jk, js, tk, ts = _setup(precision)
    jdt = j_ns.compute_dt(js, jk)
    tdt = t_ns.compute_dt(ts, tk)
    assert float(jdt) == float(tdt)
    ref = jax.jit(lambda s: j_ns.ns_step(s, jk, jdt))(js)
    out = t_ns.ns_step(ts, tk, tdt)
    if precision == "f64":
        _close(out.pressure, ref.pressure, 1e-12, 1e-12)
        _close(out.rho, ref.rho, 1e-12)
        _close(out.vel, ref.vel, 1e-12, 1e-12)
    else:
        _close(out.rho, ref.rho, 1e-6)
        np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                                   rtol=1e-5, atol=1e-9)


def test_ns_step_matches_pallas_interpret():
    jk, js, tk, ts = _setup("f32", seed=1)
    dt = j_ns.compute_dt(js, jk)
    pk.INTERPRET = True
    try:
        ref = pk.ns_step_pallas(js, jk, dt)
    finally:
        pk.INTERPRET = False
    out = t_ns.ns_step(ts, tk, t_ns.compute_dt(ts, tk))
    np.testing.assert_allclose(out.rho.numpy(), np.asarray(ref.rho),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                               rtol=1e-5, atol=1e-9)


def _operator(precision, seed=2):
    jk, js, tk, ts = _setup(precision, seed)
    op = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    x = np.random.default_rng(seed).random(jk.shape)
    args = (torch.tensor(np.asarray(op.W)), torch.tensor(np.asarray(op.diag)),
            torch.tensor(np.asarray(op.unknown)))
    return jk, op, tk, args, x


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_matvec_matches_xla(precision):
    jk, op, tk, (W, diag, unk), x = _operator(precision)
    dt = jk.jdtype
    ref = jax.jit(lambda o, v: j_ai.matvec_M(o, jk, v))(op, jnp.asarray(x, dt))
    xt = torch.tensor(np.asarray(jnp.asarray(x, dt)))
    out = kernels.matvec2d_plain(xt, W, diag, unk, tk)
    tol = 1e-12 if precision == "f64" else 1e-5
    _close(out, ref, tol, tol)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = kernels.matvec2d.launches
    assert torch.equal(kernels.matvec2d(xt, W, diag, unk, tk), out)
    assert kernels.matvec2d.launches == before


def test_matvec_matches_pallas_interpret():
    jk, op, tk, (W, diag, unk), x = _operator("f32", seed=3)
    xj = jnp.asarray(x, jnp.float32)
    pk.INTERPRET = True
    try:
        ref = pk.matvec_M_pallas(op, jk, xj)
    finally:
        pk.INTERPRET = False
    out = kernels.matvec2d_plain(torch.tensor(np.asarray(xj)), W, diag,
                                 unk, tk)
    _close(out, ref, 1e-5, 1e-5)


def test_basis_kernels_match_pallas_interpret():
    """Same shapes, seed and tolerances as test_pallas_interpret's
    basis-kernel test; the port's basis is the flat [M1, N] view."""
    rng = np.random.default_rng(3)
    M1, R, L = 9, pk._BR_GB * 2, 128
    V2 = jnp.asarray(rng.normal(size=(M1, R, L)), jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(1, R, L)), jnp.float32)
    c = jnp.asarray(rng.normal(size=M1), jnp.float64)
    pk.INTERPRET = True
    try:
        dots_ref = pk.basis_dots_pallas(V2, w2, jnp.float64)
        axpy_ref = pk.basis_axpy_pallas(c, V2, w2)
    finally:
        pk.INTERPRET = False

    V = torch.tensor(np.asarray(V2)).reshape(M1, -1)
    w = torch.tensor(np.asarray(w2)).reshape(-1)
    ct = torch.tensor(np.asarray(c))
    dots = kernels.basis_dots(V, w)
    axpy = kernels.basis_axpy(ct, V, w)
    assert dots.dtype == torch.float64 and axpy.dtype == torch.float32
    np.testing.assert_allclose(dots.numpy(), np.asarray(dots_ref),
                               rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(axpy.numpy(), np.asarray(axpy_ref).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    # the f64 sum of f32 products, against the exact f64 dot
    exact = (V.double() * w.double()).sum(-1)
    np.testing.assert_allclose(dots.numpy(), exact.numpy(), rtol=2e-6, atol=1e-3)
    # w = None is the solution update (w = 0)
    np.testing.assert_array_equal(kernels.basis_axpy(ct, V).numpy(),
                                  kernels.basis_axpy(ct, V, torch.zeros_like(w)).numpy())


@pytest.mark.parametrize("cdtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1000, 1001])
def test_basis_wrappers_take_pitched_rows(n, cdtype):
    """Rows of a pitched allocation (contiguous rows, any row stride) give
    the bits of the same rows stored back to back; a basis whose rows are
    not contiguous is refused on every device."""
    rng = np.random.default_rng(n)
    k = 7
    flat = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    V = kernels.pitched_basis(k + 1, n, torch.float32, "cpu")[:k]
    V.copy_(flat)
    assert V.stride() == (1024, 1)
    w = torch.tensor(rng.normal(size=n), dtype=torch.float32)
    c = torch.tensor(rng.normal(size=k), dtype=cdtype)
    assert torch.equal(kernels.basis_dots(V, w), kernels.basis_dots(flat, w))
    assert torch.equal(kernels.basis_axpy(c, V, w),
                       kernels.basis_axpy(c, flat, w))
    assert torch.equal(kernels.basis_axpy(c, V),
                       kernels.basis_axpy_plain(c.float(), flat))
    from pd_mg_pin_corrosion_tpu_torch.kernels.basis import _check_basis
    assert _check_basis("k", V) == (k, n, 1024)
    assert _check_basis("k", flat[:1]) == (1, n, n)
    with pytest.raises(ValueError):
        _check_basis("k", flat.T)
    with pytest.raises(ValueError):
        _check_basis("k", flat[:, ::2])


def test_wrapper_device_rule():
    cpu = torch.zeros(4)
    assert use_plain("k", cpu, cpu)
    with pytest.raises(ValueError):
        use_plain("k", torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        use_plain("k", cpu, torch.zeros(4, device="meta"))
    counts = kernels.launch_counts()
    assert set(counts) == {"ns2d", "matvec2d", "basis_dots", "basis_axpy",
                           "ns3d", "matvec3d", "matvec3d_bf16", "slots3d_f64",
                           "ard2d", "ns3d_chunked_xla",
                           "ns3d_chunked_factored", "ns3d_chunked_jconv",
                           "ns3d_jstat", "gmres_qr", "cycle_qr", "pack3d"}
    kernels.reset_launch_counts()
    assert all(v == 0 for v in kernels.launch_counts().values())
