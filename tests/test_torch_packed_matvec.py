"""The packed form of the 3D implicit operator's weights
(``kernels.pack_stencil``: nonzero weights in warp slices, each with its
slot number, and a count per row) and GMRES's pitched Krylov basis, on the CPU.

The CUDA matvec3d kernel walks the packed form; here a plain PyTorch walk
of the same layout (``matvec3d_packed_plain``) stands in for it and is held
to the dense twin bit for bit, and to the JAX package's ``matvec_M`` at
rtol 1e-6 (f32 rounding, sums in the same order). Grid: the 8,303-node 3D
grid of tests/test_pallas_interpret.py (S = 178, not a multiple of 32;
8,303 = 259 * 32 + 15, so the last slice is ragged) and the same geometry
with m_ratio = 2. Inputs are made from a numpy seed."""

import dataclasses

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
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kernels
from pd_mg_pin_corrosion_tpu_torch import kit as t_kit_mod
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import (GROUP, SLICE,
                                                            lane_chunk)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops import gmres as t_gmres
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

SMALL_3D = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "Q_flow=1.667e-10", "eta_density=1.0", "D_grain=5e-11",
            "D_gb=5e-9", "precision=f32"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _setup(seed=0, overrides=()):
    """JAX and port (kit, state) with a seeded transport state (developed
    C, perturbed velocity, a few FLUID nodes at C >= C_sat by the wire)."""
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides([*SMALL_3D, *overrides])
    jg = j_build_grid(j)
    jk, tk = j_build_kit(jg, j), t_build_kit(t_build_grid(t), t, device="cpu")
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    h = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    solid, fluid = h["node_type"] == 1, h["node_type"] == 0
    h["C"] = np.where(solid, 0.6 + 0.4 * rng.random(solid.shape),
                      0.05 * rng.random(solid.shape))
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95
    h["vel"] = np.where(fluid[..., None],
                        h["vel"] + rng.normal(0, 0.01, h["vel"].shape),
                        h["vel"])
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in h.items()})
    return jk, js, tk, state_from_numpy(h, dtype=tk.dtype, device="cpu")


def _synthetic(tk, seed):
    """A random sparse W (about 40 % nonzero) and unknown mask with the
    layout's corner cases: a slice with no unknown row, an unknown row with
    no nonzero weight, a full row, and unknown rows in the ragged last
    slice."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(tk.shape))
    W = rng.normal(size=(tk.S, n)) * (rng.random((tk.S, n)) < 0.4)
    unknown = rng.random(n) < 0.6
    unknown[3 * SLICE:4 * SLICE] = False          # a slice with no unknown row
    unknown[5 * SLICE + 7] = True
    W[:, 5 * SLICE + 7] = 0.0                     # an unknown row of zeros
    unknown[6 * SLICE + 1] = True
    W[:, 6 * SLICE + 1] = rng.normal(size=tk.S)   # a full row
    assert n % SLICE != 0
    unknown[n - 3:] = True                        # the ragged last slice
    W[:, ~unknown] = rng.normal(size=(tk.S, int((~unknown).sum())))
    return (torch.tensor(W, dtype=torch.float32).view((tk.S,) + tk.shape),
            torch.tensor(unknown).view(tk.shape))


def _inputs(case, seed=0):
    """(kit, dense f32 W, diag, unknown, x) of a case: the assembled
    operator of a seeded state, the same at m_ratio = 2, or synthetic."""
    _, _, tk, ts = _setup(seed, ["m_ratio=2"] if case == "m_ratio2" else [])
    rng = np.random.default_rng(seed + 1)
    x = torch.tensor(rng.normal(size=tk.shape), dtype=torch.float32)
    if case == "synthetic":
        W, unknown = _synthetic(tk, seed)
        diag = torch.tensor(rng.normal(size=tk.shape), dtype=torch.float32)
        return tk, W, diag, unknown, x
    op = t_ai.assemble(ts, tk)
    return tk, op.W, op.diag, op.unknown, x


CASES = ["operator", "m_ratio2", "synthetic"]


@pytest.mark.parametrize("group", [4, GROUP])
@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_unpack_gives_back_the_unknown_rows(case, weights, group):
    tk, W, _, unknown, _ = _inputs(case)
    assert (tk.S % 32 != 0) and tk.S == (178 if case != "m_ratio2" else 80)
    packed = kernels.pack_stencil(W, unknown, tk, group)
    assert GROUP == 16 and packed.group == group
    n = unknown.numel()
    # kept: nonzero, on an unknown row, to a neighbour inside the grid
    inside = tk.neighbors(tk.pad(torch.ones(tk.shape), 0.0)) != 0
    assert not inside.all() and (case == "synthetic") == bool(
        ((W != 0) & unknown & ~inside).any())
    nz = ((W != 0) & unknown & inside).reshape(tk.S, -1)
    assert packed.count.dtype == torch.int16 and torch.equal(
        packed.count.long(), nz.sum(0))
    assert packed.slice_ptr.dtype == torch.int32
    assert packed.slice_ptr.shape == (-(-n // SLICE) + 1,)
    assert packed.slots.dtype == torch.uint8
    assert (packed.values.numel() == packed.slots.numel()
            == SLICE * int(packed.slice_ptr[-1]))
    assert packed.nnz == int(nz.sum())
    if weights == "bf16":
        packed = packed.to(torch.bfloat16)
    assert packed.dtype == DTYPES[weights]
    dense = kernels.unpack_stencil(packed, tk)
    expect = torch.where(unknown & inside, W, 0.0).to(DTYPES[weights])
    assert dense.dtype == expect.dtype and torch.equal(dense, expect)
    # a slice is as long as its fullest row, rounded up to whole groups
    count = nz.sum(0)
    lens = torch.nn.functional.pad(count, (0, -n % SLICE)).view(-1, SLICE)
    lens = -(-lens.max(1).values // group) * group
    assert torch.equal(packed.slice_ptr[1:].long(), lens.cumsum(0))
    # a row's first ``group`` slot numbers lie side by side, its values in
    # chunks (4 of float32, the group of bfloat16), the chunks of the
    # slice's 32 rows side by side
    row = int(count.argmax())
    block = int(packed.slice_ptr[row // SLICE]) * SLICE
    lane = row % SLICE
    slots = nz[:, row].nonzero()[:group, 0]
    assert torch.equal(
        packed.slots[block + lane * group:block + (lane + 1) * group].long(),
        slots)
    c = lane_chunk(DTYPES[weights], group)
    assert packed.chunk == c == (4 if weights == "f32" else group)
    stored = torch.cat([packed.values[block + h * SLICE * c + lane * c:
                                      block + h * SLICE * c + (lane + 1) * c]
                        for h in range(group // c)])
    assert torch.equal(stored.float(), W.reshape(tk.S, -1)[slots, row].to(
        DTYPES[weights]).float())
    # rounding after packing equals packing the rounded weights
    if weights == "bf16":
        direct = kernels.pack_stencil(W.to(torch.bfloat16), unknown, tk, group)
        assert torch.equal(direct.values, packed.values)
        assert torch.equal(direct.slots, packed.slots)


@pytest.mark.parametrize("group", [8, GROUP])
@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_packed_walk_equals_dense_twin(case, weights, group):
    tk, W, diag, unknown, x = _inputs(case, seed=3)
    packed = kernels.pack_stencil(W, unknown, tk, group).to(DTYPES[weights])
    twin = kernels.matvec3d_plain(x, W.to(DTYPES[weights]), diag, unknown, tk)
    out = kernels.matvec3d_packed_plain(x, packed, diag, unknown, tk)
    assert out.dtype == torch.float32 and torch.equal(out, twin)
    assert float(twin.abs().max()) > 0.0
    assert not out[~unknown].any()
    # the wrapper on CPU tensors walks the packed form too, and launches
    # nothing
    before = kernels.launch_counts()
    assert torch.equal(kernels.matvec3d(x, packed, diag, unknown, tk), twin)
    assert kernels.launch_counts() == before


def test_pack_does_not_depend_on_the_slot_chunks(monkeypatch):
    tk, W, _, unknown, _ = _inputs("synthetic", seed=5)
    whole = kernels.pack_stencil(W, unknown, tk)
    monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS", 14 * unknown.numel())
    assert len(tk.slot_chunks(2 * unknown.numel())) == 26
    chunked = kernels.pack_stencil(W, unknown, tk)
    fields = ("count", "slice_ptr", "slots", "values")
    for f in fields:
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f
    assert whole.nnz == chunked.nnz
    assert whole.nbytes() == sum(
        getattr(whole, f).numel() * getattr(whole, f).element_size()
        for f in fields)


def test_zero_weights_do_not_spread_inf():
    """The dense twin multiplies a zero weight by an inf neighbour (nan);
    the packed walk skips the term."""
    tk, W, diag, unknown, x = _inputs("synthetic", seed=6)
    row = 6 * SLICE + 40
    unknown.view(-1)[row] = True
    W.view(tk.S, -1)[:, row] = 0.0
    x = x.clone()
    x.view(-1)[row + 1] = float("inf")
    diag.view(-1)[row + 1] = 0.0
    packed = kernels.pack_stencil(W, unknown, tk)
    out = kernels.matvec3d_packed_plain(x, packed, diag, unknown, tk)
    twin = kernels.matvec3d_plain(x, W, diag, unknown, tk)
    assert torch.isfinite(out.view(-1)[row]) and torch.isnan(twin.view(-1)[row])


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_packed_operator_matches_jax_matvec(weights):
    jk, js, tk, ts = _setup(seed=2)
    jop = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    W = torch.tensor(np.asarray(jop.W))
    diag = torch.tensor(np.asarray(jop.diag))
    unknown = torch.tensor(np.asarray(jop.unknown))
    if weights == "bf16":
        jop = j_ai.ImplicitOperator(
            W=jop.W.astype(jnp.bfloat16).astype(jnp.float32), diag=jop.diag,
            unknown=jop.unknown)
    x = np.random.default_rng(2).random(jk.shape).astype(np.float32)
    ref = jax.jit(lambda o, v: j_ai.matvec_M(o, jk, v))(jop, jnp.asarray(x))
    packed = kernels.pack_stencil(W, unknown, tk).to(DTYPES[weights])
    # about half of the liquid-liquid bonds carry an exact zero
    assert 0.2 < packed.nnz / float((unknown.sum() * tk.S)) < 0.9
    out = kernels.matvec3d(torch.tensor(x), packed, diag, unknown, tk)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(out.numpy().astype(np.float64), ref,
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_operator_carries_the_packed_form_only_on_the_card():
    """On the CPU assemble keeps the dense bf16 copy and packs nothing;
    handing matvec_M a packed form there walks it, with the same bits."""
    _, _, tk, ts = _setup(seed=4)
    op = t_ai.assemble(ts, tk)
    assert op.packed is None and op.W16.dtype == torch.bfloat16
    packed = kernels.pack_stencil(op.W, op.unknown, tk)
    x = ts.C
    assert torch.equal(t_ai.matvec_M(op, tk, x, packed),
                       t_ai.matvec_M(op, tk, x))
    assert torch.equal(t_ai.matvec_M(op, tk, x, packed.to(torch.bfloat16)),
                       t_ai.matvec_M(op, tk, x, op.W16))
    carried = dataclasses.replace(op, packed=packed,
                                  W16=packed.to(torch.bfloat16))
    s_dense, r_dense = implicit_step(t_ai.linear_system, ts, op, tk, 60.0)
    s_packed, r_packed = implicit_step(t_ai.linear_system, ts, carried, tk,
                                       60.0)
    assert r_dense == r_packed and torch.equal(s_dense.C, s_packed.C)
    # a float64 x goes to the dense weights
    assert t_ai.matvec_M(carried, tk, x.double()).dtype == torch.float64


# ---------------------------------------------------------------------------
# the pitched Krylov basis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 8303, 196_749])
def test_pitched_basis_layout(n):
    V = kernels.pitched_basis(5, n, torch.float32, "cpu")
    assert V.shape == (5, n) and V.stride(1) == 1
    assert V.stride(0) % 32 == 0 and n <= V.stride(0) < n + 32
    assert V[3].is_contiguous() and V[3].view(-1).shape == (n,)
    assert V[3].data_ptr() - V[0].data_ptr() == 3 * 4 * V.stride(0)


@pytest.mark.parametrize("k", [1, 9])
def test_basis_twins_on_pitched_views_match_pallas(k):
    """tests/test_pallas_interpret.py's basis-kernel shapes and tolerances,
    with the port's basis as rows of a pitched allocation."""
    rng = np.random.default_rng(3 + k)
    R, L = pk._BR_GB * 2, 128
    V2 = jnp.asarray(rng.normal(size=(k, R, L)), jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(1, R, L)), jnp.float32)
    c = jnp.asarray(rng.normal(size=k), jnp.float64)
    pk.INTERPRET = True
    try:
        dots_ref = pk.basis_dots_pallas(V2, w2, jnp.float64)
        axpy_ref = pk.basis_axpy_pallas(c, V2, w2)
    finally:
        pk.INTERPRET = False
    n = R * L - 5   # an odd length: the rows of a flat basis are unaligned
    flat = torch.tensor(np.asarray(V2)).reshape(k, -1)[:, :n].contiguous()
    V = kernels.pitched_basis(k + 2, n, torch.float32, "cpu")[:k]
    V.copy_(flat)
    assert not V.is_contiguous() or k == 1
    w = torch.tensor(np.asarray(w2)).reshape(-1)[:n].contiguous()
    ct = torch.tensor(np.asarray(c))
    for fn_dots, fn_axpy in ((kernels.basis_dots, kernels.basis_axpy),
                             (kernels.basis_dots_plain,
                              kernels.basis_axpy_plain)):
        assert torch.equal(fn_dots(V, w), kernels.basis_dots_plain(flat, w))
        assert torch.equal(fn_axpy(ct, V, w),
                           kernels.basis_axpy_plain(ct, flat, w))
        assert torch.equal(fn_axpy(ct, V), kernels.basis_axpy_plain(ct, flat))
    # against the Pallas kernels on the whole (R, L) vectors
    Vw = kernels.pitched_basis(k, R * L, torch.float32, "cpu")
    Vw.copy_(torch.tensor(np.asarray(V2)).reshape(k, -1))
    ww = torch.tensor(np.asarray(w2)).reshape(-1)
    np.testing.assert_allclose(kernels.basis_dots(Vw, ww).numpy(),
                               np.asarray(dots_ref), rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(kernels.basis_axpy(ct, Vw, ww).numpy(),
                               np.asarray(axpy_ref).reshape(-1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flat", [False, True])
def test_gmres_bits_do_not_depend_on_the_pitch(flat, monkeypatch):
    rng = np.random.default_rng(11)
    n = 97   # odd: the pitched rows are 128 floats apart
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = torch.tensor((Q @ np.diag(np.linspace(1.0, 60.0, n)) @ Q.T),
                     dtype=torch.float32)
    b = torch.tensor(rng.normal(size=n), dtype=torch.float32)

    def solve():
        return t_gmres.gmres(lambda v: A @ v, b, torch.zeros(n), tol=1e-5,
                             restart=12, maxiter=120, flat_kernels=flat)

    strides = []
    real = t_gmres.pitched_basis

    def spy(*a):
        V = real(*a)
        strides.append(V.stride(0))
        return V

    monkeypatch.setattr(t_gmres, "pitched_basis", spy)
    x_pitched, (res, cycles) = solve()
    monkeypatch.setattr(
        t_gmres, "pitched_basis",
        lambda rows, m, dtype, device: torch.empty((rows, m), dtype=dtype,
                                                   device=device))
    x_flat, (res_flat, cycles_flat) = solve()
    assert strides == [128] and cycles > 1 and res < 1e-5
    assert torch.equal(x_pitched, x_flat)
    assert (res, cycles) == (res_flat, cycles_flat)
