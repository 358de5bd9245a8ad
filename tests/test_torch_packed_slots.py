"""The f64 slot sum of the refinement residual over the packed f32 weights
(``kernels.slots3d_f64_packed_plain``: the CUDA kernel's walk of
``pack_stencil``'s layout, in PyTorch), on the CPU; the kernel itself runs
only on a card (tests/test_torch_cuda.py).

Grid: the 8,303-node 3D grid of tests/test_pallas_interpret.py (S = 178)
with the JAX package's assembled f32 operator. The packed walk is held to
the dense twin ``slots3d_f64_plain`` bit for bit (x of both signs with exact
zeros; the stencil walked in slot chunks of 7 or in one), to the exact f64
slot sum within 1e-14 and to the JAX package's double-single Pallas kernel
(``matvec_slots_pallas_3d_ds`` in the interpreter, hi + lo) within 1e-10, as
tests/test_pallas_interpret.py holds that kernel; and the 3D f32 implicit
step with the card's operator layout (packed weights, no dense W) gives the
dense step's bits."""

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
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

GEOMETRY = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "precision=f32"]


def _operator(developed):
    """(JAX kit, JAX operator, port kit, port state, dense f32 W, unknown)
    of the initial state or, ``developed``, a seeded one (developed C,
    perturbed FLUID velocity)."""
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides(GEOMETRY)
    jg = j_build_grid(j)
    jk, tk = j_build_kit(jg, j), t_build_kit(t_build_grid(t), t, device="cpu")
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    if developed:
        rng = np.random.default_rng(17)
        fluid = host["node_type"] == 0
        host["vel"] = np.where(fluid[..., None], host["vel"]
                               + rng.normal(0, 0.05, fluid.shape + (3,)),
                               host["vel"])
        host["C"] = np.where(host["node_type"] == 1, 1.0,
                             0.3 * rng.random(fluid.shape))
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    op = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in host},
                          dtype=tk.dtype, device="cpu")
    return (jk, op, tk, ts, torch.tensor(np.asarray(op.W)),
            torch.tensor(np.asarray(op.unknown)))


@pytest.fixture(scope="module")
def operator():
    return _operator(developed=True)


def _x(shape, seed):
    """float64 x of both signs with about 10 % exact zeros."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape) * (rng.random(shape) > 0.1))


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("chunk_slots", [None, 7])
def test_packed_walk_equals_the_dense_twin_bit_for_bit(operator, chunk_slots,
                                                       monkeypatch):
    _, _, tk, _, W, unknown = operator
    x = _x(tk.shape, 5)
    assert bool((x == 0).any()) and bool((x < 0).any())
    whole = kernels.slots3d_f64_packed_plain(
        x, kernels.pack_stencil(W, unknown, tk), tk)
    if chunk_slots:
        monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS",
                            chunk_slots * unknown.numel())
        assert len(tk.slot_chunks()) == 26
    packed = kernels.pack_stencil(W, unknown, tk)
    out = kernels.slots3d_f64_packed_plain(x, packed, tk)
    twin = kernels.slots3d_f64_plain(x, W, tk)
    assert out.dtype == torch.float64 and out.shape == tk.shape
    assert torch.equal(_bits(out), _bits(twin))
    assert torch.equal(_bits(out), _bits(whole))
    # every row that is not unknown is +0 (assemble masks W to the unknown
    # rows), and the unknown rows did sum something
    assert torch.equal(_bits(out[~unknown]), torch.zeros(int((~unknown).sum()),
                                                         dtype=torch.int64))
    assert float(out[unknown].abs().max()) > 0.0


def test_packed_walk_matches_the_exact_f64_sum(operator):
    """tests/test_pallas_interpret.py's exact f64 slot sum (no diag, no
    mask), on the JAX side, within 1e-14 relative."""
    jk, op, tk, _, W, unknown = operator
    x = _x(tk.shape, 17)
    W64 = np.asarray(op.W, np.float64)
    x_p = jk.pad(jnp.asarray(x.numpy()), 0.0)
    ref = jnp.zeros(jk.shape, jnp.float64)
    for s, _, _, _ in jk.bond_iter():
        ref = ref + jnp.asarray(W64[s]) * jk.shift(x_p, s)
    ref = np.asarray(ref)
    out = kernels.slots3d_f64_packed_plain(
        x, kernels.pack_stencil(W, unknown, tk), tk).numpy()
    assert np.abs(out - ref).max() <= 1e-14 * np.abs(ref).max()


def test_packed_walk_matches_the_double_single_pallas_kernel():
    """The JAX package's double-single slot sum in the Pallas interpreter
    (x split into f32 hi + lo, result hi + lo) within 1e-10 relative, the
    bound tests/test_pallas_interpret.py holds it to against the f64 sum,
    on that test's inputs: the initial state's operator and x uniform in
    [0, 1). (On the developed state's larger weights the double-single
    pairs themselves stray to 4e-9 of the f64 sum at a few nodes.)"""
    jk, op, tk, _, W, unknown = _operator(developed=False)
    x = torch.tensor(np.random.default_rng(17).random(tk.shape))
    x64 = jnp.asarray(x.numpy())
    x_hi = x64.astype(jnp.float32)
    x_lo = (x64 - x_hi.astype(jnp.float64)).astype(jnp.float32)
    jop = j_ai.ImplicitOperator(W=op.W, diag=op.diag, unknown=op.unknown,
                                Wf=pk.flatten_W_3d(op.W, jk))
    pk.INTERPRET = True
    try:
        yh, yl = pk.matvec_slots_pallas_3d_ds(jop, jk, x_hi, x_lo)
    finally:
        pk.INTERPRET = False
    ref = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    out = kernels.slots3d_f64_packed_plain(
        x, kernels.pack_stencil(W, unknown, tk), tk).numpy()
    assert np.abs(out - ref).max() <= 1e-10 * np.abs(ref).max()


def test_implicit_step_with_the_cards_operator_layout(operator):
    """The 3D f32 implicit step on the CPU with the operator as the card
    holds it (packed f32 and bf16 weights, W = None: the refinement's f64
    slot sum reads the packed ones) gives the dense operator's bits."""
    _, _, tk, ts, _, _ = operator
    dense = t_ai.assemble(ts, tk)
    assert dense.W is not None and dense.packed is None
    packed = kernels.pack_stencil(dense.W, dense.unknown, tk)
    card = dataclasses.replace(dense, W=None, packed=packed,
                               W16=packed.to(torch.bfloat16))
    before = kernels.launch_counts()
    s_dense, r_dense = implicit_step(t_ai.linear_system, ts, dense, tk, 60.0)
    s_card, r_card = implicit_step(t_ai.linear_system, ts, card, tk, 60.0)
    assert kernels.launch_counts() == before
    assert r_card == r_dense and r_card < 1e-6
    assert torch.equal(s_card.C, s_dense.C)
    assert not torch.equal(s_card.C, ts.C)


def test_wrapper_takes_either_form_on_the_cpu(operator):
    """On CPU tensors the wrapper runs the plain version of whichever form
    W has and launches nothing; x and W on two devices are refused."""
    _, _, tk, _, W, unknown = operator
    x = _x(tk.shape, 23)
    packed = kernels.pack_stencil(W, unknown, tk)
    before = kernels.launch_counts()
    assert torch.equal(kernels.slots3d_f64(x, packed, tk),
                       kernels.slots3d_f64_packed_plain(x, packed, tk))
    assert torch.equal(kernels.slots3d_f64(x, W, tk),
                       kernels.slots3d_f64_plain(x, W, tk))
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError):
        kernels.slots3d_f64(x.to("meta"), packed, tk)
