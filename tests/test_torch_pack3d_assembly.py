"""pack3d: the packed 3D operator built from the state (no dense W), on
the CPU through its plain twin, against the dense assembly and
pack_stencil byte for byte, and against the JAX package's
``ops.ard_implicit.assemble``.

The state lies on the 8,303-node 3D grid (S = 178) and is made from a
numpy seed: salt-blocked SOLID nodes (FLUID neighbours at C >= C_sat), GB
and precipitate nodes, a volume loss of 0.1 under corrosion_decay_l = 0.5
(a decay factor of 10^-0.2), FLUID velocities large enough that the
per-bond upwind clamp acts, and the same state after a phase change. The
kernels themselves run on the card (tests/test_torch_cuda.py).

Tolerances against the JAX package: float64 to 1e-12 relative (the same
arithmetic; round-off of the order of evaluation only); float32 to 1e-6
relative (8 ulps), as tests/test_torch_3d_implicit.py holds the dense
assembly: XLA on the CPU fuses the bond's products and may evaluate them
in another order, while the port forms each weight by PyTorch's separate
float32 operations, which the kernels repeat bit for bit.
"""

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
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu_torch import (Config, build_grid, build_kit,
                                           initialize_state, kernels,
                                           state_from_numpy)
from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
from pd_mg_pin_corrosion_tpu_torch.grid import (FICTITIOUS, FLUID, INLET,
                                                OUTLET, OUTSIDE)
from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import (SLICE, pack3d,
                                                            pack3d_alloc,
                                                            pack3d_dense)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
from pd_mg_pin_corrosion_tpu_torch.ops.ard import (compute_salt_blocked,
                                                   micro_d_factor)

torch.set_num_threads(2)

GRID3D = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
          "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
          "corrosion_decay_l=0.5"]
VOL_LOSS = 0.1
CASES = ["initial", "phase_change"]
_cache = {}


def _kit(precision):
    if precision not in _cache:
        cfg = Config()
        cfg.apply_overrides([*GRID3D, f"precision={precision}"])
        grid = build_grid(cfg)
        _cache[precision] = (grid, cfg, build_kit(grid, cfg, device="cpu"))
    return _cache[precision]


def _host_state(case):
    """{field: numpy array} of the seeded state (float64 fields)."""
    grid, cfg, kit = _kit("f64")
    st = initialize_state(grid, cfg, dtype=torch.float64, device="cpu")
    h = {f.name: getattr(st, f.name).numpy().copy()
         for f in dataclasses.fields(st)}
    rng = np.random.default_rng(20)
    solid, fluid = h["node_type"] == 1, h["node_type"] == 0
    u = rng.random(solid.shape)
    h["C"] = np.where(solid, 1.0 - 0.9 * u, 0.05 * u)
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95
    h["vel"] = np.where(fluid[..., None], h["vel"] + rng.normal(
        0.0, 0.5, h["vel"].shape), h["vel"])
    h["is_gb"] = solid & (rng.random(solid.shape) < 0.3)
    h["is_precip"] = solid & ~h["is_gb"] & (rng.random(solid.shape) < 0.2)
    if case == "phase_change":
        ts = state_from_numpy(h, dtype=torch.float64, device="cpu")
        changed, n = ops_for(kit).apply_phase_change(ts, kit)
        assert int(n) > 0
        h = {f.name: getattr(changed, f.name).numpy().copy()
             for f in dataclasses.fields(changed)}
    return h


def _state(case, precision):
    dtype = torch.float32 if precision == "f32" else torch.float64
    return state_from_numpy(_host_state(case), dtype=dtype, device="cpu")


def _clamped_bonds(st, kit):
    """Liquid-liquid bonds whose advection weight exceeds their diffusion
    weight: where the upwind clamp acts."""
    fluid = st.node_type == FLUID
    nt = kit.pad(st.node_type, OUTSIDE)
    n = 0
    for s0, s1 in kit.slot_chunks():
        ixi, ixi2, e, vol = kit.coefs(s0, s1)
        NT = kit.neighbors(nt, s0=s0, s1=s1)
        ll = fluid & ((NT == FLUID) | (NT == INLET) | (NT == OUTLET)
                      | (NT == FICTITIOUS))
        w_diff = kit.beta_lap * kit.cfg.D_liquid * ixi2 * vol
        v_dot_e = sum(st.vel[..., d] * e[d] for d in range(3))
        w_adv = kit.alpha / kit.V_H * v_dot_e * ixi * vol
        n += int((ll & (w_adv > w_diff)).sum())
    return n


def _buffers(ref, cap):
    packed = dataclasses.replace(
        ref, count=torch.zeros_like(ref.count),
        slice_ptr=torch.zeros_like(ref.slice_ptr),
        slots=torch.full((cap,), 7, dtype=torch.uint8),
        values=torch.full((cap,), 7.0))
    return packed, dataclasses.replace(
        packed, values=torch.full((cap,), 7.0, dtype=torch.bfloat16))


def _same_pack(packed, packed16, ref, n):
    ref16 = ref.to(torch.bfloat16)
    return (torch.equal(packed.count, ref.count)
            and torch.equal(packed.slice_ptr, ref.slice_ptr)
            and torch.equal(packed.slots[:n], ref.slots)
            and torch.equal(packed.values[:n].view(torch.int32),
                            ref.values.view(torch.int32))
            and torch.equal(packed16.values[:n].view(torch.int16),
                            ref16.values.view(torch.int16)))


@pytest.mark.parametrize("case", CASES)
def test_pack3d_twin_equals_dense_assembly_and_pack_stencil(case):
    """The twin into capacity buffers against ``_dense_operator`` +
    ``pack_stencil`` / ``PackedStencil.to(bfloat16)``: diag, unknown,
    count, slice_ptr, slots, float32 and bfloat16 values byte for byte,
    status (nonzeros, overflow); a capacity one entry short overflows and
    writes no slot or value (diag, unknown, count and slice_ptr are
    written). ``pack3d_alloc`` and the dense yardstick ``pack3d_dense`` on
    the CPU give the same bytes. Launches nothing."""
    _, _, kit = _kit("f32")
    st = _state(case, "f32")
    decay = micro_d_factor(kit.cfg, VOL_LOSS, kit.dtype, kit.device)
    assert float(decay) != 1.0
    assert bool(compute_salt_blocked(st, kit).any())
    assert bool(st.is_gb.any()) and bool(st.is_precip.any())
    assert _clamped_bonds(st, kit) > 0
    before = kernels.launch_counts()
    W, diag, unknown = ai._dense_operator(st, kit, VOL_LOSS)
    ref = kernels.pack_stencil(W, unknown, kit)
    n = ref.values.numel()
    for cap in (n + 5 * SLICE, n - 1):
        packed, packed16 = _buffers(ref, cap)
        status = torch.zeros(2, dtype=torch.int64)
        d, u = torch.full_like(diag, 7.0), torch.zeros_like(unknown)
        pack3d(st, decay, kit, d, u, packed, packed16, status)
        assert torch.equal(d.view(torch.int32), diag.view(torch.int32))
        assert torch.equal(u, unknown)
        assert torch.equal(packed.count, ref.count)
        assert torch.equal(packed.slice_ptr, ref.slice_ptr)
        assert status.tolist() == [ref.nnz, int(cap < n)]
        if cap < n:
            assert bool((packed.slots == 7).all())
            assert bool((packed.values == 7.0).all())
            assert bool((packed16.values == 7.0).all())
            continue
        assert _same_pack(packed, packed16, ref, n)
        assert bool((packed.slots[n:] == 7).all())
    a_diag, a_unknown, a_packed, a_packed16 = pack3d_alloc(st, decay, kit)
    assert torch.equal(a_diag.view(torch.int32), diag.view(torch.int32))
    assert torch.equal(a_unknown, unknown) and a_packed.nnz == ref.nnz
    assert _same_pack(a_packed, a_packed16, ref, n)
    packed, packed16 = _buffers(ref, n)
    status = torch.zeros(2, dtype=torch.int64)
    pack3d_dense(W, unknown, kit, packed, packed16, status)
    assert _same_pack(packed, packed16, ref, n)
    assert status.tolist() == [ref.nnz, 0]
    assert kernels.launch_counts() == before


_jax = {}


def _jax_operator(case, precision):
    """The JAX package's assemble of the same state (W, diag, unknown)."""
    j = JConfig()
    j.apply_overrides([*GRID3D, f"precision={precision}"])
    if precision not in _jax:
        jg = j_build_grid(j)
        jk = j_build_kit(jg, j)
        _jax[precision] = (jg, jk, jax.jit(
            lambda s: j_ai.assemble(s, jk, VOL_LOSS)))
    jg, jk, fn = _jax[precision]
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    h = _host_state(case)
    js = type(js)(**{f.name: jnp.asarray(h[f.name], getattr(js, f.name).dtype)
                     for f in dataclasses.fields(js)})
    op = fn(js)
    return (np.asarray(op.W, np.float64), np.asarray(op.diag, np.float64),
            np.asarray(op.unknown))


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("f32", 1e-6)])
@pytest.mark.parametrize("case", CASES)
def test_packed_operator_matches_jax_assemble(case, precision, tol):
    """The packed operator unpacked to a dense W, its diag and unknown
    against the JAX package's assemble on the same inputs: float32 the
    twin of pack3d (the card's route), float64 the port's assemble packed
    by pack_stencil (the route of a card's float64 operator is dense; the
    packing holds any dtype)."""
    _, _, kit = _kit(precision)
    st = _state(case, precision)
    if precision == "f32":
        decay = micro_d_factor(kit.cfg, VOL_LOSS, kit.dtype, kit.device)
        ref = ai._dense_operator(st, kit, VOL_LOSS)
        probe = kernels.pack_stencil(ref[0], ref[2], kit)
        packed, packed16 = _buffers(probe, probe.values.numel())
        diag = torch.empty(kit.shape)
        unknown = torch.empty(kit.shape, dtype=torch.bool)
        pack3d(st, decay, kit, diag, unknown, packed, packed16,
               torch.zeros(2, dtype=torch.int64))
    else:
        op = ai.assemble(st, kit, VOL_LOSS)
        packed = kernels.pack_stencil(op.W, op.unknown, kit)
        diag, unknown = op.diag, op.unknown
    W = kernels.unpack_stencil(packed, kit)
    jW, jdiag, junknown = _jax_operator(case, precision)
    np.testing.assert_array_equal(unknown.numpy(), junknown)
    _close(W.numpy(), jW, tol)
    _close(diag.numpy(), jdiag, tol)
