"""The port's CUDA kernels against their plain PyTorch twins, on the card
(2D kernels on tests/golden/parity.cfg, 3D kernels on a small 3D grid).

Marked ``cuda``: every test here needs an NVIDIA GPU and skips without
one (this decision is taken inside the fixture, never at import). Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports JAX, which that machine need not have); the
first test builds the kernels with nvcc.

The kernels are compiled without FMA contraction, so each one must equal
its plain twin on the same inputs bit for bit; the tolerance checks below
are the ones chip_smoke.py states, the exact checks are this file's own.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu_torch import (Config, build_grid, build_kit,
                                           grains, initialize_state, kernels)
from pd_mg_pin_corrosion_tpu_torch.ops import ard as ard_ops
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
from pd_mg_pin_corrosion_tpu_torch.ops import ns
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

pytestmark = pytest.mark.cuda

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    cfg = Config.load(PARITY)
    cfg.precision = "f32"
    cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    state = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(0)
    fluid = state.node_type == 0
    noise = torch.tensor(rng.normal(0, 0.01, state.vel.shape),
                         dtype=torch.float32, device="cuda")
    state.vel = torch.where(fluid[..., None], state.vel + noise, state.vel)
    state.C = torch.tensor(rng.random(kit.shape), dtype=torch.float32,
                           device="cuda")
    return kit, state


def test_ns2d_equals_plain(setup):
    kit, st = setup
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    n0 = kernels.ns2d.launches
    r1, v1 = kernels.ns2d(*args)
    r2, v2 = kernels.ns2d(*args)
    rp, vp = kernels.ns2d_plain(*args)
    assert kernels.ns2d.launches == n0 + 2
    assert torch.equal(r1, r2) and torch.equal(v1, v2)
    torch.testing.assert_close(r1, rp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(v1, vp, rtol=1e-5, atol=1e-9)
    assert torch.equal(r1, rp) and torch.equal(v1, vp)


def _ns2d_case(cfg, seed, outside_patch):
    """(args of ns2d, kit) on cfg's grid: FLUID rho and vel perturbed from
    ``seed``; with ``outside_patch`` a block of nodes across the tube set
    OUTSIDE (finite values: the twin multiplies them by 0)."""
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    st = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(seed)
    fluid = st.node_type == 0
    rho = torch.where(fluid, st.rho + torch.tensor(
        rng.normal(0, 0.01, kit.shape), dtype=torch.float32, device="cuda"),
        st.rho)
    vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.02 * cfg.U_in, st.vel.shape), dtype=torch.float32,
        device="cuda"), st.vel)
    nt = st.node_type.clone()
    if outside_patch:
        ny, nx = kit.shape
        nt[ny // 3:ny // 3 + 7, nx // 4:nx // 2] = 5
    p = ns.tait_pressure(rho, kit)
    dt = ns.compute_dt(dataclasses.replace(st, rho=rho, vel=vel), kit)
    return (rho, vel, p, nt, dt, kit), kit


@pytest.mark.parametrize("case", ["fine_calibration", "parity_outside"])
def test_ns2d_bit_equal_on_grids_that_are_no_multiple_of_its_tile(case):
    """The fine-calibration grid (567 x 347) and parity.cfg (51 x 39) with
    a block of OUTSIDE nodes: neither is a multiple of the tile. Equal to
    the twin and to the staged walk in PyTorch bit for bit, every node."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    if case == "fine_calibration":
        cfg = Config.load(os.path.join(os.path.dirname(PARITY), "..", "..",
                                       "config",
                                       "params_fine_calibration.cfg"))
    else:
        cfg = Config.load(PARITY)
        cfg.precision = "f32"
        cfg.compute_derived()
    args, kit = _ns2d_case(cfg, 13, case == "parity_outside")
    geo = kernels.ns2d_geometry()
    assert any(n % t for n, t in zip(kit.shape, (geo.ty, geo.tx)))
    assert (case == "parity_outside") == bool((args[3] == 5).any())
    r1, v1 = kernels.ns2d(*args)
    r2, v2 = kernels.ns2d(*args)
    rp, vp = kernels.ns2d_plain(*args)
    rs, vs = kernels.ns2d_staged_plain(*args, R=geo.r)
    assert bool(torch.isfinite(r1).all()) and bool(torch.isfinite(v1).all())
    for a, b in ((r1, r2), (v1, v2), (r1, rp), (v1, vp), (r1, rs), (v1, vs)):
        assert torch.equal(_bits(a), _bits(b))


def test_matvec2d_equals_plain(setup):
    kit, st = setup
    op = ai.assemble(st, kit)
    x = torch.tensor(np.random.default_rng(5).random(kit.shape),
                     dtype=torch.float32, device="cuda")
    y = kernels.matvec2d(x, op.W, op.diag, op.unknown, kit)
    yp = kernels.matvec2d_plain(x, op.W, op.diag, op.unknown, kit)
    assert (y - yp).abs().max() <= 1e-5 * yp.abs().max()
    assert torch.equal(y, yp)
    assert torch.equal(y, kernels.matvec2d(x, op.W, op.diag, op.unknown, kit))


@pytest.mark.parametrize("k", [1, 9, 26, 40])
def test_basis_kernels_equal_plain(setup, k):
    rng = np.random.default_rng(k)
    n = 196_749
    V = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32, device="cuda")
    w = torch.tensor(rng.normal(size=n), dtype=torch.float32, device="cuda")
    c = torch.tensor(rng.normal(size=k), dtype=torch.float64, device="cuda")
    d1, d2 = kernels.basis_dots(V, w), kernels.basis_dots(V, w)
    assert torch.equal(d1, d2)
    torch.testing.assert_close(d1, kernels.basis_dots_plain(V, w),
                               rtol=2e-6, atol=0.0)
    a = kernels.basis_axpy(c, V, w)
    assert torch.equal(a, kernels.basis_axpy_plain(c, V, w))
    assert torch.equal(kernels.basis_axpy(c, V),
                       kernels.basis_axpy_plain(c, V))


@pytest.mark.parametrize("layout", ["pitched", "contiguous"])
@pytest.mark.parametrize("n", [196_749, 196_748, 1_055_668, 3])
@pytest.mark.parametrize("k", [1, 2, 13, 26])
def test_basis_axpy_equals_plain(setup, k, n, layout):
    """Bit for bit for N odd and N a multiple of 4, rows on 128-byte lines
    (16-byte loads) and back to back (scalar loads when N is odd), with and
    without w, float64 c rounded inside the kernel; dots on the same
    views."""
    rng = np.random.default_rng(k + n)
    flat = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32,
                        device="cuda")
    if layout == "pitched":
        V = kernels.pitched_basis(k + 1, n, torch.float32, "cuda")[:k]
        V.copy_(flat)
        assert V.stride(0) % 32 == 0
    else:
        V = flat
    w = torch.tensor(rng.normal(size=n), dtype=torch.float32, device="cuda")
    c = torch.tensor(rng.normal(size=k), dtype=torch.float64, device="cuda")
    n0 = kernels.basis_axpy.launches
    a1, a2 = kernels.basis_axpy(c, V, w), kernels.basis_axpy(c, V, w)
    assert kernels.basis_axpy.launches == n0 + 2
    assert torch.equal(a1, a2)
    assert torch.equal(a1, kernels.basis_axpy_plain(c, flat, w))
    assert torch.equal(kernels.basis_axpy(c, V),
                       kernels.basis_axpy_plain(c, flat))
    # a float32 c widens exactly, so it gives the bits of its float64 copy
    assert torch.equal(kernels.basis_axpy(c.float(), V, w),
                       kernels.basis_axpy_plain(c.float(), flat, w))
    # an unaligned w takes the scalar form
    w1 = torch.cat([w[:1], w])[1:]
    assert torch.equal(kernels.basis_axpy(c, V, w1), a1)
    d = kernels.basis_dots(V, w)
    assert torch.equal(d, kernels.basis_dots(flat, w))
    torch.testing.assert_close(d, kernels.basis_dots_plain(flat, w),
                               rtol=2e-6, atol=1e-9)
    if k > 1:   # rows that are not contiguous are refused
        with pytest.raises(ValueError):
            kernels.basis_axpy(c, flat.T.contiguous().T, w)


@pytest.mark.parametrize("n", [196_749, 1_055_668, 1027, 8, 3])
def test_basis_dots_is_one_deterministic_launch(setup, n):
    """k = 1 ... 26 one after the other on one scratch and ticket (the last
    block sets the ticket back): each call is one counted launch, equals
    the kernel's order of sums taken in PyTorch bit for bit and the plain
    f64 sum to rtol 2e-6; a basis whose rows are back to back (odd pitch:
    the scalar form) and an unaligned w give the bits of the 16-byte form;
    the self-dot equals the dot of a vector with its copy."""
    rng = np.random.default_rng(n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flat = torch.tensor(rng.normal(size=(26, n)), dtype=torch.float32,
                        device="cuda")
    V = kernels.pitched_basis(26, n, torch.float32, "cuda")
    V.copy_(flat)
    w = torch.tensor(rng.normal(size=n), dtype=torch.float32, device="cuda")
    w1 = torch.cat([w[:1], w])[1:]
    assert w1.data_ptr() % 16 != 0
    for k in range(1, 27):
        n0 = kernels.basis_dots.launches
        d = kernels.basis_dots(V[:k], w)
        assert kernels.basis_dots.launches == n0 + 1
        assert torch.equal(d, kernels.basis_dots(V[:k], w))
        assert torch.equal(d, kernels.basis_dots_walk_plain(V[:k], w, sms))
        torch.testing.assert_close(d, kernels.basis_dots_plain(flat[:k], w),
                                   rtol=2e-6, atol=1e-9)
        assert torch.equal(d, kernels.basis_dots(flat[:k], w))
        assert torch.equal(d, kernels.basis_dots(V[:k], w1))
    norm = kernels.basis_dots(w[None], w)
    assert torch.equal(norm, kernels.basis_dots(w.clone()[None], w))
    assert torch.equal(norm, kernels.basis_dots(w1[None], w1))
    torch.testing.assert_close(norm, kernels.basis_dots_plain(w[None], w),
                               rtol=2e-6, atol=0.0)


def test_ard2d_equals_plain(setup):
    kit, st = setup
    # FLUID C uniform in [0, 1): some FLUID neighbours of the wire reach
    # C_sat and salt-block their solid neighbours
    C = torch.where(st.node_type == 1, 1.0, st.C)
    salt = ard_ops.compute_salt_blocked(dataclasses.replace(st, C=C), kit)
    assert bool(salt.any())
    Ds = ard_ops.solid_diffusivity(st.is_gb, st.is_precip, kit.cfg,
                                   ard_ops.micro_d_factor(kit.cfg, 0.1,
                                                          kit.dtype, "cuda"))
    args = (C, st.vel, ns.vel_magnitude(st.vel), st.node_type, Ds, salt,
            2e-6, kit)
    n0 = kernels.ard2d.launches
    c1, c2 = kernels.ard2d(*args), kernels.ard2d(*args)
    cp = kernels.ard2d_plain(*args)
    assert kernels.ard2d.launches == n0 + 2
    assert torch.equal(c1, c2)
    assert torch.equal(c1, cp)
    # the staged walk in PyTorch at the compiled tile
    geo = kernels.ard2d_geometry()
    cs = kernels.ard2d_staged_plain(*args, R=geo.r, tile=(geo.ty, geo.tx))
    assert torch.equal(c1, cs)


@pytest.mark.parametrize("case", ["fine_calibration", "parity_outside"])
def test_ard2d_bit_equal_at_the_fine_calibration_shape(case):
    """ard2d at the explicit path's shape (567 x 347, grains, a seeded C
    that salt-blocks some SOLID nodes) and on parity.cfg with a block of
    OUTSIDE nodes: two launches and the twin give the same bits, every
    node."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    if case == "fine_calibration":
        cfg = Config.load(os.path.join(os.path.dirname(PARITY), "..", "..",
                                       "config",
                                       "params_fine_calibration.cfg"))
    else:
        cfg = Config.load(PARITY)
        cfg.precision = "f32"
        cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    st = initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                          device="cuda")
    rng = np.random.default_rng(17)
    fluid, solid = st.node_type == 0, st.node_type == 1

    def uniform():
        return torch.tensor(rng.random(kit.shape), dtype=torch.float32,
                            device="cuda")
    st.C = torch.where(solid, 1.0 - 0.2 * uniform(),
                       torch.where(fluid, uniform(), 0.0))
    st.vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.02 * cfg.U_in, st.vel.shape), dtype=torch.float32,
        device="cuda"), st.vel)
    if case == "parity_outside":
        ny, nx = kit.shape
        nt = st.node_type.clone()
        nt[ny // 3:ny // 3 + 7, nx // 4:nx // 2] = 5
        st = dataclasses.replace(st, node_type=nt)
    salt = ard_ops.compute_salt_blocked(st, kit)
    assert 0 < int(salt.sum()) < int(solid.sum())
    Ds = ard_ops.solid_diffusivity(st.is_gb, st.is_precip, kit.cfg,
                                   ard_ops.micro_d_factor(kit.cfg, 0.05,
                                                          kit.dtype, "cuda"))
    args = (st.C, st.vel, ns.vel_magnitude(st.vel), st.node_type, Ds, salt,
            float(ard_ops.compute_dt(st, kit)), kit)
    c1, c2 = kernels.ard2d(*args), kernels.ard2d(*args)
    cp = kernels.ard2d_plain(*args)
    assert bool(torch.isfinite(c1).all())
    assert torch.equal(_bits(c1), _bits(c2))
    assert torch.equal(_bits(c1), _bits(cp))


def test_f64_on_cuda_is_refused(setup):
    kit, st = setup
    x = torch.zeros(kit.shape, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        kernels.basis_dots(x.reshape(1, -1), x.reshape(-1))


def _cfg3d():
    """The small 3D grid of tests/test_pallas_interpret.py (8,303 nodes,
    S = 178), f32."""
    cfg = Config()
    cfg.apply_overrides(["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
                         "R_tube=48e-6", "L_upstream=32e-6",
                         "L_downstream=32e-6", "precision=f32"])
    return cfg


@pytest.fixture(scope="module")
def setup3d():
    """_cfg3d()'s kit on the card, with a seeded State."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    cfg = _cfg3d()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    state = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(3)
    fluid = state.node_type == 0
    noise = torch.tensor(rng.normal(0, 0.05, state.vel.shape),
                         dtype=torch.float32, device="cuda")
    state.vel = torch.where(fluid[..., None], state.vel + noise, state.vel)
    state.C = torch.where(state.node_type == 1, 1.0, torch.tensor(
        0.3 * rng.random(kit.shape), dtype=torch.float32, device="cuda"))
    return kit, state


def test_ns3d_equals_plain(setup3d):
    kit, st = setup3d
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    n0 = kernels.ns3d.launches
    r1, v1 = kernels.ns3d(*args)
    r2, v2 = kernels.ns3d(*args)
    rp, vp = kernels.ns3d_plain(*args)
    assert kernels.ns3d.launches == n0 + 2
    assert torch.equal(r1, r2) and torch.equal(v1, v2)
    torch.testing.assert_close(r1, rp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(v1, vp, rtol=1e-4, atol=1e-9)
    assert torch.equal(r1, rp) and torch.equal(v1, vp)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("extra", [(), ("R_tube=56e-6", "L_upstream=40e-6")],
                         ids=["23x19x19", "24x21x21"])
def test_ns3d_on_grids_that_are_no_multiple_of_its_tile(extra):
    """Bit-equality with the twin on grids whose sides are not multiples of
    the kernel's tile, with a nan in every OUTSIDE node's fields: it is
    dropped from the neighbours' sums and copied through in its own node."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    cfg = _cfg3d()
    cfg.apply_overrides(list(extra))
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    geo = kernels.ns3d_geometry()
    assert any(n % t for n, t in zip(kit.shape, (geo.tz, geo.ty, geo.tx)))
    st = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(11)
    fluid = st.node_type == 0
    outside = st.node_type == 5
    assert bool(outside.any())
    rho = torch.where(fluid, st.rho + torch.tensor(
        rng.normal(0, 0.1, kit.shape), dtype=torch.float32, device="cuda"),
        st.rho)
    vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.05, st.vel.shape), dtype=torch.float32,
        device="cuda"), st.vel)
    p = ns.tait_pressure(rho, kit)
    dt = ns.compute_dt(dataclasses.replace(st, rho=rho, vel=vel), kit)
    nan = float("nan")
    rho = torch.where(outside, nan, rho)
    vel = torch.where(outside[..., None], nan, vel)
    p = torch.where(outside, nan, p)
    args = (rho, vel, p, st.node_type, dt, kit)
    r1, v1 = kernels.ns3d(*args)
    r2, v2 = kernels.ns3d(*args)
    rp, vp = kernels.ns3d_plain(*args)
    rs, vs = kernels.ns3d_staged_plain(*args, R=geo.r)
    assert bool(torch.isfinite(r1[~outside]).all())
    assert bool(torch.isfinite(v1[~outside]).all())
    assert bool(torch.isnan(r1[outside]).all())
    for a, b in ((r1, r2), (v1, v2), (r1, rp), (v1, vp), (r1, rs), (v1, vs)):
        assert torch.equal(_bits(a), _bits(b))


def _dense_W(st, kit):
    """The dense f32 weights of st's operator, for the twins: the card's
    operator keeps only the packed ones."""
    return ai._dense_operator(st, kit, 0.0)[0]


def _matvec3d_against_twin(kit, op, W, weights, seed):
    """The packed kernel against the dense twin on W (the operator's dense
    weights, made for the check; its bf16 weights a copy made here)."""
    assert op.W is None and op.packed.dtype == torch.float32
    assert op.W16.dtype == torch.bfloat16
    assert op.W16.slots is op.packed.slots
    packed = op.packed if weights == torch.float32 else op.W16
    x = torch.tensor(np.random.default_rng(seed).random(kit.shape),
                     dtype=torch.float32, device="cuda")
    counter = "launches" if weights == torch.float32 else "launches_bf16"
    n0 = getattr(kernels.matvec3d, counter)
    y = kernels.matvec3d(x, packed, op.diag, op.unknown, kit)
    assert getattr(kernels.matvec3d, counter) == n0 + 1
    yp = kernels.matvec3d_plain(x, W.to(weights), op.diag, op.unknown, kit)
    assert (y - yp).abs().max() <= 1e-5 * yp.abs().max()
    assert torch.equal(y, yp)
    assert torch.equal(y, kernels.matvec3d(x, packed, op.diag, op.unknown,
                                           kit))
    assert torch.equal(y, ai.matvec_M(op, kit, x, None if weights
                                      == torch.float32 else op.W16))


@pytest.mark.parametrize("weights", [torch.float32, torch.bfloat16])
def test_matvec3d_equals_plain(setup3d, weights):
    kit, st = setup3d
    op, W = ai.assemble(st, kit), _dense_W(st, kit)
    _matvec3d_against_twin(kit, op, W, weights, 5)
    # (assemble gives bonds that leave the grid a zero weight)
    assert torch.equal(kernels.unpack_stencil(op.packed, kit),
                       torch.where(op.unknown, W, 0.0))
    # dense weights are refused on the card
    x = torch.zeros(kit.shape, device="cuda")
    with pytest.raises(TypeError):
        kernels.matvec3d(x, W, op.diag, op.unknown, kit)


@pytest.fixture(scope="module")
def flagship():
    """config/params_3d.cfg (1,055,668 nodes, S = 178) on the card, seeded
    velocity: (kit, its assembled operator, the dense f32 weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    cfg = Config.load(os.path.join(os.path.dirname(PARITY), "..", "..",
                                   "config", "params_3d.cfg"))
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    st = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(7)
    st.vel = torch.where((st.node_type == 0)[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.02 * cfg.U_in, st.vel.shape), dtype=torch.float32,
        device="cuda"), st.vel)
    return kit, ai.assemble(st, kit), _dense_W(st, kit)


@pytest.mark.parametrize("weights", [torch.float32, torch.bfloat16])
def test_matvec3d_equals_plain_at_the_flagship_shape(flagship, weights):
    kit, op, W = flagship
    assert 0.3 < op.packed.nnz / float(op.unknown.sum() * kit.S) < 0.9
    _matvec3d_against_twin(kit, op, W, weights, 8)


def _slots3d_against_twin(kit, op, W, seed):
    """The packed f64 slot sum against the dense twin, an x of both signs
    with exact zeros: bit for bit, one counted launch a call."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=kit.shape) * (rng.random(kit.shape)
                                                   > 0.1),
                     dtype=torch.float64, device="cuda")
    n0 = kernels.slots3d_f64.launches
    y = kernels.slots3d_f64(x, op.packed, kit)
    assert kernels.slots3d_f64.launches == n0 + 1
    yp = kernels.slots3d_f64_plain(x, W, kit)
    assert y.dtype == torch.float64
    assert (y - yp).abs().max() <= 1e-14 * yp.abs().max()
    assert torch.equal(_bits64(y), _bits64(yp))
    assert torch.equal(y, kernels.slots3d_f64(x, op.packed, kit))
    assert not y[~op.unknown].any()
    return x


def _bits64(t):
    return t.contiguous().view(torch.int64)


def test_slots3d_f64_equals_plain(setup3d):
    kit, st = setup3d
    op, W = ai.assemble(st, kit), _dense_W(st, kit)
    x = _slots3d_against_twin(kit, op, W, 6)
    # the kernel takes the packed f32 weights and an f64 x only
    with pytest.raises(TypeError):
        kernels.slots3d_f64(x, W, kit)
    with pytest.raises(TypeError):
        kernels.slots3d_f64(x.float(), op.packed, kit)
    with pytest.raises(TypeError):
        kernels.slots3d_f64(x, op.W16, kit)
    with pytest.raises(TypeError):
        kernels.matvec3d(x.float(), op.packed.to(torch.float64), op.diag,
                         op.unknown, kit)


def test_slots3d_f64_equals_plain_at_the_flagship_shape(flagship):
    kit, op, W = flagship
    _slots3d_against_twin(kit, op, W, 9)


def test_implicit_step_3d_on_the_card(setup3d):
    """The 3D f32 implicit step on CUDA (kernels) against the same step on
    the CPU (plain twins): both solve to the f32 tolerance."""
    kit, st = setup3d
    op = ai.assemble(st, kit)
    assert op.W is None      # every sum of the step reads the packed weights
    n0 = {k: getattr(kernels, k).launches
          for k in ("matvec3d", "slots3d_f64", "basis_dots")}
    s_gpu, res = implicit_step(ai.linear_system, st, op, kit, 60.0)
    assert res < 1e-6
    assert all(getattr(kernels, k).launches > n for k, n in n0.items())
    cfg = _cfg3d()
    cpu_kit = build_kit(build_grid(cfg), cfg, device="cpu")
    cpu_st = type(st)(*(t.cpu() for t in st.tensors()))
    s_cpu, res_cpu = implicit_step(ai.linear_system, cpu_st,
                                   ai.assemble(cpu_st, cpu_kit), cpu_kit,
                                   60.0)
    assert res_cpu < 1e-6
    torch.testing.assert_close(s_gpu.C.cpu(), s_cpu.C, rtol=5e-6, atol=5e-8)


@pytest.mark.parametrize("form", ["xla", "factored", "jconv", "jstat"])
def test_ns3d_chunked_equals_plain(setup3d, form):
    """Each form of csrc/ns3d_chunked.cu against its twin, bit for bit, at
    two launch shapes (the block's z extent does not change the numbers),
    and against ns3d at the script's gate (rel 1e-4)."""
    kit, st = setup3d
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    actconv = (kernels.compute_actconv(kit, st.node_type) if form == "jstat"
               else None)
    for nchunk in (6, 2, 8):
        outs = [_chunked(form, args, actconv, nchunk, bz)
                for bz in (8, 16, 32, 16)]
        twin = _chunked_twin(form, args, actconv, nchunk)
        for r, v in outs:
            assert torch.equal(r, twin[0]) and torch.equal(v, twin[1])
    geo = kernels.ns3d_chunked_geometry(form, 16)
    staged = kernels.ns3d_chunked_staged_plain(
        form, *args, nchunk=8, actconv=actconv, R=geo.r,
        tile=(geo.tz, geo.ty, geo.tx))
    assert torch.equal(staged[0], twin[0]) and torch.equal(staged[1], twin[1])
    r0, v0 = kernels.ns3d(*args)
    assert (outs[0][0] - r0).abs().max() <= 1e-4 * r0.abs().max()
    assert (outs[0][1] - v0).abs().max() <= 1e-4 * v0.abs().max()


def _chunked(form, args, actconv, nchunk, bz):
    if form == "jstat":
        return kernels.ns3d_jstat(*args, actconv, nchunk=nchunk, bz=bz)
    return kernels.ns3d_chunked(*args, nchunk=nchunk, bz=bz,
                                factored=_FACTORED[form])


def _chunked_twin(form, args, actconv, nchunk):
    if form == "jstat":
        return kernels.ns3d_jstat_plain(*args, actconv, nchunk=nchunk)
    return kernels.ns3d_chunked_plain(*args, nchunk=nchunk,
                                      factored=_FACTORED[form])


_FACTORED = {"xla": False, "factored": True, "jconv": "jconv"}


@pytest.fixture(scope="module")
def flagship_flow():
    """config/params_3d.cfg (1,055,668 nodes, S = 178) on the card with
    seeded FLUID rho and vel: the arguments of a 3D NS step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")
    cfg = Config.load(os.path.join(os.path.dirname(PARITY), "..", "..",
                                   "config", "params_3d.cfg"))
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cuda")
    st = initialize_state(grid, cfg, device="cuda")
    rng = np.random.default_rng(11)
    fluid = st.node_type == 0
    st.rho = torch.where(fluid, st.rho + torch.tensor(
        rng.normal(0, 0.01, kit.shape), dtype=torch.float32, device="cuda"),
        st.rho)
    st.vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.02 * cfg.U_in, st.vel.shape), dtype=torch.float32,
        device="cuda"), st.vel)
    p = ns.tait_pressure(st.rho, kit)
    return (st.rho, st.vel, p, st.node_type, ns.compute_dt(st, kit), kit)


@pytest.mark.parametrize("form", ["xla", "factored", "jconv", "jstat"])
def test_ns3d_chunked_equals_plain_at_the_flagship_shape(flagship_flow, form):
    """Each form at the flagship shape and the ladder's rungs: two launches
    and the twin give the same bits, every node."""
    args = flagship_flow
    actconv = (kernels.compute_actconv(args[-1], args[3]) if form == "jstat"
               else None)
    twin = _chunked_twin(form, args, actconv, 6)
    for bz in kernels.BZ_RUNGS:
        r1, v1 = _chunked(form, args, actconv, 6, bz)
        r2, v2 = _chunked(form, args, actconv, 6, bz)
        assert bool(torch.isfinite(r1).all()) and bool(torch.isfinite(v1).all())
        for a, b in ((r1, r2), (v1, v2), (r1, twin[0]), (v1, twin[1])):
            assert torch.equal(_bits(a), _bits(b))


# --- the uniform-grid features without a kernel of their own: gs_parity,
# the coarse warm start, the sub-cell 3D wall mirror and 3D explicit
# transport, on the card against the C++ reference or the CPU path

GOLDEN = os.path.join(os.path.dirname(PARITY), "parity_diagnostics_ref.csv")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none is present")


def test_gs_parity_f64_on_cuda_matches_reference_binary(tmp_path):
    """The whole f64 gs_parity run of parity.cfg on CUDA (ns2d's plain twin
    on the card, the sweeps on the host) against the C++ reference
    binary's diagnostics, with tests/test_parity.py's gates."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch import cli

    solver = cli.run([PARITY, f"output_dir={tmp_path}", "precision=f64",
                      "gs_parity=1", "implicit_output_every=1000000000",
                      "--device", "cuda"])
    assert solver.final_state.C.is_cuda and solver.total_dissolved == 180
    ref = np.atleast_1d(np.genfromtxt(GOLDEN, delimiter=",", names=True))
    ours = np.atleast_1d(np.genfromtxt(f"{tmp_path}/diagnostics.csv",
                                       delimiter=",", names=True))
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6,
                                   err_msg=col)


def test_profile_hook_traces_the_port_kernels(tmp_path):
    """PD_TPU_PROFILE=<dir> on the card: the CLI, run as a user runs it (a
    process of its own), on two steps of parity.cfg writes one Chrome
    trace holding a device record for every kernel launch of the run (a
    process that has run for minutes loses some device records,
    scripts/profiler_windows_torch.py), among them those of the port's
    kernels: ns2d in the flow solve, matvec2d, the basis kernels and
    gmres_qr in the implicit steps (the first step's warm-up runs them
    eagerly), each as many times as its wrapper's launch count
    (``PD_TPU_PHASE_TIMERS=1`` prints them with the trip counters'
    runs). The flow's iterations between checks replay a CUDA graph and
    each later implicit step is one launch of the step loop's graph with
    conditional nodes: a replay or a launch is one launch record
    (cudaGraphLaunch), as many as the run's counters report, each with
    kernel records that carry its correlation id. The launch records made
    while a graph was captured ran no kernel; they are the flow graph's
    kernels (kf) and the kernel nodes the counters report captured, and
    each flow replay holds exactly kf kernel records. The kernel records
    of the launches of graphs with conditional nodes (their top level's
    carry the launch's correlation id; a body's, started by the device's
    own launcher, carry none) are exactly the device operations the trip
    counters report run ("traced": every kernel, copy and fill node of
    each run of its level, and the kernels that set the conditional
    nodes' handles; that launcher runs a copy or a fill as a kernel)."""
    _card()
    import subprocess
    import sys
    from collections import Counter

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prof = tmp_path / "prof"
    run = subprocess.run(
        [sys.executable, "-m", "pd_mg_pin_corrosion_tpu_torch", PARITY,
         "precision=f32", "flow_max_iters=100", "T_final=1.2",
         f"output_dir={tmp_path / 'out'}", "--device", "cuda"],
        cwd=root, env={**os.environ, "PD_TPU_PROFILE": str(prof),
                       "PD_TPU_PHASE_TIMERS": "1"},
        check=True, capture_output=True, text=True)
    # (replays, captures) of the flow's graph; (graph launches, captures,
    # kernel nodes captured, device operations run) of the solve graphs
    # and of the step loop's
    def timer(what, field):
        line = re.search(rf"\[Timer\] {what}: ([^\n]*)", run.stdout).group(1)
        return int(re.search(rf"(\d+) {field}", line).group(1))

    fr, fc = (timer("flow iterations", f) for f in ("graph replays",
                                                    "captures"))
    (gl, gc, gkc, gkt), (sl, sc, skc, skt) = (
        [timer(what, f) for f in ("graph launches", "captures", "captured",
                                  "traced")]
        for what in ("Arnoldi steps", "implicit steps"))
    launches = json.loads(re.search(r"\[Timer\] kernel launches: (\{.*\})",
                                    run.stdout).group(1))
    files = os.listdir(prof)
    assert len(files) == 1
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    launched = sum("LaunchKernel" in e.get("name", "") for e in events)
    fns = {"ns2d": "ns2d_kernel", "matvec2d": "matvec2d_kernel",
           "basis_dots": "dots_kernel", "basis_axpy": "axpy_kernel",
           "gmres_qr": "gmres_qr_kernel"}
    traced = {k: sum(bool(re.search(rf"\b{fn}[<(]", n)) for n in names)
              for k, fn in fns.items()}
    per_corr = Counter(e.get("args", {}).get("correlation")
                       for e in events if e.get("cat") == "kernel")
    runtime = [(e.get("name", ""), e.get("args", {}).get("correlation"))
               for e in events if e.get("cat") == "cuda_runtime"]
    kernel_launches = [c for n, c in runtime if "LaunchKernel" in n]
    replays = [c for n, c in runtime if "GraphLaunch" in n]
    # launch records that ran no kernel: those made during the captures
    captured = sum(c not in per_corr for c in kernel_launches)
    kf = captured - gkc - skc
    per_replay = Counter(per_corr[c] for c in replays)
    # the kernel records of the graphs with conditional nodes: their
    # launches' but the flow's, and those that carry no launch's
    # correlation id
    orphans = per_corr.pop(0, 0) + per_corr.pop(None, 0)
    cond = sum(per_corr[c] for c in replays) - fr * kf + orphans
    print(f"port kernels traced {traced}, launched {launches}; "
          f"{len(names)} kernel records, {launched} launch records "
          f"({captured} without a kernel), {len(replays)} graph launches "
          f"by kernel records {per_replay}; flow graph {fr} replays / {fc} "
          f"captures (kf {kf}), solve graphs {gl} launches / {gc} captures "
          f"/ {gkt} device operations, step graphs {sl} launches / {sc} "
          f"captures / {skt} device operations; their kernel records "
          f"{cond} ({orphans} without a launch's id)")
    assert fr > 0 and sl > 0 and fc == 1 and sc > 0 and kf > 0
    assert len(replays) == fr + gl + sl
    assert all(per_corr[c] > 0 for c in replays)
    assert per_replay[kf] >= fr, (kf, per_replay)
    assert cond == gkt + skt, (cond, gkt, skt)
    assert set(per_corr) <= set(kernel_launches) | set(replays)
    assert all(per_corr[c] == 1 for c in kernel_launches if c in per_corr)
    assert len(names) == launched - captured + fr * kf + cond
    assert all(traced[k] == launches[k] > 0 for k in fns), (traced,
                                                            launches)


def _small3d_on(device, extra=()):
    """(grid, cfg, kit, state) of _cfg3d()'s grid, with ``extra``
    overrides, on ``device``; FLUID velocities and C seeded."""
    cfg = _cfg3d()
    cfg.apply_overrides(list(extra))
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device=device)
    st = initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                          device=device)
    rng = np.random.default_rng(11)
    fluid = st.node_type == 0
    st.vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.05, st.vel.shape), dtype=torch.float32,
        device=device), st.vel)
    st.rho = torch.where(fluid, st.rho + torch.tensor(
        rng.normal(0, 1.0, kit.shape), dtype=torch.float32, device=device),
        st.rho)
    st.C = torch.where(st.node_type == 1, 1.0, torch.tensor(
        0.92 * rng.random(kit.shape), dtype=torch.float32, device=device))
    return grid, cfg, kit, st


def test_warm_start_on_cuda_equals_cpu():
    """coarse_warm_start at dx = 4e-6 (the coarse twin is _cfg3d()'s
    8,303-node grid, solved on ns3d, capped at 200 iterations) on CUDA
    against the CPU path: the same iterations, fields within f32
    tolerance after 200 steps whose BC sums reduce in another order."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch.solvers import coarse_warm_start

    out = {}
    for device in ("cuda", "cpu"):
        cfg = _cfg3d()
        cfg.apply_overrides(["dx=4e-6", "flow_max_iters=200",
                             "flow_warm_start=2"])
        grid = build_grid(cfg)
        kit = build_kit(grid, cfg, device=device)
        st = initialize_state(grid, cfg, device=device)
        n0 = kernels.ns3d.launches
        out[device] = coarse_warm_start(st, grid, kit, cfg) + (
            kernels.ns3d.launches - n0,)
    (g, it_g, ns_g), (c, it_c, ns_c) = out["cuda"], out["cpu"]
    assert it_g == it_c == 201 and ns_g == 200 and ns_c == 0
    for f in ("rho", "vel", "pressure"):
        a, b = getattr(g, f).cpu(), getattr(c, f)
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_subcell_mirror_on_cuda_equals_cpu():
    """apply_wall_bc with wall_mirror_subcell = 1 on CUDA against the CPU:
    the same gathers and the same sums of products, bit for bit."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch import boundary as bc

    outs = [bc.apply_wall_bc(st, kit) for _, _, kit, st in (
        _small3d_on(d, ["wall_mirror_subcell=1"]) for d in ("cuda", "cpu"))]
    assert torch.equal(outs[0].rho.cpu(), outs[1].rho)
    assert torch.equal(outs[0].vel.cpu(), outs[1].vel)


def test_explicit_3d_step_on_cuda_equals_cpu():
    """The 3D explicit step (ops/ard.explicit_step, no kernel) on CUDA
    against the CPU, with salt-blocked SOLID nodes."""
    _card()
    res = {}
    for device in ("cuda", "cpu"):
        _, cfg, kit, st = _small3d_on(device)
        salt = ard_ops.compute_salt_blocked(st, kit)
        n0 = kernels.launch_counts()
        res[device] = (ard_ops.ard_step(st, kit, 2e-6, 0.1).C, int(salt.sum()))
        assert kernels.launch_counts() == n0
    (g, nsalt_g), (c, nsalt_c) = res["cuda"], res["cpu"]
    assert nsalt_g == nsalt_c > 0
    torch.testing.assert_close(g.cpu(), c, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# block AMR: the kernels at the blocks' shapes, and the block ops
# ---------------------------------------------------------------------------

AMR = os.path.join(os.path.dirname(PARITY), "..", "..", "config",
                   "params_amr.cfg")
# tests/test_torch_amr_blocks.py's 3D case: params_3d.cfg at chip_smoke.py's
# SMALL_3D geometry with block AMR (7,655 nodes)
AMR3D = ["dx=8e-6", "R_wire=16e-6", "L_wire=64e-6", "R_tube=48e-6",
         "L_upstream=32e-6", "L_downstream=32e-6", "Q_flow=1.667e-10",
         "use_amr=1", "amr_ratio=2", "amr_buffer=16e-6", "precision=f32"]


def _amr_on(device, path=AMR, extra=(), seed_C=True):
    """(grid, kit, state) of a block-AMR configuration on ``device``: FLUID
    and FICTITIOUS velocities and rho perturbed; with ``seed_C`` C seeded
    (SOLID 1, FLUID up to 0.92: some reach C_sat and salt-block their SOLID
    neighbours), else C as initialized."""
    from pd_mg_pin_corrosion_tpu_torch import amr_blocks as ab

    cfg = Config.load(path)
    cfg.apply_overrides(list(extra))
    grid = ab.build_amr_block_grid(cfg)
    kit = ab.build_bkit(grid, cfg, device=device)
    st = initialize_state(grid, cfg, grains=ab.generate_grains_b(grid, cfg),
                          device=device)
    rng = np.random.default_rng(23)
    moving = (st.node_type == 0) | (st.node_type == 6)

    def seeded(shape, scale):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device=device)
    st.vel = torch.where(moving[..., None],
                         st.vel + seeded(st.vel.shape, 0.05 * cfg.U_in), st.vel)
    st.rho = torch.where(moving, st.rho + seeded(st.rho.shape, 1.0), st.rho)
    if seed_C:
        st.C = torch.where(st.node_type == 1, 1.0, torch.tensor(
            0.92 * rng.random(st.C.shape), dtype=torch.float32,
            device=device))
    return grid, kit, st


@pytest.fixture(scope="module")
def amr():
    _card()
    return _amr_on("cuda")


@pytest.mark.parametrize("block", ["fine", "coarse"])
def test_amr_block_kernels_equal_plain(amr, block):
    """ns2d, matvec2d and ard2d on one block of params_amr.cfg (fine
    208 x 80, coarse 194 x 120; views of the flat state): two launches and
    the twin give the same bits."""
    from pd_mg_pin_corrosion_tpu_torch import amr_blocks as ab

    _, bkit, st = amr
    kit = getattr(bkit, block)
    sb = ab._split_state(bkit, st)[block == "coarse"]
    assert sb.rho.shape == kit.shape and sb.rho.is_contiguous()
    p = ns.tait_pressure(sb.rho, kit)
    args = (sb.rho, sb.vel, p, sb.node_type, ns.compute_dt(sb, kit), kit)
    (r1, v1), (r2, v2) = kernels.ns2d(*args), kernels.ns2d(*args)
    rp, vp = kernels.ns2d_plain(*args)
    for a, b in ((r1, r2), (v1, v2), (r1, rp), (v1, vp)):
        assert torch.equal(_bits(a), _bits(b))

    op = ab._block_operator(sb, kit, 0.05)
    x = torch.tensor(np.random.default_rng(7).random(kit.shape),
                     dtype=torch.float32, device="cuda")
    mv = (x, op.W, op.diag, op.unknown, kit)
    assert op.W.shape == (kit.S,) + kit.shape
    assert torch.equal(kernels.matvec2d(*mv), kernels.matvec2d_plain(*mv))

    salt = ard_ops.compute_salt_blocked(sb, kit)
    Ds = ard_ops.solid_diffusivity(sb.is_gb, sb.is_precip, kit.cfg,
                                   ard_ops.micro_d_factor(kit.cfg, 0.05,
                                                          kit.dtype, "cuda"))
    ard = (sb.C, sb.vel, ns.vel_magnitude(sb.vel), sb.node_type, Ds, salt,
           float(ard_ops.compute_dt(sb, kit)), kit)
    c1, c2 = kernels.ard2d(*ard), kernels.ard2d(*ard)
    assert torch.equal(_bits(c1), _bits(c2))
    assert torch.equal(_bits(c1), _bits(kernels.ard2d_plain(*ard)))


def test_amr_basis_kernels_at_the_flat_length(amr):
    """basis_dots / basis_axpy on GMRES's pitched (26, 39,920) basis."""
    _, bkit, st = amr
    n = st.C.numel()
    assert n == 39_920
    rng = np.random.default_rng(29)
    V = kernels.pitched_basis(26, n, torch.float32, "cuda")
    V.copy_(torch.tensor(rng.normal(0, 1, (26, n)), dtype=torch.float32))
    w = torch.tensor(rng.normal(0, 1, n), dtype=torch.float32, device="cuda")
    c = torch.tensor(rng.normal(0, 1, 26), dtype=torch.float64, device="cuda")
    d = kernels.basis_dots(V, w)
    torch.testing.assert_close(d, kernels.basis_dots_plain(V, w), rtol=2e-6,
                               atol=0.0)
    assert torch.equal(d, kernels.basis_dots(V, w))
    for k in (1, 13, 26):
        assert torch.equal(kernels.basis_axpy(c[:k], V[:k], w),
                           kernels.basis_axpy_plain(c[:k], V[:k], w))


@pytest.mark.parametrize("dim", [2, 3])
def test_amr_flow_and_implicit_step_on_cuda_equal_cpu(dim):
    """One flow iteration (BCs, ns_step, the wall BC, the IDW refresh) and
    one implicit step with its constraint rows on CUDA (the kernels)
    against the CPU (the twins): params_amr.cfg in 2D, the 7,655-node 3D
    block grid in 3D. C as initialized: a seeded C of random gradients
    makes the 30 s step too stiff for GMRES(25) in 200 iterations (the
    JAX package's block step gives the same residual, 7.3, on it)."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch import amr_blocks as ab

    extra = dict(path=os.path.join(os.path.dirname(AMR), "params_3d.cfg"),
                 extra=AMR3D) if dim == 3 else {}
    out = {}
    for device in ("cuda", "cpu"):
        _, kit, st = _amr_on(device, seed_C=False, **extra)
        n0 = kernels.launch_counts()
        dt = ab.compute_dt_ns(st, kit)
        for op in (ab.apply_inlet_bc, ab.apply_outlet_bc, ab.apply_wall_bc):
            st = op(st, kit)
        st = ab.update_fictitious(ab.apply_wall_bc(ab.ns_step(st, kit, dt),
                                                   kit), kit)
        op = ab.assemble(st, kit, 0.05)
        dt_c = ab.compute_adaptive_dt(st, op, kit)
        st2, res = implicit_step(ab.linear_system, st, op, kit, dt_c)
        launched = {k: v - n0[k] for k, v in kernels.launch_counts().items()}
        out[device] = (st, st2, float(dt_c), res, launched)
    (g, g2, dg, rg, lg), (c, c2, dc, rc, lc) = out["cuda"], out["cpu"]
    path = (("ns2d", "matvec2d") if dim == 2
            else ("ns3d", "matvec3d", "slots3d_f64"))
    assert all(lg[k] > 0 for k in path + ("basis_dots", "basis_axpy"))
    assert not any(lc.values())
    assert rg <= 1e-6 and rc <= 1e-6 and dg == pytest.approx(dc, rel=1e-5)
    for a, b in ((g.rho, c.rho), (g.vel, c.vel), (g2.C, c2.C)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the gather AMR backend (plain PyTorch but GMRES's basis kernels) and the
# extrapolated GMRES start
# ---------------------------------------------------------------------------

def _gather_on(device, perturb=True):
    """(grid, kit, state) of params_amr.cfg with amr_backend = gather on
    ``device`` (38,976 nodes, K = 40), as initialized; with ``perturb``
    the FLUID and FICTITIOUS velocities and rho perturbed."""
    from pd_mg_pin_corrosion_tpu_torch import amr, unstructured as u

    cfg = Config.load(AMR)
    cfg.apply_overrides(["amr_backend=gather"])
    grid = amr.build_amr_grid(cfg)
    kit = u.build_ukit(grid, cfg, device=device)
    st = initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                          device=device)
    if not perturb:
        return grid, kit, st
    rng = np.random.default_rng(31)
    moving = (st.node_type == 0) | (st.node_type == 6)

    def seeded(shape, scale):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device=device)
    st.vel = torch.where(moving[..., None],
                         st.vel + seeded(st.vel.shape, 0.05 * cfg.U_in), st.vel)
    st.rho = torch.where(moving, st.rho + seeded(st.rho.shape, 1.0), st.rho)
    return grid, kit, st


def test_gather_basis_kernels_at_the_flat_length():
    """basis_dots / basis_axpy on GMRES's pitched (26, 38,976) basis."""
    _card()
    n = 38_976
    rng = np.random.default_rng(37)
    V = kernels.pitched_basis(26, n, torch.float32, "cuda")
    V.copy_(torch.tensor(rng.normal(0, 1, (26, n)), dtype=torch.float32))
    w = torch.tensor(rng.normal(0, 1, n), dtype=torch.float32, device="cuda")
    c = torch.tensor(rng.normal(0, 1, 26), dtype=torch.float64, device="cuda")
    d = kernels.basis_dots(V, w)
    torch.testing.assert_close(d, kernels.basis_dots_plain(V, w), rtol=2e-6,
                               atol=0.0)
    assert torch.equal(d, kernels.basis_dots(V, w))
    for k in (1, 13, 26):
        assert torch.equal(kernels.basis_axpy(c[:k], V[:k], w),
                           kernels.basis_axpy_plain(c[:k], V[:k], w))


def test_gather_flow_and_implicit_step_on_cuda_equal_cpu():
    """params_amr.cfg with the gather backend: one flow iteration (BCs,
    ns_step, the wall BC, the IDW refresh) on perturbed fields, and two
    implicit steps with their constraint rows, the second from an
    extrapolated start, on CUDA (GMRES on the basis kernels) against the
    CPU (the twins). The steps start from the initialized fields, as the
    CLI's first cycle does: on the perturbed velocities the 30 s step is
    too stiff for GMRES(25) in 200 iterations (residual 4.2e-3 on the
    CPU)."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch import unstructured as u

    out = {}
    for device in ("cuda", "cpu"):
        _, kit, st = _gather_on(device)
        assert kit.N == 38_976 and kit.K == 40
        n0 = kernels.launch_counts()
        dt = u.compute_dt_ns(st, kit)
        for op in (u.apply_inlet_bc, u.apply_outlet_bc, u.apply_wall_bc,
                   u.apply_solid_surface_bc):
            st = op(st, kit)
        st = u.update_fictitious(u.apply_wall_bc(u.ns_step(st, kit, dt),
                                                 kit), kit)
        fields = st
        st = _gather_on(device, perturb=False)[2]
        op = u.assemble(st, kit, 0.05)
        dt_c = u.compute_adaptive_dt(st, op, kit)
        st2, res = implicit_step(u.linear_system, st, op, kit, dt_c)
        st3, res3 = implicit_step(u.linear_system, st2, op, kit, dt_c,
                                    x0=2.0 * st2.C - st.C)
        launched = {k: v - n0[k] for k, v in kernels.launch_counts().items()}
        out[device] = (fields, st2, st3, float(dt_c), (res, res3), launched)
    (g, g2, g3, dg, rg, lg), (c, c2, c3, dc, rc, lc) = (out["cuda"],
                                                        out["cpu"])
    assert lg["basis_dots"] > 0 and lg["basis_axpy"] > 0
    assert not any(lc.values())
    assert max(rg + rc) <= 1e-6 and dg == pytest.approx(dc, rel=1e-5)
    assert all(t.is_cuda for t in g3.tensors())
    for a, b in ((g.rho, c.rho), (g.vel, c.vel), (g2.C, c2.C), (g3.C, c3.C)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_extrapolated_start_runs_on_cuda_equal_cpu(tmp_path):
    """parity.cfg in float32 with implicit_extrapolate_x0 = 1, the first
    cycle (two implicit steps): the CLI on CUDA against the CPU, within
    1e-4."""
    _card()
    from pd_mg_pin_corrosion_tpu_torch import cli

    rows = {}
    for device in ("cuda", "cpu"):
        solver = cli.run([PARITY, f"output_dir={tmp_path / device}",
                          "precision=f32", "flow_max_iters=300",
                          "T_final=1.2", "implicit_extrapolate_x0=1",
                          "--device", device])
        assert solver.cycle_steps == [2] and solver.gmres_warnings == 0
        rows[device] = np.atleast_1d(np.genfromtxt(
            tmp_path / device / "diagnostics.csv", delimiter=",", names=True))
    g, c = rows["cuda"], rows["cpu"]
    np.testing.assert_array_equal(g["solid_nodes"], c["solid_nodes"])
    for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(g[col], c[col], rtol=1e-4, err_msg=col)


# ---------------------------------------------------------------------------
# the mesh: two ranks on this one card over gloo (halos staged through
# pinned host memory), each running the kernels on its extended slab

def _seeded_arrays(grid, cfg, seed):
    """Initial fields with perturbed FLUID velocities and a developed C, as
    numpy arrays by field name (the ranks build their state from them)."""
    st = initialize_state(grid, cfg, device="cpu")
    h = {k: v.numpy().copy() for k, v in vars(st).items()}
    rng = np.random.default_rng(seed)
    fluid = h["node_type"] == 0
    h["vel"] = np.where(fluid[..., None],
                        h["vel"] + rng.normal(0, 0.05, h["vel"].shape),
                        h["vel"]).astype(np.float32)
    h["C"] = np.where(h["node_type"] == 1, 1.0,
                      0.3 * rng.random(fluid.shape)).astype(np.float32)
    return h


def _mesh_case(cfg):
    from pd_mg_pin_corrosion_tpu_torch.grid import pad_grid_axial

    _card()
    kernels.build.load()    # built once, before the ranks load it
    grid = pad_grid_axial(build_grid(cfg), 2)
    return grid, _seeded_arrays(grid, cfg, 5)


def _one_rank(grid, cfg, arrays):
    from pd_mg_pin_corrosion_tpu_torch import state_from_numpy

    kit = build_kit(grid, cfg, device="cuda")
    return kit, state_from_numpy(arrays, device="cuda")


@pytest.mark.parametrize("dim", [2, 3])
def test_ns_step_sharded_on_the_card_is_bitwise(dim):
    """ns2d / ns3d on each rank's extended slab, between two wall BCs:
    the single rank's kernel bits, and the kernel launched on every rank."""
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.parallel import checks
    from pd_mg_pin_corrosion_tpu_torch.parallel.launch import spawn

    if dim == 2:
        cfg = Config.load(PARITY)
        cfg.apply_overrides(["precision=f32"])
    else:
        cfg = _cfg3d()
    grid, arrays = _mesh_case(cfg)
    out = spawn(checks.batch, 2, "gloo", "cuda", [
        (checks.ns_steps, (grid, cfg, 1e-8, True, arrays)),
        (checks.kernel_launches, ())])
    kit, st = _one_rank(grid, cfg, arrays)
    ops = ops_for(kit)
    st = ops.apply_wall_bc(st, kit)
    n0 = kernels.launch_counts()[f"ns{dim}d"]
    st = ops.apply_wall_bc(ops.ns_step(st, kit, 1e-8), kit)
    assert kernels.launch_counts()[f"ns{dim}d"] == n0 + 1
    rho, vel = out[0][0]
    assert np.array_equal(rho, st.rho.cpu().numpy())
    assert np.array_equal(vel, st.vel.cpu().numpy())
    assert all(r[1][f"ns{dim}d"] == 1 for r in out)


@pytest.mark.parametrize("dim", [2, 3])
def test_matvec_M_sharded_on_the_card_is_bitwise(dim):
    """matvec2d, and matvec3d over each rank's packed f32 and bf16 weights
    (packed on its extended slab at assembly), against one rank's."""
    from pd_mg_pin_corrosion_tpu_torch.parallel import checks
    from pd_mg_pin_corrosion_tpu_torch.parallel.launch import spawn

    if dim == 2:
        cfg = Config.load(PARITY)
        cfg.apply_overrides(["precision=f32"])
    else:
        cfg = _cfg3d()
    grid, arrays = _mesh_case(cfg)
    out = spawn(checks.batch, 2, "gloo", "cuda", [
        (checks.matvecs, (grid, cfg, arrays)),
        (checks.kernel_launches, ())])
    kit, st = _one_rank(grid, cfg, arrays)
    op = ai.assemble(st, kit)
    x = st.C + 0.3 * kit.v_pois
    want = [ai.matvec_M(op, kit, x)]
    if dim == 3:
        want += [ai.matvec_M(op, kit, x, op.W16), ai.matvec_M(op, kit, x)]
    for got, y in zip(out[0][0], want):
        assert np.array_equal(got, y.cpu().numpy())
    for r in out:
        counts = r[1]
        if dim == 2:
            assert counts["matvec2d"] == 1
        else:
            assert counts["matvec3d"] == 2 and counts["matvec3d_bf16"] == 1


# ---------------------------------------------------------------------------
# the flow solve's CUDA graph (solvers.FlowRunner)
# ---------------------------------------------------------------------------

def _flow_case(case):
    """(kit, state) on the card of a flow the graph serves: parity.cfg 2D,
    the 8,303-node 3D grid, params_amr.cfg's blocks or its gather grid;
    velocities (and rho) perturbed."""
    if case in ("parity", "parity_f64"):
        cfg = Config.load(PARITY)
        cfg.apply_overrides(["precision=f64" if case == "parity_f64"
                             else "precision=f32"])
        grid = build_grid(cfg)
        kit = build_kit(grid, cfg, device="cuda")
        st = initialize_state(grid, cfg, dtype=kit.dtype, device="cuda")
        fluid = st.node_type == 0
        st.vel = torch.where(fluid[..., None], st.vel + torch.tensor(
            np.random.default_rng(3).normal(0, 0.01, st.vel.shape),
            dtype=st.vel.dtype, device="cuda"), st.vel)
        return kit, st
    if case == "grid3d":
        return _small3d_on("cuda")[2:]
    if case == "blocks":
        return _amr_on("cuda", seed_C=False)[1:]
    return _gather_on("cuda")[1:]


def _flow_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", ["parity", "grid3d", "blocks", "gather"])
def test_flow_graph_equals_the_eager_route(case):
    """250 flow iterations (checks 1-10, 100 and 200, the dt refresh at
    200) on the graph route and on the eager route from one state: every
    field bit for bit, the same (iters, eps, conv, div) and launch counts,
    replays only on the graph route. A second graphed solve from a state
    with other node types and C reuses the graph (no new capture) and
    still equals the eager route."""
    from pd_mg_pin_corrosion_tpu_torch import solvers

    _card()
    kit, st = _flow_case(case)
    run = solvers.runner_for(kit)
    assert run.graph_route

    def both(state):
        out = {}
        for eager in (True, False):
            n0 = kernels.launch_counts()
            solvers.reset_flow_counts()
            r = solvers.solve_steady(state, kit, max_iters=250, eager=eager)
            f = solvers.FLOW_COUNTS
            out[eager] = (r, f["replays"], f["eager"], {
                k: v - n0[k] for k, v in kernels.launch_counts().items()})
        (e, e_rep, e_eag, e_n), (g, g_rep, g_eag, g_n) = out[True], out[False]
        assert repr(e[1:]) == repr(g[1:])
        for a, b in zip(e[0].tensors(), g[0].tensors()):
            assert torch.equal(_flow_bits(a), _flow_bits(b))
        assert e_n == g_n and e_rep == 0 and g_rep > 0
        assert e_rep + e_eag == g_rep + g_eag == min(e[1], 250)
        return g[0]

    out = both(st)
    graph = run.graph
    nt = out.node_type.clone()
    solid = (nt == 1).reshape(-1).nonzero().reshape(-1)[:5]
    nt.view(-1)[solid] = 0
    both(dataclasses.replace(out, node_type=nt, C=out.C * 0.9))
    assert run.graph is graph


def test_flow_graph_route_is_the_cards_alone():
    """gs_parity (host sweeps every call) and the CPU take the eager
    route; a uniform kit on the card the graph's."""
    from pd_mg_pin_corrosion_tpu_torch import solvers

    _card()
    cfg = Config.load(PARITY)
    cfg.apply_overrides(["precision=f32", "gs_parity=1"])
    grid = build_grid(cfg)
    assert not solvers.FlowRunner(build_kit(grid, cfg, device="cuda")
                                  ).graph_route
    assert not solvers.FlowRunner(build_kit(grid, cfg, device="cpu")
                                  ).graph_route
    cfg.apply_overrides(["gs_parity=0"])
    assert solvers.FlowRunner(build_kit(grid, cfg, device="cuda")).graph_route
    # float64: the NS step's plain twin reads its FLUID rows' count back
    cfg.apply_overrides(["precision=f64"])
    assert not solvers.FlowRunner(build_kit(grid, cfg, device="cuda")
                                  ).graph_route


def test_f64_run_on_the_card_equals_the_cpu(tmp_path):
    """parity.cfg in float64 through the CLI on the card (the flow on the
    eager route, GMRES and the step segments graphed) and on the CPU: the
    rows within tests/test_parity.py's gates. The flow's capture of the
    float64 NS step stopped such a run before the route excluded it."""
    from pd_mg_pin_corrosion_tpu_torch import cli

    _card()
    args = [PARITY, "precision=f64", "flow_max_iters=300", "T_final=120"]
    rows = {}
    for dev in ("cuda", "cpu"):
        solver = cli.run(args + [f"output_dir={tmp_path / dev}", "--device",
                                 dev])
        rows[dev] = np.atleast_1d(np.genfromtxt(
            tmp_path / dev / "diagnostics.csv", delimiter=",", names=True))
        if dev == "cuda":
            assert solver.flow_graph["replays"] == 0
            assert solver.flow_graph["eager"] > 0
            assert solver.gmres_graph["replays"] > 0
            assert solver.step_graph["replays"] > 0
    g, c = rows["cuda"], rows["cpu"]
    assert len(g) == len(c) > 0
    np.testing.assert_array_equal(g["solid_nodes"], c["solid_nodes"])
    np.testing.assert_allclose(g["time_s"], c["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(g[col], c[col], rtol=1e-6, err_msg=col)


# ---------------------------------------------------------------------------
# GMRES's Arnoldi steps as CUDA graphs (ops.gmres.GmresRunner)
# ---------------------------------------------------------------------------

def _seeded_C(st):
    """The state with C seeded: SOLID near 1, FLUID up to 0.92."""
    u = torch.tensor(np.random.default_rng(4).random(st.C.shape),
                     dtype=st.C.dtype, device=st.C.device)
    solid, fluid = st.node_type == 1, st.node_type == 0
    return dataclasses.replace(st, C=torch.where(
        solid, 1.0 - 0.2 * u, torch.where(fluid, 0.92 * u, 0.0)))


@pytest.mark.parametrize("case", ["parity", "parity_f64", "grid3d",
                                  "blocks", "gather"])
def test_gmres_graph_equals_the_eager_route(case):
    """Three implicit solves (``gmres.implicit_step``) from one state with
    its assembled operator, on the graph route (the solve one graph with
    conditional nodes) and on the eager route (each gate a host read): C
    and every residual bit for bit, the same Arnoldi steps, cycles and
    launch counts, launches only on the graph route, one capture, and one
    host read a solve. A second operator (the state after them, phase
    changed) reuses the graph and still equals the eager route."""
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    _card()
    kit, st = _flow_case(case)
    st = _seeded_C(st)
    ops = ops_for(kit)
    run = gmres.runner_for(kit)
    assert run.graph_route

    def both(state, op, n):
        out = {}
        for eager in (True, False):
            n0 = kernels.launch_counts()
            gmres.reset_gmres_counts()
            gmres.reset_step_counts()
            s, res = state, []
            for _ in range(n):
                s, r = gmres.implicit_step(ops.linear_system, s, op, kit,
                                           ops.compute_adaptive_dt(s, op, kit),
                                           eager=eager)
                res.append(r)
            out[eager] = (s, res, dict(gmres.GMRES_COUNTS),
                          dict(gmres.STEP_COUNTS), {
                k: v - n0[k] for k, v in kernels.launch_counts().items()})
        (e, e_res, e_c, _, e_n), (g, g_res, g_c, g_s, g_n) = (
            out[True], out[False])
        assert torch.equal(_flow_bits(e.C), _flow_bits(g.C))
        assert repr(e_res) == repr(g_res) and e_n == g_n
        assert e_c["replays"] == e_c["captures"] == e_c["launches"] == 0
        assert g_c["replays"] > 0 and g_c["host_reads"] == 0
        assert e_c["eager"] == g_c["eager"] + g_c["replays"]
        assert e_c["cycles"] == g_c["cycles"]
        assert g_s["host_reads"] == n
        return g, g_c

    out, counts = both(st, ops.assemble(st, kit, 0.0), 3)
    assert counts["captures"] == 1 and set(run.graphs) == {("solve",)}
    graph = run.graphs[("solve",)]
    st2, _ = ops.apply_phase_change(out, kit)
    _, counts2 = both(st2, ops.assemble(st2, kit, 0.0), 2)
    if counts2["recaptures"] == 0:
        # no packed store outgrew its buffers: the first graph serves it
        assert run.graphs[("solve",)] is graph and counts2["captures"] == 0


def test_gmres_graph_replay_is_one_launch_record():
    """One launch of the solve's graph is one host launch record
    (cudaGraphLaunch) standing for all its cycles, and a bare launch adds
    nothing to the launch counters (a program's launch adds the launches
    its capture recorded, once per run of each body, at the next read)."""
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    _card()
    kit, st = _flow_case("parity")
    st = _seeded_C(st)
    ops = ops_for(kit)
    gmres.implicit_step(ops.linear_system, st, ops.assemble(st, kit, 0.0),
                        kit, 0.6)
    run = gmres.runner_for(kit)
    prog = run.graphs[("solve",)]
    arn = run.lay.arn(0)
    assert prog.tally[arn][0]["matvec2d"] == 3
    assert prog.tally[arn][0]["gmres_qr"] == 1
    assert prog.nodes > prog.captured > prog.tally[arn][1]
    torch.cuda.synchronize()
    n0 = kernels.launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prog.cg.launch()
        torch.cuda.synchronize()
    records = [e.name for e in prof.events() if e.name.startswith("cu") and any(
        k in e.name for k in ("LaunchKernel", "Memset", "Memcpy",
                              "GraphLaunch"))]
    assert len(records) == 1 and "GraphLaunch" in records[0]
    assert kernels.launch_counts() == n0   # a bare launch counts nothing


@pytest.mark.parametrize("m", [25, 50])
def test_gmres_qr_equals_plain(m):
    """gmres_qr on the card against its plain twin, every mode of a step
    in order from the raw inputs (test_torch_device_loop.
    qr_check_sequence: the main solve's cycles with a negative pivot, a
    zero column and zero subdiagonals, the refinement and both correction
    loops' cycles, the step's end): S, F and the basis vector's scale
    (float32 and float64) bit for bit after each, the trip counters
    included; one launch a mode. The twin runs on a copy on the card, so
    its self-dots' square roots are torch.sqrt's there (IEEE), as the
    kernel's are."""
    from test_torch_device_loop import qr_apply, qr_check_sequence

    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    _card()
    lay = dl.QrLayout(m, 4)
    for dtype in (torch.float32, torch.float64):
        S = torch.zeros(lay.size, dtype=torch.float64, device="cuda")
        F = torch.zeros(lay.n_flags, dtype=torch.bool, device="cuda")
        scale = torch.zeros(1, dtype=dtype, device="cuda")
        Sd, Fd, scale_d = S.clone(), F.clone(), scale.clone()
        with np.errstate(divide="ignore", invalid="ignore"):
            for mode, j, arg in qr_check_sequence(
                    m, np.random.default_rng(m)):
                raw = qr_apply(lay, S, arg, scale)
                raw_d = qr_apply(lay, Sd, arg, scale_d)
                params = arg if mode == dl.BEGIN else None
                dl.gmres_qr_plain(mode, j, S, F, m, params, **raw)
                n0 = dl.gmres_qr.launches
                dl.gmres_qr(mode, j, Sd, Fd, m, params, **raw_d)
                assert dl.gmres_qr.launches == n0 + 1
                torch.cuda.synchronize()
                assert torch.equal(S.view(torch.int64),
                                   Sd.view(torch.int64)), (mode, j)
                assert torch.equal(F, Fd), (mode, j)
                assert torch.equal(scale, scale_d), (mode, j)


def test_gmres_graph_route_and_device_inv_h():
    """The graph route is the card's kit off a mesh, but for 3D float64
    (its dense plain matvec walks rows found by ``nonzero``); 1 / h on the
    card equals the host's form bit for bit."""
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    _card()
    cfg = Config.load(PARITY)
    grid = build_grid(cfg)
    assert gmres.runner_for(build_kit(grid, cfg, device="cuda")).graph_route
    assert not gmres.runner_for(build_kit(grid, cfg,
                                          device="cpu")).graph_route
    cfg3 = _cfg3d()
    cfg3.apply_overrides(["precision=f64"])
    assert not gmres.runner_for(build_kit(build_grid(cfg3), cfg3,
                                          device="cuda")).graph_route
    rng = np.random.default_rng(1)
    h = np.concatenate([[0.0, 1e-31, 1e-30, 1e-300, 5e-324, np.inf, np.nan,
                         -1.0], 10.0 ** rng.uniform(-40, 40, 20000)])
    host = np.array([1.0 / max(v, 1e-300) if v > 1e-30 else 0.0 for v in h])
    dev = gmres.inv_norm(torch.tensor(h, device="cuda")).cpu().numpy()
    assert np.array_equal(host.view(np.int64), dev.view(np.int64))


# ---------------------------------------------------------------------------
# The implicit step's segments as CUDA graphs (coupling.StepRunner)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["parity", "parity_f64", "grid3d",
                                  "blocks", "gather"])
def test_step_graph_equals_the_eager_route(case):
    """Three implicit steps of one cycle (the extrapolated start on)
    through the kit's StepRunner one at a time, then the same three as one
    chunk, on the graph route (the step loop one graph with conditional
    nodes) and on the eager route from one state: every field bit for
    bit, each step's dt, n_below, residual and diagnostics, the chunk's
    time, the same Arnoldi steps, cycles, steps and launch counts,
    launches only on the graph route and one host read a step (a chunk).
    A second cycle on the phase-changed state after them reuses the
    graph (unless a buffer grew: recaptures) and still equals the eager
    route."""
    from pd_mg_pin_corrosion_tpu_torch import coupling
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    _card()
    kit, st = _flow_case(case)
    st = _seeded_C(st)
    ops = ops_for(kit)
    stepper = coupling.step_runner_for(kit)
    assert stepper.graph_route

    def both(state, op, n):
        out = {}
        for eager in (True, False):
            n0 = kernels.launch_counts()
            gmres.reset_gmres_counts()
            gmres.reset_step_counts()
            stepper.begin(state, op, kit, state.C)
            rows = [stepper.step(kit, eager) for _ in range(n)]
            one = stepper.result(state)
            stepper.begin(state, op, kit, state.C)
            vals = stepper.steps(kit, n, eager)
            chunk = (stepper.run.sc(vals, "T"), stepper.run.sc(vals, "KK"))
            out[eager] = (one, stepper.result(state), rows, chunk,
                          dict(gmres.GMRES_COUNTS), dict(gmres.STEP_COUNTS),
                          {k: v - n0[k]
                           for k, v in kernels.launch_counts().items()})
        (e, e2, e_rows, e_ch, e_g, e_s, e_n) = out[True]
        (g, g2, g_rows, g_ch, g_g, g_s, g_n) = out[False]
        for a, b in ((e, g), (e2, g2), (e, e2)):
            for f in dataclasses.fields(a):
                assert torch.equal(_flow_bits(getattr(a, f.name)),
                                   _flow_bits(getattr(b, f.name))), f.name
        assert repr(e_rows) == repr(g_rows) and e_n == g_n
        assert repr(e_ch) == repr(g_ch) and e_ch[1] == n
        assert e_g["eager"] == g_g["eager"] + g_g["replays"]
        assert e_g["cycles"] == g_g["cycles"]
        assert e_s["steps"] == g_s["steps"] == 2 * n
        assert e_s["launches"] == e_s["captures"] == 0 < g_s["launches"]
        assert g_s["host_reads"] == n + 1 and g_g["host_reads"] == 0
        assert g_s["replayed_kernels"] > 0 == e_s["replayed_kernels"]
        return g, g_s

    out, counts = both(st, ops.assemble(st, kit, 0.0), 3)
    assert counts["captures"] == 1
    held = dict(stepper.run.graphs)
    st2, _ = ops.apply_phase_change(out, kit)
    _, counts2 = both(st2, ops.assemble(st2, kit, 0.0), 2)
    if counts2["recaptures"] == 0:
        assert all(stepper.run.graphs[k] is p for k, p in held.items())


def test_step_graph_host_records():
    """A graphed implicit step of the 8,303-node 3D grid (f32, with the
    f64 refinement) enqueues three host records (gmres_qr's BEGIN, the
    step graph's launch, the copy of its state into pinned memory) and
    reads once, whatever its Arnoldi steps; a chunk of four steps the
    same three and one read."""
    from pd_mg_pin_corrosion_tpu_torch import coupling
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    _card()
    kit, st = _flow_case("grid3d")
    st = _seeded_C(st)
    stepper = coupling.step_runner_for(kit)
    stepper.begin(st, ops_for(kit).assemble(st, kit, 0.0), kit)
    stepper.step(kit)      # the capture
    torch.cuda.synchronize()
    for n, steps in ((2, lambda: [stepper.step(kit) for _ in range(2)]),
                     (1, lambda: stepper.steps(kit, 4))):
        gmres.reset_gmres_counts()
        gmres.reset_step_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        records = sum(e.name.startswith("cu") and any(
            k in e.name for k in ("LaunchKernel", "Memset", "Memcpy",
                                  "GraphLaunch")) for e in prof.events())
        arnoldi = gmres.GMRES_COUNTS["replays"]
        assert gmres.GMRES_COUNTS["eager"] == 0 and arnoldi > 0
        print(f"{records / n:.1f} host records and "
              f"{gmres.STEP_COUNTS['host_reads'] / n:.1f} reads a launch, "
              f"{arnoldi / n:.1f} Arnoldi steps")
        assert records == 3 * n and gmres.STEP_COUNTS["host_reads"] == n


def test_step_graph_route_is_the_cards_alone():
    """The step's head and tail take the graph route on the card without
    gs_parity tables (their sweeps read the host), with GMRES's own route
    otherwise; a 3D float64 kit takes neither."""
    from pd_mg_pin_corrosion_tpu_torch import coupling

    _card()
    cfg = Config.load(PARITY)
    cfg.apply_overrides(["precision=f32", "gs_parity=1"])
    grid = build_grid(cfg)
    gs = coupling.StepRunner(build_kit(grid, cfg, device="cuda"))
    assert not gs.graph_route and gs.run.graph_route
    cfg.apply_overrides(["gs_parity=0"])
    assert coupling.StepRunner(build_kit(grid, cfg, device="cuda")).graph_route
    assert not coupling.StepRunner(build_kit(grid, cfg,
                                             device="cpu")).graph_route
    cfg3 = _cfg3d()
    cfg3.apply_overrides(["precision=f64"])
    assert not coupling.StepRunner(build_kit(build_grid(cfg3), cfg3,
                                             device="cuda")).graph_route


def _cycle_states(device, m=4):
    """cycle_qr's Y and CF with gmres_qr's S (QrLayout(m, 8), T_FINAL set)
    and F on ``device``, zeros."""
    from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    lay, glay = cl.CycleLayout(4), dl.QrLayout(m, 8)
    S = torch.zeros(glay.size, dtype=torch.float64, device=device)
    S[glay.sc("T_FINAL")] = 40.0
    return (torch.zeros(lay.size, dtype=torch.float64, device=device),
            torch.zeros(cl.N_FLAGS, dtype=torch.bool, device=device), S,
            torch.zeros(dl.N_FLAGS, dtype=torch.bool, device=device),
            glay.SC)


def test_cycle_qr_equals_plain_on_every_mode_and_exit():
    """cycle_qr against its twin on cycle_loop.walk's sequences (every
    mode, every exit, launches resumed from carried values): Y, CF, S and
    F equal after each mode."""
    from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    _card()
    for seed in range(4):
        dev, host = _cycle_states("cuda"), _cycle_states("cpu")
        n0 = cl.cycle_qr.launches

        def run_mode(mode, params, ys, ss):
            for (Y, CF, S, F, sc) in (dev, host):
                for k, v in ys.items():
                    Y[cl.SC[k]] = v
                for k, v in ss.items():
                    S[sc + dl.SC_INDEX[k]] = v
                cl.cycle_qr(mode, Y, CF, S, F, sc, params)
            for a, b in zip(dev[:4], host[:4]):
                assert torch.equal(a.cpu(), b), (seed, mode)

        modes = cl.walk(run_mode, lambda: (host[0].tolist(), host[1].tolist()),
                        seed)
        assert set(modes) == set(range(cl.N_MODES))
        assert cl.cycle_qr.launches - n0 == len(modes)
    assert cl.layout_of_library() == (len(cl.SCALARS), len(cl.TRIPS),
                                      cl.N_FLAGS, len(cl.PARAMS), cl.N_MODES)


# the 3D calibration point twoanchor-c's grid (166,050 nodes; chip_smoke.py
# CALIB3D_CFG)
CALIB3D = ["dx=8e-6", "D_grain=2.1609e-17", "D_gb=2.1609e-15",
           "gb_width_cells=0", "grain_size_mean=40e-6",
           "corrosion_accel_l=1.2790"]


def _pack3d_case(grid):
    """(kit, state) on the card: the 8,303-node 3D grid or the 3D
    calibration grid, SOLID C in [0.1, 1] and FLUID C up to 0.92 (salt
    blocking at C_sat = 0.9), FLUID velocities perturbed by 0.5 m/s (the
    upwind clamp acts)."""
    if grid == "grid3d":
        kit, st = _flow_case("grid3d")
    else:
        cfg = Config.load(os.path.join(os.path.dirname(PARITY), "..", "..",
                                       "config", "params_3d.cfg"))
        cfg.apply_overrides(CALIB3D)
        g = build_grid(cfg)
        kit = build_kit(g, cfg, device="cuda")
        st = initialize_state(g, cfg, grains=grains.generate(g, cfg),
                              device="cuda")
    rng = np.random.default_rng(21)
    u = torch.tensor(rng.random(kit.shape), dtype=torch.float32,
                     device="cuda")
    solid, fluid = st.node_type == 1, st.node_type == 0
    vel = st.vel + torch.tensor(rng.normal(0.0, 0.5, st.vel.shape),
                                dtype=torch.float32, device="cuda")
    return kit, dataclasses.replace(
        st, C=torch.where(solid, 1.0 - 0.9 * u,
                          torch.where(fluid, 0.92 * u, 0.0)),
        vel=torch.where(fluid[..., None], vel, st.vel))


def _capacity_buffers(ref, cap):
    packed = dataclasses.replace(
        ref, count=torch.zeros_like(ref.count),
        slice_ptr=torch.zeros_like(ref.slice_ptr),
        slots=torch.full((cap,), 7, dtype=torch.uint8, device="cuda"),
        values=torch.full((cap,), 7.0, device="cuda"))
    return packed, dataclasses.replace(
        packed, values=torch.full((cap,), 7.0, dtype=torch.bfloat16,
                                  device="cuda"))


def _packed_bits(packed, packed16, n=None):
    return (packed.count, packed.slice_ptr, packed.slots[:n],
            packed.values[:n].view(torch.int32),
            packed16.values[:n].view(torch.int16))


@pytest.mark.parametrize("grid", ["grid3d", "calib3d"])
def test_pack3d_equals_pack_stencil(grid):
    """pack3d from the state into capacity buffers against its twin (the
    dense assembly, then the packing walk) and against pack_stencil, on
    the 8,303-node 3D grid and the 3D calibration grid (166,050 nodes),
    before and after a phase change, with a volume loss of 0.1: diag,
    unknown, count, slice_ptr, the slots, float32 and bfloat16 values of
    the whole buffers and status byte for byte, one launch each; a
    capacity one entry short sets the overflow flag and writes no slot or
    value. pack3d_alloc (one sizing read, one launch) and the dense
    yardstick pack3d_dense give pack_stencil's bytes."""
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import (
        SLICE, pack3d, pack3d_alloc, pack3d_dense, pack3d_plain)

    _card()
    kit, st = _pack3d_case(grid)
    decay = ard_ops.micro_d_factor(kit.cfg, 0.1, kit.dtype, kit.device)
    assert bool(ard_ops.compute_salt_blocked(st, kit).any())
    ops = ops_for(kit)
    for state in (st, ops.apply_phase_change(st, kit)[0]):
        W, diag, unknown = ai._dense_operator(state, kit, 0.1)
        ref = kernels.pack_stencil(W, unknown, kit)
        ref16 = ref.to(torch.bfloat16)
        n = ref.values.numel()
        for cap in (n + 3 * SLICE, n - 1):
            outs = []
            for fn in (pack3d, pack3d_plain):
                packed, packed16 = _capacity_buffers(ref, cap)
                status = torch.zeros(2, dtype=torch.int64, device="cuda")
                d, u = torch.full_like(diag, 7.0), torch.zeros_like(unknown)
                n0 = pack3d.launches
                fn(state, decay, kit, d, u, packed, packed16, status)
                assert pack3d.launches == n0 + (fn is pack3d)
                outs.append((d.view(torch.int32), u, status,
                             *_packed_bits(packed, packed16)))
            kernel, twin = outs
            for a, b in zip(kernel, twin):
                assert torch.equal(a, b)
            assert torch.equal(kernel[0], diag.view(torch.int32))
            assert torch.equal(kernel[1], unknown)
            assert kernel[2].tolist() == [ref.nnz, int(cap < n)]
            assert torch.equal(kernel[3], ref.count)
            assert torch.equal(kernel[4], ref.slice_ptr)
            if cap < n:
                # the twin's buffers (the last filled), equal to the
                # kernel's bit for bit
                assert all(bool((t == 7).all()) for t in (
                    packed.slots, packed.values, packed16.values))
                continue
            for a, b in zip(_packed_bits(ref, ref16),
                            (kernel[3], kernel[4], kernel[5][:n],
                             kernel[6][:n], kernel[7][:n])):
                assert torch.equal(a, b)
        n0 = pack3d.launches
        a_diag, a_unknown, a_packed, a_packed16 = pack3d_alloc(state, decay,
                                                               kit)
        assert pack3d.launches == n0 + 1 and a_packed.nnz == ref.nnz
        assert torch.equal(a_diag.view(torch.int32), diag.view(torch.int32))
        assert torch.equal(a_unknown, unknown)
        for a, b in zip(_packed_bits(a_packed, a_packed16),
                        _packed_bits(ref, ref16)):
            assert torch.equal(a, b)
        packed, packed16 = _capacity_buffers(ref, n)
        status = torch.zeros(2, dtype=torch.int64, device="cuda")
        n0 = pack3d_dense.launches
        pack3d_dense(W, unknown, kit, packed, packed16, status)
        assert pack3d_dense.launches == n0 + 1
        assert status.tolist() == [ref.nnz, 0]
        for a, b in zip(_packed_bits(packed, packed16),
                        _packed_bits(ref, ref16)):
            assert torch.equal(a, b)


def test_card_assembly_builds_no_dense_w(monkeypatch):
    """On a CUDA float32 3D kit ``assemble`` (the host loop's, one sizing
    read) and ``assemble_into`` (the fused cycles') build the operator
    with pack3d and never call the dense assembly (a counter on
    ``_dense_operator`` and ``_dense_weights``); both give the dense
    route's bytes (``_dense_operator`` + ``finish_operator``)."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import pack3d
    from pd_mg_pin_corrosion_tpu_torch.ops.gmres import GmresRunner

    _card()
    kit, st = _pack3d_case("grid3d")
    dense = ai.finish_operator(ai.ImplicitOperator(
        *ai._dense_operator(st, kit, 0.1)), kit)
    calls = []
    for name in ("_dense_operator", "_dense_weights"):
        real = getattr(ai, name)
        monkeypatch.setattr(ai, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    n0 = pack3d.launches
    op = ai.assemble(st, kit, 0.1)
    assert op.W is None and op.packed is not None
    run = GmresRunner()
    target = run.load(ai.assemble(st, kit, 0.0))
    status = torch.zeros(2, dtype=torch.int64, device="cuda")
    ai.assemble_into(target, st, kit, 0.1, status)
    assert pack3d.launches == n0 + 3 and calls == []
    assert status.tolist() == [dense.packed.nnz, 0]
    n = dense.packed.values.numel()
    for got in (op, target):
        assert torch.equal(got.diag.view(torch.int32),
                           dense.diag.view(torch.int32))
        assert torch.equal(got.unknown, dense.unknown)
        for a, b in zip(_packed_bits(got.packed, got.W16, n),
                        _packed_bits(dense.packed, dense.W16)):
            assert torch.equal(a, b)


def _cycles_run(tmp_path, tag, cfg_args, eager, monkeypatch):
    from pd_mg_pin_corrosion_tpu_torch import cli, coupling
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    gmres.reset_cycle_counts()
    with monkeypatch.context() as m:
        m.setattr(coupling.CoupledSolver, "eager_cycles", eager)
        solver = cli.run([*cfg_args, f"output_dir={tmp_path / tag}",
                          "--device", "cuda"])
    files = {n: (tmp_path / tag / n).read_bytes()
             for n in sorted(os.listdir(tmp_path / tag))
             if n.endswith((".csv", ".vti", ".pvd"))}
    return solver, files


CYCLES_CASES = {
    "parity": [PARITY, "precision=f32", "flow_max_iters=300",
               "dissolution_batch=20", "T_final=4.2", "coupled_fused_cycles=3",
               "implicit_output_every=2", "flow_output_stride=2",
               "coupled_launch_steps=4"],
    "grid3d": [os.path.join(os.path.dirname(PARITY), "..", "..", "config",
                            "params_3d.cfg"),
               "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6", "R_tube=48e-6",
               "L_upstream=32e-6", "L_downstream=32e-6", "Q_flow=1.667e-10",
               "D_grain=5e-12", "D_gb=5e-10", "corrosion_accel_l=0",
               "dissolution_batch=1", "flow_max_iters=300",
               "flow_max_iters_resolve=150", "T_final=21",
               "coupled_launch_steps=5", "implicit_output_every=3",
               "checkpoint_every=2"],
}


@pytest.mark.parametrize("case", sorted(CYCLES_CASES))
def test_cycles_graph_equals_eager_route(case, tmp_path, monkeypatch):
    """The fused cycles' program as one CUDA graph launch against the same
    program run directly: the same CSV, VTI and PVD bytes, steps a cycle,
    flow solves and final state; the graph route reads the host once a
    launch and nowhere inside (no gate read, no GMRES or step read), and
    launches cycle_qr (and pack3d in 3D) inside its graph."""
    _card()
    args = CYCLES_CASES[case]
    eager, e_files = _cycles_run(tmp_path, "eager", args, True, monkeypatch)
    n0 = kernels.launch_counts()
    graph, g_files = _cycles_run(tmp_path, "graph", args, False, monkeypatch)
    launched = {k: v - n0[k] for k, v in kernels.launch_counts().items()}
    assert g_files == e_files
    assert graph.cycle_steps == eager.cycle_steps
    assert graph.flow_results == eager.flow_results
    for a, b in zip(graph.final_state.tensors(), eager.final_state.tensors()):
        assert torch.equal(_flow_bits(a), _flow_bits(b))
    g, e = graph.cycle_graph, eager.cycle_graph
    assert e["launches"] == 0 < e["eager_launches"]
    assert g["eager_launches"] == 0 < g["launches"] == g["host_reads"]
    assert g["captures"] >= 1 and g["cycles"] == e["cycles"] > 1
    assert graph.step_graph["host_reads"] == 0
    assert graph.gmres_graph["host_reads"] == 0
    assert graph.flow_graph["replays"] > 0 == graph.flow_graph["eager"]
    assert launched["cycle_qr"] > 0 and launched["gmres_qr"] > 0
    if case == "grid3d":
        assert launched["pack3d"] > 0 and launched["ns3d"] > 0
        assert launched["matvec3d"] > 0 and launched["slots3d_f64"] > 0
    print(f"{case}: {json.dumps(g)}")
