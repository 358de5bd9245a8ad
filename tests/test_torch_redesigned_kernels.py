"""What the H100 forms of basis_dots and ns3d rest on, checked on the CPU
(the CUDA kernels themselves run only on a card: tests/test_torch_cuda.py).

basis_dots: the grid taken from the SM count, and ``basis_dots_walk_plain``,
the kernel's order of f64 sums in PyTorch (a warp a row and a part of the
block's four-element pieces, the short last piece, the warp tree, the
parts, the last block's sums), against the
plain f64 sum and the JAX package's ``basis_dots_pallas`` in the Pallas
interpreter (rtol 2e-6: f64 sums of the same f32 products in another
order), for pitched and back-to-back rows.

ns3d: the kernel's slot table (``ns3d_tables``: a tile offset and four
coefficients a slot, and the runs along z) against ``kit.ns_offsets`` /
``kit.ns_coefs``, and ``ns3d_staged_plain``, the kernel's walk in PyTorch
(masked zero-filled planes, every run walked along z for R nodes a thread),
bit for bit against ``ns3d_plain`` on the 8,303-node grid of
tests/test_pallas_interpret.py with a nan in every OUTSIDE node, and
through it against the JAX ``ns_step_pallas_3d`` in the Pallas interpreter
at the tolerance tests/test_torch_3d_kernels.py states (2 ulp of rho)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.ops import ns as j_ns
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kernels, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, OUTSIDE
from pd_mg_pin_corrosion_tpu_torch.kernels import basis as basis_mod
from pd_mg_pin_corrosion_tpu_torch.kernels.ns3d import (HALO, Ns3dGeometry,
                                                        _masked_planes)
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns

torch.set_num_threads(2)

GEOMETRY = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "precision=f32"]


# ---------------------------------------------------------------------------
# basis_dots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 108, 4])
@pytest.mark.parametrize("k", [1, 13, 26, 40])
@pytest.mark.parametrize("n", [1, 3, 4, 1027, 196_749, 1_055_668, 9_000_001])
def test_dots_grid_covers_the_vector(k, n, sms):
    blocks, share, parts = kernels.dots_grid(k, n, sms)
    pieces = -(-n // 4)
    assert 1 <= blocks <= sms * basis_mod._DOTS_WAVES
    assert blocks * share >= pieces
    assert blocks == 1 or (blocks - 1) * share < pieces     # no empty block
    if blocks < sms * basis_mod._DOTS_WAVES:
        assert blocks == 1 or share >= basis_mod._DOTS_MIN_PIECES
    # about _DOTS_ITEMS (row, part) items for each warp, never none
    warps = basis_mod._DOTS_THREADS // 32
    assert parts >= 1
    assert k * parts >= min(k, basis_mod._DOTS_ITEMS * warps)
    assert k * (parts - 1) < basis_mod._DOTS_ITEMS * warps
    assert k * parts <= 1024      # csrc/basis.cu kMaxItems


def _basis(k, n, layout, seed):
    rng = np.random.default_rng(seed)
    flat = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=n), dtype=torch.float32)
    if layout == "pitched":
        V = kernels.pitched_basis(k + 1, n, torch.float32, "cpu")[:k]
        V.copy_(flat)
        assert V.stride(0) % basis_mod.PITCH_ALIGN == 0
    else:
        V = flat
    return flat, V, w


@pytest.mark.parametrize("layout", ["pitched", "contiguous"])
@pytest.mark.parametrize("k,n", [(1, 5), (3, 1027), (26, 4096), (7, 4098),
                                 (26, 19_677), (13, 140_001)])
def test_dots_walk_equals_the_plain_sum(k, n, layout):
    """The kernel's order of sums, with whole pieces and a short last one
    (n % 4 = 0 ... 3), one turn and several a lane, one part and
    several, one block and several: within rtol 2e-6 of the plain f64 sum,
    and the same bits for pitched rows as for rows back to back."""
    flat, V, w = _basis(k, n, layout, k + n)
    plain = kernels.basis_dots_plain(flat, w)
    for sms in (132, 2):
        walk = kernels.basis_dots_walk_plain(V, w, sms)
        assert walk.dtype == torch.float64 and walk.shape == (k,)
        torch.testing.assert_close(walk, plain, rtol=2e-6, atol=1e-9)
        assert torch.equal(walk, kernels.basis_dots_walk_plain(flat, w, sms))
    # the wrapper on CPU tensors is the plain twin and launches nothing
    before = kernels.basis_dots.launches
    assert torch.equal(kernels.basis_dots(V, w), plain)
    assert kernels.basis_dots.launches == before


def test_dots_walk_is_the_sum_of_exact_products_when_they_are_exact():
    """Small integers: every product and every partial sum is exact, so any
    order gives the same f64, the kernel's too."""
    rng = np.random.default_rng(8)
    V = torch.tensor(rng.integers(-8, 9, size=(26, 70_001)),
                     dtype=torch.float32)
    w = torch.tensor(rng.integers(-8, 9, size=70_001), dtype=torch.float32)
    exact = (V.double() @ w.double())
    assert torch.equal(kernels.basis_dots_walk_plain(V, w), exact)
    assert torch.equal(kernels.basis_dots_plain(V, w), exact)
    # the self-dot that is every GMRES norm
    assert torch.equal(kernels.basis_dots_walk_plain(w[None], w),
                       (w.double() @ w.double())[None])


def test_dots_walk_matches_pallas_interpret():
    """The same basis through the JAX package's basis_dots_pallas (the
    Pallas interpreter; f32 lane partials, so its own rtol of 2e-6 with the
    atol its test states) and through the kernel's order of sums; n is odd,
    the JAX side's (R, 128) layout zero-padded."""
    rng = np.random.default_rng(3)
    M1, R, L = 9, pk._BR_GB * 2, 128
    n = R * L - 3
    Vn = rng.normal(size=(M1, n)).astype(np.float32)
    wn = rng.normal(size=n).astype(np.float32)
    V2 = jnp.asarray(np.pad(Vn, ((0, 0), (0, 3))).reshape(M1, R, L))
    w2 = jnp.asarray(np.pad(wn, (0, 3)).reshape(1, R, L))
    pk.INTERPRET = True
    try:
        ref = np.asarray(pk.basis_dots_pallas(V2, w2, jnp.float64))
        norm_ref = float(pk.basis_norm_pallas(w2[0], jnp.float64))
    finally:
        pk.INTERPRET = False
    V, w = torch.tensor(Vn), torch.tensor(wn)
    walk = kernels.basis_dots_walk_plain(V, w)
    np.testing.assert_allclose(walk.numpy(), ref, rtol=2e-6, atol=1e-3)
    norm = float(torch.sqrt(kernels.basis_dots_walk_plain(w[None], w)[0]))
    np.testing.assert_allclose(norm, norm_ref, rtol=2e-6)


def test_dots_scratch_is_kept_per_device_and_stream():
    basis_mod._dots_scratch.clear()
    cpu = torch.device("cpu")
    partial, ticket = basis_mod._scratch(cpu, 0, 3, 264)
    assert partial.dtype == torch.float64 and partial.numel() >= 3 * 264
    assert ticket.dtype == torch.int32 and int(ticket) == 0
    again = basis_mod._scratch(cpu, 0, 26, 264)
    assert again[0] is partial and again[1] is ticket      # 32 rows kept
    grown = basis_mod._scratch(cpu, 0, 40, 264)
    assert grown[0].numel() >= 40 * 264 and grown[1] is ticket
    other = basis_mod._scratch(cpu, 7, 3, 264)
    assert other[1] is not ticket
    basis_mod._dots_scratch.clear()


# ---------------------------------------------------------------------------
# ns3d
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small3d():
    """JAX and port (kit, state) of the 8,303-node grid from one seeded
    perturbation of FLUID rho and vel."""
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides(GEOMETRY)
    jg, tg = j_build_grid(j), t_build_grid(t)
    jk, tk = j_build_kit(jg, j), t_build_kit(tg, t, device="cpu")
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(3)
    fluid = host["node_type"] == 0
    host["rho"] = np.where(fluid, host["rho"]
                           + rng.normal(0, 0.1, fluid.shape), host["rho"])
    host["vel"] = np.where(fluid[..., None], host["vel"]
                           + rng.normal(0, 0.05, fluid.shape + (3,)),
                           host["vel"])
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in host},
                          dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


@pytest.mark.parametrize("pitch,plane", [(24, 336), (30, 600), (25, 25 * 25)])
def test_ns3d_tables_hold_the_kits_slots(small3d, pitch, plane):
    _, _, tk, _ = small3d
    tab = kernels.ns3d_tables(tk, pitch, plane)
    S = tk.S
    assert tab.offsets.dtype == torch.int32 and tab.offsets.shape == (S,)
    assert tab.coefs.dtype == torch.float32 and tab.coefs.shape == (S, 4)
    assert tab.coefs.is_contiguous() and tab.runs.dtype == torch.int32
    # a slot's offset decodes to its (dk, dj, di) plus the halo
    off = tab.offsets.long()
    H = HALO
    decoded = torch.stack([off // plane, off % plane // pitch, off % pitch],
                          1) - H
    assert torch.equal(decoded, tk.ns_offsets.long())
    assert int(off.min()) >= 0
    assert int(off.max()) <= 2 * H * (plane + pitch + 1)
    # its four coefficients side by side
    assert torch.equal(tab.coefs.T, tk.ns_coefs.float())
    # the runs cover the slots in order; inside a run (dj, di) is fixed and
    # dk goes up by one, so the tile offsets go up by one plane; no two
    # neighbouring runs could be one
    first, length = tab.runs[:, 0].long(), tab.runs[:, 1].long()
    assert int(first[0]) == 0 and int(length.sum()) == S
    assert torch.equal(first[1:], first[:-1] + length[:-1])
    for f, n in tab.runs.tolist():
        assert n >= 1
        assert torch.equal(off[f:f + n], off[f] + plane * torch.arange(n))
        if f:
            assert int(off[f] - off[f - 1]) != plane
    # 37 (dj, di) groups; the centre group has a hole at dk = 0
    groups = {tuple(o) for o in tk.ns_offsets[:, 1:].tolist()}
    assert len(groups) == 37 and tab.runs.shape[0] == 38


def test_ns3d_tables_refuse_a_wider_stencil(small3d):
    _, _, tk, _ = small3d
    far = tk.ns_offsets.clone()
    far[0, 0] = -(HALO + 1)
    with pytest.raises(ValueError, match="halo"):
        kernels.ns3d_tables(dataclasses.replace(tk, ns_offsets=far), 24, 336)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 8])
def test_ns3d_staged_walk_equals_plain_bit_for_bit(small3d, R):
    """Zero-filled masked planes and runs walked along z for R nodes a
    thread give ns3d_plain's bits; a nan in every OUTSIDE node is dropped
    from its neighbours' sums by both (and copied through in its own
    node)."""
    _, _, tk, ts = small3d
    dt = t_ns.compute_dt(ts, tk)
    outside = ts.node_type == OUTSIDE
    assert bool(outside.any())
    nan = float("nan")
    rho = torch.where(outside, nan, ts.rho)
    vel = torch.where(outside[..., None], nan, ts.vel)
    p = torch.where(outside, nan, t_ns.tait_pressure(ts.rho, tk))
    args = (rho, vel, p, ts.node_type, dt, tk)
    rp, vp = kernels.ns3d_plain(*args)
    rs, vs = kernels.ns3d_staged_plain(*args, R=R)
    assert bool(torch.isfinite(rp[~outside]).all())
    assert bool(torch.isfinite(vp[~outside]).all())
    assert bool(torch.isnan(rs[outside]).all())
    assert torch.equal(rs.view(torch.int32), rp.view(torch.int32))
    assert torch.equal(vs.view(torch.int32), vp.view(torch.int32))
    # the FLUID nodes did move, the others did not
    fluid = ts.node_type == FLUID
    assert not torch.equal(rs[fluid], rho[fluid])
    assert torch.equal(rs[~fluid & ~outside], rho[~fluid & ~outside])


def test_ns3d_masked_planes_are_a_select():
    """inf and nan in OUTSIDE nodes become +0 (a multiply by the mask would
    keep them as nan); every other value passes."""
    nt = torch.tensor([[FLUID, OUTSIDE, 1, OUTSIDE]], dtype=torch.uint8)
    rho = torch.tensor([[1.5, float("nan"), -0.0, float("inf")]])
    vel = torch.stack([rho, 2 * rho, 3 * rho], -1)
    planes = _masked_planes(rho, vel, rho, nt)
    assert len(planes) == 5
    for f, scale in zip(planes, (1, 1, 2, 3, 1)):
        assert torch.equal(f.view(torch.int32),
                           torch.tensor([[1.5 * scale, 0.0, -0.0, 0.0]]
                                        ).view(torch.int32))


def test_ns3d_staged_walk_matches_the_pallas_kernel(small3d):
    """The staged walk against the JAX ns_step_pallas_3d in the Pallas
    interpreter: 2 ulp of rho, vel rtol 1e-6 (XLA on the CPU may fuse a
    multiply-add the port rounds twice)."""
    jk, js, tk, ts = small3d
    pk.INTERPRET = True
    try:
        ref = pk.ns_step_pallas_3d(js, jk, j_ns.compute_dt(js, jk))
    finally:
        pk.INTERPRET = False
    p = t_ns.tait_pressure(ts.rho, tk)
    rho, vel = kernels.ns3d_staged_plain(ts.rho, ts.vel, p, ts.node_type,
                                         t_ns.compute_dt(ts, tk), tk, R=4)
    np.testing.assert_array_max_ulp(rho.numpy(), np.asarray(ref.rho), 2)
    np.testing.assert_allclose(
        vel.numpy(), np.asarray(ref.vel), rtol=1e-6,
        atol=2e-9 * float(np.abs(np.asarray(ref.vel)).max()))


@pytest.mark.parametrize("tile", [(8, 8, 16), (4, 4, 4), (23, 19, 19)])
def test_ns3d_staging_counts_the_tiles_with_a_fluid_node(small3d, tile):
    _, _, tk, ts = small3d
    tz, ty, tx = tile
    H = HALO
    staged = (tx + 2 * H) * (ty + 2 * H) * (tz + 2 * H)
    geo = Ns3dGeometry(tx, ty, tz, 4, H, tx + 2 * H,
                                (tx + 2 * H) * (ty + 2 * H), 256, staged,
                                20 * staged)
    tiles, busy, nbytes, halo = kernels.ns3d_staging(tk, ts.node_type, geo)
    nz, ny, nx = tk.shape
    assert tiles == -(-nz // tz) * -(-ny // ty) * -(-nx // tx)
    fluid = (ts.node_type == FLUID).numpy()
    count = sum(bool(fluid[z:z + tz, y:y + ty, x:x + tx].any())
                for z in range(0, nz, tz) for y in range(0, ny, ty)
                for x in range(0, nx, tx))
    assert busy == count and 0 < busy <= tiles
    assert nbytes == busy * staged * 21
    assert halo == staged / (tx * ty * tz)
