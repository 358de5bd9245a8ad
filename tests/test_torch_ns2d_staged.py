"""What the staged form of the ns2d kernel rests on, checked on the CPU (the
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py).

``ns2d_tables``: a tile offset and five coefficients a slot, and the runs
along x, against the kit's stencil (36 slots at m_ratio = 3, 8 runs).
``ns2d_staged_plain``: the kernel's walk in PyTorch (tiles staged with
their halo as masked zero-filled planes, every run walked along x for R
nodes a thread), bit for bit against ``ns2d_plain`` on tests/golden/
parity.cfg (51 x 39) with and without a block of OUTSIDE nodes, for R = 1,
2, 3, 4, 8 and tiles that do and do not divide the grid; and against the
JAX ``ns_step_pallas`` in the Pallas interpreter at the tolerances
tests/test_torch_kernels_plain.py states. ``ns2d_staging``: the tiles a
launch stages."""

import dataclasses
import os

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
from pd_mg_pin_corrosion_tpu_torch.kernels.ns2d import HALO, Ns2dGeometry
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


@pytest.fixture(scope="module")
def parity():
    """JAX and port (kit, state) of parity.cfg in f32 from one seeded
    perturbation of FLUID rho and vel (tests/test_torch_kernels_plain.py's
    set-up)."""
    j, t = JConfig.load(PARITY), TConfig.load(PARITY)
    for c in (j, t):
        c.precision = "f32"
        c.compute_derived()
    jk = j_build_kit(j_build_grid(j), j)
    tk = t_build_kit(t_build_grid(t), t, device="cpu")
    js = j_initialize_state(j_build_grid(j), j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(1)
    fluid = host["node_type"] == 0
    host["rho"] = np.where(fluid, host["rho"] + rng.normal(0, 0.1, fluid.shape),
                           host["rho"])
    host["vel"] = np.where(fluid[..., None],
                           host["vel"] + rng.normal(0, 0.005,
                                                    fluid.shape + (2,)),
                           host["vel"])
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in host},
                          dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


def _args(tk, ts, outside):
    """ns2d's arguments; with ``outside`` a block of nodes across the tube
    and its wall set OUTSIDE, their (finite) values left as they were: the
    twin multiplies them by 0, the kernel drops them."""
    nt = ts.node_type.clone()
    if outside:
        ny, nx = tk.shape
        nt[20:27, 5:nx - 9] = OUTSIDE
    p = t_ns.tait_pressure(ts.rho, tk)
    return ts.rho, ts.vel, p, nt, t_ns.compute_dt(ts, tk), tk


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("pitch", [39, 44, 71])
def test_ns2d_tables_hold_the_kits_slots(parity, pitch):
    _, _, tk, _ = parity
    tab = kernels.ns2d_tables(tk, pitch)
    S = tk.S
    assert S == 36
    assert tab.offsets.dtype == torch.int32 and tab.offsets.shape == (S,)
    assert tab.coefs.dtype == torch.float32 and tab.coefs.shape == (S, 8)
    assert tab.coefs.is_contiguous() and tab.runs.dtype == torch.int32
    # a slot's offset decodes to its (dj, di) plus the halo, in the kit's
    # slot order
    off = tab.offsets.long()
    decoded = torch.stack([off // pitch, off % pitch], 1) - HALO
    assert torch.equal(decoded, tk.slot_offsets.long())
    assert int(off.min()) >= 0 and int(off.max()) <= 2 * HALO * (pitch + 1)
    # its five coefficients side by side, then zeros
    assert torch.equal(tab.coefs[:, :5].T, tk.slot_coefs.float())
    assert not tab.coefs[:, 5:].any()
    # the runs cover the slots in order; inside a run dj is fixed and di
    # goes up by one; 7 rows of dj, the centre row split at di = 0
    first, length = tab.runs[:, 0].long(), tab.runs[:, 1].long()
    assert int(first[0]) == 0 and int(length.sum()) == S
    assert torch.equal(first[1:], first[:-1] + length[:-1])
    for f, n in tab.runs.tolist():
        assert torch.equal(off[f:f + n], off[f] + torch.arange(n))
        if f:
            assert int(off[f] - off[f - 1]) != 1
    assert length.tolist() == [3, 5, 7, 3, 3, 7, 5, 3]


def test_ns2d_tables_refuse_a_wider_stencil(parity):
    _, _, tk, _ = parity
    far = tk.slot_offsets.clone()
    far[0, 1] = -(HALO + 1)
    with pytest.raises(ValueError, match="halo"):
        kernels.ns2d_tables(dataclasses.replace(tk, slot_offsets=far), 39)


# (ty, tx) per R: one that divides the 51 x 39 grid as far as its width
# allows (a multiple of R never divides the odd 39 unless R is 1 or 3), and
# one ragged on both axes
TILES = {1: [(17, 13), (16, 8)], 2: [(17, 40), (16, 8)],
         3: [(17, 39), (16, 12)], 4: [(51, 40), (16, 16)],
         8: [(17, 40), (16, 32)]}


@pytest.mark.parametrize("outside", [False, True], ids=["parity", "outside"])
@pytest.mark.parametrize("R,tile", [(R, t) for R, ts in TILES.items()
                                    for t in ts])
def test_ns2d_staged_walk_equals_plain_bit_for_bit(parity, R, tile, outside):
    _, _, tk, ts = parity
    args = _args(tk, ts, outside)
    assert bool((args[3] == OUTSIDE).any()) == outside
    rp, vp = kernels.ns2d_plain(*args)
    rs, vs = kernels.ns2d_staged_plain(*args, R=R, tile=tile)
    assert torch.equal(_bits(rs), _bits(rp))
    assert torch.equal(_bits(vs), _bits(vp))
    # the FLUID nodes moved, every other node was copied through
    fluid = args[3] == FLUID
    assert not torch.equal(rs[fluid], ts.rho[fluid])
    assert torch.equal(rs[~fluid], ts.rho[~fluid])
    assert torch.equal(vs[~fluid], ts.vel[~fluid])


def test_ns2d_staged_walk_refuses_a_tile_that_splits_a_thread(parity):
    _, _, tk, ts = parity
    with pytest.raises(ValueError, match="multiple of R"):
        kernels.ns2d_staged_plain(*_args(tk, ts, False), R=4, tile=(16, 30))


def test_ns2d_staged_walk_matches_the_pallas_kernel(parity):
    """The staged walk against the JAX ns_step_pallas in the Pallas
    interpreter, at tests/test_torch_kernels_plain.py's tolerances (rho
    rtol 1e-6 atol 1e-6, vel rtol 1e-5 atol 1e-9)."""
    jk, js, tk, ts = parity
    pk.INTERPRET = True
    try:
        ref = pk.ns_step_pallas(js, jk, j_ns.compute_dt(js, jk))
    finally:
        pk.INTERPRET = False
    rho, vel = kernels.ns2d_staged_plain(*_args(tk, ts, False), R=4,
                                         tile=(16, 16))
    np.testing.assert_allclose(rho.numpy(), np.asarray(ref.rho), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vel.numpy(), np.asarray(ref.vel), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("tile", [(16, 32), (17, 13), (8, 8)])
def test_ns2d_staging_counts_the_tiles_with_a_fluid_node(parity, tile):
    _, _, tk, ts = parity
    ty, tx = tile
    staged = (tx + 2 * HALO) * (ty + 2 * HALO)
    geo = Ns2dGeometry(tx, ty, 1, HALO, tx + 2 * HALO + 1, 128, staged,
                       20 * staged)
    nt = _args(tk, ts, True)[3]
    tiles, busy, nbytes, halo = kernels.ns2d_staging(tk, nt, geo)
    ny, nx = tk.shape
    assert tiles == -(-ny // ty) * -(-nx // tx)
    fluid = (nt == FLUID).numpy()
    count = sum(bool(fluid[y:y + ty, x:x + tx].any())
                for y in range(0, ny, ty) for x in range(0, nx, tx))
    assert busy == count and 0 < busy <= tiles
    assert nbytes == busy * staged * 17
    assert halo == staged / (tx * ty)


def test_ns2d_wrapper_on_cpu_tensors_is_the_plain_twin(parity):
    _, _, tk, ts = parity
    args = _args(tk, ts, True)
    before = kernels.launch_counts()
    r, v = kernels.ns2d(*args)
    rp, vp = kernels.ns2d_plain(*args)
    assert torch.equal(r, rp) and torch.equal(v, vp)
    assert kernels.launch_counts() == before
