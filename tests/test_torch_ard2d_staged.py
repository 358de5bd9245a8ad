"""What the staged form of the ard2d kernel rests on, checked on the CPU (the
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py).

``ard2d_staged_plain``: the kernel's walk in PyTorch (tiles staged with
their halo as zero-filled planes of C, |v|, the solid side's interface
diffusivity and the liquid class; ns2d's slot table; every run walked along
x for R nodes a thread; bond classes by selects), bit for bit against
``ard2d_plain`` on tests/golden/parity.cfg (51 x 39) with a seeded C that
salt-blocks some SOLID nodes, with and without a block of OUTSIDE nodes,
for R = 1, 2 and 4 and tiles that do and do not divide the grid; and
against the JAX ``ard_step_pallas`` in the Pallas interpreter at
tests/test_torch_explicit.py's tolerances. ``ard2d_staging``: the tiles a
launch stages."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu_torch import (Config, build_grid, build_kit,
                                           grains, initialize_state, kernels)
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, OUTSIDE, SOLID_MG
from pd_mg_pin_corrosion_tpu_torch.kernels.ns2d import HALO, Ns2dGeometry
from pd_mg_pin_corrosion_tpu_torch.ops import ard as t_ard
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns
from test_torch_explicit import VOL_LOSS, _states

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


@pytest.fixture(scope="module")
def parity():
    """Port (kit, state) of parity.cfg in f32 with grains, seeded FLUID
    velocities and a seeded C: FLUID uniform in [0, 1) (some reach C_sat
    and salt-block their SOLID neighbours), SOLID in (0.5, 1]."""
    cfg = Config.load(PARITY)
    cfg.precision = "f32"
    cfg.corrosion_decay_l = 0.5
    cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cpu")
    st = initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                          device="cpu")
    rng = np.random.default_rng(7)
    fluid = st.node_type == FLUID
    solid = st.node_type == SOLID_MG
    st.vel = torch.where(fluid[..., None], st.vel + torch.tensor(
        rng.normal(0, 0.005, st.vel.shape), dtype=torch.float32), st.vel)
    st.C = torch.where(solid, 1.0 - 0.5 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32), torch.where(
            fluid, torch.tensor(rng.random(kit.shape), dtype=torch.float32),
            0.0))
    return kit, st


def _args(kit, st, outside):
    """ard2d's arguments; with ``outside`` a block of nodes across the tube
    and its wall set OUTSIDE, their (finite) values left as they were."""
    if outside:
        nt = st.node_type.clone()
        ny, nx = kit.shape
        nt[20:27, 5:nx - 9] = OUTSIDE
        st = dataclasses.replace(st, node_type=nt)
    salt = t_ard.compute_salt_blocked(st, kit)
    Ds = t_ard.solid_diffusivity(
        st.is_gb, st.is_precip, kit.cfg,
        t_ard.micro_d_factor(kit.cfg, VOL_LOSS, kit.dtype, kit.device))
    dt = float(t_ard.compute_dt(st, kit))
    return (st.C, st.vel, t_ns.vel_magnitude(st.vel), st.node_type, Ds, salt,
            dt, kit)


def _bits(t):
    return t.contiguous().view(torch.int32)


# (ty, tx) per R: one that divides the 51 x 39 grid as far as its width
# allows (a multiple of R never divides the odd 39 unless R is 1), and one
# ragged on both axes
TILES = {1: [(17, 13), (16, 8)], 2: [(17, 40), (16, 8)],
         4: [(51, 40), (16, 16)]}


@pytest.mark.parametrize("outside", [False, True], ids=["parity", "outside"])
@pytest.mark.parametrize("R,tile", [(R, t) for R, ts in TILES.items()
                                    for t in ts])
def test_ard2d_staged_walk_equals_plain_bit_for_bit(parity, R, tile,
                                                     outside):
    kit, st = parity
    args = _args(kit, st, outside)
    nt, salt = args[3], args[5]
    assert bool((nt == OUTSIDE).any()) == outside
    # the salt-blocked and the open interface bonds are both taken
    assert 0 < int(salt.sum()) < int((nt == SOLID_MG).sum())
    cp = kernels.ard2d_plain(*args)
    cs = kernels.ard2d_staged_plain(*args, R=R, tile=tile)
    assert torch.equal(_bits(cs), _bits(cp))
    # the FLUID and SOLID nodes moved, every other node was copied through
    act = (nt == FLUID) | (nt == SOLID_MG)
    assert not torch.equal(cs[act], st.C[act])
    assert torch.equal(cs[~act], st.C[~act])


def test_ard2d_staged_walk_refuses_a_tile_that_splits_a_thread(parity):
    kit, st = parity
    with pytest.raises(ValueError, match="multiple of R"):
        kernels.ard2d_staged_plain(*_args(kit, st, False), R=4,
                                   tile=(16, 30))


def test_ard2d_tables_refuse_a_wider_stencil(parity):
    kit, st = parity
    far = kit.slot_offsets.clone()
    far[0, 1] = -(HALO + 1)
    wide = dataclasses.replace(kit, slot_offsets=far)
    with pytest.raises(ValueError, match="halo"):
        kernels.ard2d_staged_plain(*_args(kit, st, False)[:-1], wide, R=2)


def test_ard2d_staged_walk_matches_the_pallas_kernel():
    """The staged walk against the JAX ard_step_pallas in the Pallas
    interpreter, at tests/test_torch_explicit.py's tolerances (rtol 1e-5,
    atol 1e-7), on that file's grid and seeded state."""
    jk, js, tk, ts = _states("f32", seed=2)
    dt = 2e-6
    pk.INTERPRET = True
    try:
        ref = pk.ard_step_pallas(js, jk, dt, VOL_LOSS)
    finally:
        pk.INTERPRET = False
    salt = t_ard.compute_salt_blocked(ts, tk)
    Ds = t_ard.solid_diffusivity(
        ts.is_gb, ts.is_precip, tk.cfg,
        t_ard.micro_d_factor(tk.cfg, VOL_LOSS, tk.dtype, tk.device))
    args = (ts.C, ts.vel, t_ns.vel_magnitude(ts.vel), ts.node_type, Ds,
            salt, dt, tk)
    out = kernels.ard2d_staged_plain(*args, R=2, tile=(16, 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.C), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(out, kernels.ard2d_plain(*args))


@pytest.mark.parametrize("tile", [(16, 32), (17, 13), (8, 8)])
def test_ard2d_staging_counts_the_tiles_with_an_active_node(parity, tile):
    kit, st = parity
    ty, tx = tile
    staged = (tx + 2 * HALO) * (ty + 2 * HALO)
    geo = Ns2dGeometry(tx, ty, 1, HALO, tx + 2 * HALO + 1, 128, staged,
                       13 * staged)
    nt = _args(kit, st, True)[3]
    tiles, busy, nbytes, halo = kernels.ard2d_staging(kit, nt, geo)
    ny, nx = kit.shape
    assert tiles == -(-ny // ty) * -(-nx // tx)
    act = ((nt == FLUID) | (nt == SOLID_MG)).numpy()
    count = sum(bool(act[y:y + ty, x:x + tx].any())
                for y in range(0, ny, ty) for x in range(0, nx, tx))
    assert busy == count and 0 < busy <= tiles
    assert nbytes == busy * staged * 14
    assert halo == staged / (tx * ty)


def test_ard2d_wrapper_on_cpu_tensors_is_the_plain_twin(parity):
    kit, st = parity
    args = _args(kit, st, True)
    before = kernels.launch_counts()
    assert torch.equal(kernels.ard2d(*args), kernels.ard2d_plain(*args))
    assert kernels.launch_counts() == before
