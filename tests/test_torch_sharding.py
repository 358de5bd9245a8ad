"""The port's axial-slab sharding (``parallel/``) against one rank and
against the JAX package's single device, on the CPU.

The ranks run as processes (``parallel.launch.spawn``, gloo, device
"cpu", one thread each); the rank functions live in the port
(``parallel.checks``), and the JAX references are computed here. One spawn
per rank count runs every step check (``checks.batch``). Each check holds
the sharded result to the single rank's bits where a node's arithmetic is
the single rank's (the NS steps, the wall BC, the matvecs, the explicit
step), and to JAX tests/test_sharding.py's tolerances against the JAX
package on the same padded grid (1e-12 for the NS steps and ard_step,
1e-8 for implicit_step, whose GMRES sums over the mesh)."""

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
from pd_mg_pin_corrosion_tpu.grid import pad_grid_axial as j_pad
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu.ops.ard import ard_step as j_ard_step
from pd_mg_pin_corrosion_tpu.ops.ns import ns_step as j_ns_step
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import initialize_state as t_initialize_state
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
from pd_mg_pin_corrosion_tpu_torch.grid import pad_grid_axial as t_pad
from pd_mg_pin_corrosion_tpu_torch.kernels import pack_stencil
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.parallel import checks
from pd_mg_pin_corrosion_tpu_torch.parallel.launch import spawn
from pd_mg_pin_corrosion_tpu_torch.parallel.sharding import (Mesh, make_mesh,
                                                             shard_kit)

torch.set_num_threads(2)

RANKS = (2, 4)
PAD = 4   # every grid padded to a multiple of 4 rows: 1, 2 and 4 ranks


def small_cfg(C):
    """JAX tests/test_sharding.py small_cfg (2D, f64; 51 rows, 52 padded)."""
    cfg = C()
    cfg.dx = 5.0e-6
    cfg.R_wire = 20.0e-6
    cfg.L_wire = 100.0e-6
    cfg.R_tube = 60.0e-6
    cfg.L_upstream = 60.0e-6
    cfg.L_downstream = 60.0e-6
    cfg.D_grain = 5.0e-11
    cfg.D_gb = 5.0e-9
    cfg.precision = "f64"
    return cfg.compute_derived()


def cfg_3d(C, precision="f64", *overrides):
    """JAX tests/test_sharding.py's 3D grid (23 rows, 24 padded)."""
    cfg = C()
    cfg.dim = 3
    cfg.dx = 8.0e-6
    cfg.R_wire = 16.0e-6
    cfg.L_wire = 64.0e-6
    cfg.R_tube = 48.0e-6
    cfg.L_upstream = 32.0e-6
    cfg.L_downstream = 32.0e-6
    cfg.Q_flow = 1.667e-10
    cfg.precision = precision
    cfg.apply_overrides(list(overrides))
    return cfg.compute_derived()


def cfg_2d_f32(C):
    """JAX tests/test_shard_kernels.py _cfg_2d (f32, 58 rows, 60 padded)."""
    cfg = C()
    cfg.dx = 4.0e-6
    cfg.R_wire = 20e-6
    cfg.L_wire = 80e-6
    cfg.R_tube = 60e-6
    cfg.L_upstream = 60e-6
    cfg.L_downstream = 60e-6
    cfg.precision = "f32"
    return cfg.compute_derived()


def seeded(grid, cfg, seed=0):
    """The initial fields with a developed C (salt-blocking levels among
    them, next to slab ends), a perturbed velocity and GB / precipitate
    solid nodes, as numpy arrays by field name."""
    st = t_initialize_state(grid, cfg, dtype=torch.float64, device="cpu")
    h = {k: v.numpy().copy() for k, v in vars(st).items()}
    rng = np.random.default_rng(seed)
    solid = h["node_type"] == 1
    fluid = h["node_type"] == 0
    h["C"] = np.where(solid, 0.6 + 0.4 * rng.random(solid.shape),
                      0.05 * rng.random(solid.shape))
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95
    h["vel"] = np.where(fluid[..., None],
                        h["vel"] + rng.normal(0, 0.01, h["vel"].shape),
                        h["vel"])
    h["is_gb"] = solid & (rng.random(solid.shape) < 0.3)
    h["is_precip"] = solid & ~h["is_gb"] & (rng.random(solid.shape) < 0.2)
    return h


class Case:
    """A configuration on the port's padded grid and the JAX package's."""

    def __init__(self, make, *args):
        self.cfg = make(TConfig, *args)
        self.jcfg = make(JConfig, *args)
        self.grid = t_pad(t_build_grid(self.cfg), PAD)
        self.jgrid = j_pad(j_build_grid(self.jcfg), PAD)
        self.arrays = seeded(self.grid, self.cfg)

    def port(self, arrays=True):
        kit = t_build_kit(self.grid, self.cfg, device="cpu")
        if arrays:
            st = state_from_numpy(self.arrays, dtype=kit.dtype, device="cpu")
        else:
            st = t_initialize_state(self.grid, self.cfg, dtype=kit.dtype,
                                    device="cpu")
        return kit, st

    def jax(self, arrays=True):
        kit = j_build_kit(self.jgrid, self.jcfg)
        st = j_initialize_state(self.jgrid, self.jcfg, dtype=kit.jdtype)
        if arrays:
            st = type(st)(**{f.name: jnp.asarray(
                self.arrays[f.name], getattr(st, f.name).dtype)
                for f in dataclasses.fields(st)})
        return kit, st


@pytest.fixture(scope="module")
def cases():
    return {
        "2d": Case(small_cfg),
        "3d": Case(cfg_3d),
        "3d_subcell": Case(cfg_3d, "f64", "wall_mirror_subcell=1"),
        "2d_f32": Case(cfg_2d_f32),
        "3d_f32": Case(cfg_3d, "f32"),
    }


def _jobs(c):
    return [
        (checks.halo_ends, (c["2d"].grid, c["2d"].cfg)),
        (checks.ns_steps, (c["2d"].grid, c["2d"].cfg, 1e-7)),
        (checks.ns_steps, (c["3d"].grid, c["3d"].cfg, 1e-8, True)),
        (checks.ns_steps, (c["3d_subcell"].grid, c["3d_subcell"].cfg, 1e-8,
                           True, c["3d_subcell"].arrays)),
        (checks.transport, (c["2d"].grid, c["2d"].cfg, 1e-4, 0.5,
                            c["2d"].arrays)),
        (checks.transport, (c["3d"].grid, c["3d"].cfg, 1e-4, 0.5,
                            c["3d"].arrays)),
        (checks.matvecs, (c["2d_f32"].grid, c["2d_f32"].cfg,
                          c["2d_f32"].arrays)),
        (checks.matvecs, (c["3d_f32"].grid, c["3d_f32"].cfg,
                          c["3d_f32"].arrays)),
    ]


NAMES = ("halo", "ns2d", "ns3d_wall", "ns3d_subcell", "transport2d",
         "transport3d", "matvec2d", "matvec3d")
_RESULTS = {}


@pytest.fixture
def sharded(cases):
    """{rank count: {check: rank 0's result}}, one spawn a rank count."""
    def get(n):
        if n not in _RESULTS:
            _RESULTS[n] = dict(zip(NAMES, spawn(checks.batch, n, "gloo",
                                                "cpu", _jobs(cases))[0]))
        return _RESULTS[n]
    return get


def _single_wall_ns(kit, st, dt):
    ops = ops_for(kit)
    st = ops.apply_wall_bc(st, kit)
    st = ops.ns_step(st, kit, dt)
    return ops.apply_wall_bc(st, kit)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,multiple", [("2d", 4), ("2d", 8), ("3d", 4),
                                          ("3d", 8)])
def test_pad_grid_axial_matches_jax(cases, dim, multiple):
    c = cases[dim]
    t = t_pad(t_build_grid(c.cfg), multiple)
    j = j_pad(j_build_grid(c.jcfg), multiple)
    assert t.shape == j.shape and t.shape[0] % multiple == 0
    for f in ("dim", "Nx", "Ny", "Nz", "dx", "delta", "m", "origin"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("node_type", "pos", "mirror_idx"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    for f in ("offsets", "dist", "evec", "vol"):
        np.testing.assert_array_equal(getattr(t.stencil, f),
                                      getattr(j.stencil, f), f)


@pytest.mark.parametrize("n", RANKS)
def test_halo_pair_zeros_at_the_domain_ends(sharded, n):
    assert sharded(n)["halo"] is True


@pytest.mark.parametrize("n", RANKS)
def test_ns_step_2d_bitwise_and_within_jax(cases, sharded, n):
    """JAX test_sharded_ns_step_matches_single_device (f64, dt 1e-7)."""
    rho, vel = sharded(n)["ns2d"]
    c = cases["2d"]
    kit, st = c.port(arrays=False)
    one = ops_for(kit).ns_step(st, kit, 1e-7)
    np.testing.assert_array_equal(rho, one.rho.numpy())
    np.testing.assert_array_equal(vel, one.vel.numpy())
    jk, js = c.jax(arrays=False)
    ref = jax.jit(lambda s: j_ns_step(s, jk, 1e-7))(js)
    np.testing.assert_allclose(rho, np.asarray(ref.rho), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(vel, np.asarray(ref.vel), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("n", RANKS)
def test_ns_step_3d_with_wall_bc_bitwise_and_within_jax(cases, sharded, n):
    """JAX test_sharded_3d_step_matches_single_device: wall BC, NS step,
    wall BC (f64, dt 1e-8)."""
    rho, vel = sharded(n)["ns3d_wall"]
    c = cases["3d"]
    kit, st = c.port(arrays=False)
    one = _single_wall_ns(kit, st, 1e-8)
    np.testing.assert_array_equal(rho, one.rho.numpy())
    np.testing.assert_array_equal(vel, one.vel.numpy())
    jk, js = c.jax(arrays=False)

    def step(s):
        s = j_bc.apply_wall_bc(s, jk)
        s = j_ns_step(s, jk, 1e-8)
        return j_bc.apply_wall_bc(s, jk)
    ref = jax.jit(step)(js)
    np.testing.assert_allclose(rho, np.asarray(ref.rho), rtol=1e-12)
    np.testing.assert_allclose(vel, np.asarray(ref.vel), rtol=1e-12,
                               atol=1e-18)


@pytest.mark.parametrize("n", RANKS)
def test_subcell_wall_mirror_under_the_mesh_is_bitwise(cases, sharded, n):
    """wall_mirror_subcell (its sources in the node's own z-plane, inside
    the slab) on a seeded state: the single rank's bits."""
    rho, vel = sharded(n)["ns3d_subcell"]
    kit, st = cases["3d_subcell"].port()
    assert kit.mirror_sub_dst.numel() > 0
    one = _single_wall_ns(kit, st, 1e-8)
    np.testing.assert_array_equal(rho, one.rho.numpy())
    np.testing.assert_array_equal(vel, one.vel.numpy())


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("n", RANKS)
def test_ard_step_bitwise_and_within_jax(cases, sharded, n, dim):
    """The explicit step on a seeded state with salt-blocked solid nodes
    (the mask exchanged a second time): the single rank's bits, and JAX's
    ard_step within 1e-12."""
    C_ard = sharded(n)[f"transport{dim}"][0]
    c = cases[dim]
    kit, st = c.port()
    np.testing.assert_array_equal(
        C_ard, ops_for(kit).ard_step(st, kit, 1e-4).C.numpy())
    jk, js = c.jax()
    ref = jax.jit(lambda s: j_ard_step(s, jk, 1e-4))(js)
    np.testing.assert_allclose(C_ard, np.asarray(ref.C), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("n", RANKS)
def test_implicit_step_within_jax(cases, sharded, n, dim):
    """assemble + implicit_step (dt 0.5, f64 GMRES with its dots summed
    over the mesh): residual below 1e-9, C within 1e-8 of JAX's and of the
    single rank's."""
    _, C, res = sharded(n)[f"transport{dim}"]
    assert res < 1e-9
    c = cases[dim]
    kit, st = c.port()
    ops = ops_for(kit)
    one, _ = ops.implicit_step(st, ops.assemble(st, kit), kit, 0.5)
    np.testing.assert_allclose(C, one.C.numpy(), rtol=1e-8, atol=1e-12)
    jk, js = c.jax()
    op = jax.jit(lambda s: j_ai.assemble(s, jk))(js)
    ref, _ = jax.jit(lambda s, o: j_ai.implicit_step(s, o, jk, 0.5))(js, op)
    np.testing.assert_allclose(C, np.asarray(ref.C), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("n", RANKS)
def test_matvec_f32_2d_bitwise(cases, sharded, n):
    (y,) = sharded(n)["matvec2d"]
    kit, st = cases["2d_f32"].port()
    op = t_ai.assemble(st, kit)
    np.testing.assert_array_equal(
        y, t_ai.matvec_M(op, kit, st.C + 0.3 * kit.v_pois).numpy())


@pytest.mark.parametrize("n", RANKS)
def test_matvec_f32_3d_dense_bf16_and_packed_bitwise(cases, sharded, n):
    """The 3D operator's f32 weights, its bf16 copy and its packed form
    (packed on each rank's extended slab) against one rank's."""
    y, y16, y_packed = sharded(n)["matvec3d"]
    kit, st = cases["3d_f32"].port()
    op = t_ai.assemble(st, kit)
    x = st.C + 0.3 * kit.v_pois
    np.testing.assert_array_equal(y, t_ai.matvec_M(op, kit, x).numpy())
    np.testing.assert_array_equal(
        y16, t_ai.matvec_M(op, kit, x, op.W16).numpy())
    op.packed = pack_stencil(op.W, op.unknown, kit)
    np.testing.assert_array_equal(y_packed,
                                  t_ai.matvec_M(op, kit, x).numpy())


# ---------------------------------------------------------------------------
# What the mesh does not carry raises

def _mesh(size=2, rank=0):
    """A mesh that only slices (no process group): shard_kit's checks."""
    return Mesh(rank=rank, size=size, group=None, backend="gloo",
                device=torch.device("cpu"))


def _parity_kit(*overrides):
    import os
    cfg = TConfig.load(os.path.join(os.path.dirname(__file__), "golden",
                                    "parity.cfg"))
    cfg.apply_overrides(list(overrides))
    return cfg


def test_shard_kit_raises_for_block_amr():
    from pd_mg_pin_corrosion_tpu_torch.amr_blocks import (
        build_amr_block_grid, build_bkit)
    cfg = _parity_kit("use_amr=1", "amr_ratio=2")
    bkit = build_bkit(build_amr_block_grid(cfg), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="AMR"):
        shard_kit(bkit, _mesh())


def test_shard_kit_raises_for_gather_amr():
    from pd_mg_pin_corrosion_tpu_torch.amr import build_amr_grid
    from pd_mg_pin_corrosion_tpu_torch.unstructured import build_ukit
    cfg = _parity_kit("use_amr=1", "amr_ratio=2", "amr_backend=gather")
    ukit = build_ukit(build_amr_grid(cfg), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="AMR"):
        shard_kit(ukit, _mesh())


@pytest.mark.parametrize("override,match", [("gs_parity=1", "gs_parity"),
                                            ("flow_warm_start=2",
                                             "flow_warm_start")])
def test_shard_kit_raises_for_unsharded_features(override, match):
    cfg = _parity_kit(override)
    grid = t_pad(t_build_grid(cfg), 2)
    with pytest.raises(NotImplementedError, match=match):
        shard_kit(t_build_kit(grid, cfg, device="cpu"), _mesh())


def test_shard_kit_raises_for_a_slab_thinner_than_its_halo(cases):
    c = cases["3d"]     # 24 rows: 8 ranks give 3-row slabs, halo 4
    kit = t_build_kit(c.grid, c.cfg, device="cpu")
    with pytest.raises(ValueError, match="thinner than its halo"):
        shard_kit(kit, _mesh(8))


def test_shard_kit_raises_for_an_inlet_band_across_ranks(cases):
    c = cases["2d"]     # 52 rows; the inlet band holds 4
    kit = t_build_kit(c.grid, c.cfg, device="cpu")
    assert kit.inlet_rows == 4
    with pytest.raises(ValueError, match="inlet band"):
        shard_kit(dataclasses.replace(kit, inlet_rows=14), _mesh(4))


def test_shard_kit_localises_the_bands_and_the_mirror(cases):
    """Rank 0 holds the inlet band, the last rank the outlet band, both in
    extended-slab rows; every own wall node's mirror source lands on the
    same node as the global table's."""
    c = cases["2d"]
    kit = t_build_kit(c.grid, c.cfg, device="cpu")
    h, N = kit.mext, kit.shape[0]
    plane = kit.shape[1]
    for rank in range(4):
        sk = shard_kit(kit, _mesh(4, rank))
        slab = sk.slab
        assert sk.shape == (slab.rows + 2 * h,) + kit.shape[1:]
        assert sk.inlet_rows == (h + kit.inlet_rows if rank == 0 else 0)
        assert sk.outlet_rows == (kit.outlet_rows - slab.row0 + h
                                  if rank == 3 else sk.shape[0])
        lo = slab.row0 - h
        own = torch.zeros(sk.shape, dtype=torch.bool)
        own[slab.own] = True
        dst = (sk.mirror_mask & own).reshape(-1).nonzero().squeeze(1)
        got = sk.mirror_src.reshape(-1)[dst] + lo * plane
        want = kit.mirror_src.reshape(-1)[dst + lo * plane]
        assert dst.numel() > 0 and torch.equal(got, want)
        assert not bool(sk.mirror_mask[~own].any())
        assert N == slab.n_global


def test_make_mesh_nccl_raises_without_cards(monkeypatch):
    """NCCL refuses here (no NCCL in this PyTorch, or fewer cards than
    ranks); make_mesh raises instead of falling back."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29555")
    with pytest.raises(RuntimeError, match="NCCL"):
        make_mesh(2, backend="nccl")


def test_make_mesh_raises_without_a_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, backend="gloo", device="cpu")
