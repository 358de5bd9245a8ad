"""The port's public constructors put their tensors on the card unless the
caller asks for the CPU: ``build_kit``, ``amr_blocks.build_bkit``,
``unstructured.build_ukit``, ``initialize_state`` and ``state_from_numpy``
default to CUDA, and so does a mesh (``parallel.sharding.make_mesh``,
whose device ``shard_kit`` and ``shard_state`` use). Without a card they
raise ``DeviceUnavailable``, whose message names ``device="cpu"``; they
never fall back to the CPU quietly. Whether there is a card is decided
inside each test (on the card the same calls must give CUDA tensors)."""

import os

import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu_torch import (Config, build_grid, build_kit,
                                           initialize_state, state_from_numpy)
from pd_mg_pin_corrosion_tpu_torch.amr_blocks import (build_amr_block_grid,
                                                      build_bkit)
from pd_mg_pin_corrosion_tpu_torch.amr import build_amr_grid
from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable
from pd_mg_pin_corrosion_tpu_torch.unstructured import build_ukit

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")


@pytest.fixture(scope="module")
def small():
    cfg = Config.load(PARITY)
    return cfg, build_grid(cfg)


def _arrays(grid):
    st = initialize_state(grid, Config.load(PARITY), device="cpu")
    return {name: t.numpy() for name, t in vars(st).items()}


def _bkit(cfg, **kw):
    """The block-AMR kit of parity.cfg with use_amr = 1."""
    amr = Config.load(PARITY)
    amr.apply_overrides(["use_amr=1", "amr_ratio=2"])
    return build_bkit(build_amr_block_grid(amr), amr, **kw)


def _ukit(cfg, **kw):
    """The gather kit of parity.cfg with use_amr = 1, amr_backend = gather."""
    amr = Config.load(PARITY)
    amr.apply_overrides(["use_amr=1", "amr_ratio=2", "amr_backend=gather"])
    return build_ukit(build_amr_grid(amr), amr, **kw)


CALLS = {
    "build_kit": lambda cfg, grid, **kw: build_kit(grid, cfg, **kw),
    "build_bkit": lambda cfg, grid, **kw: _bkit(cfg, **kw),
    "build_ukit": lambda cfg, grid, **kw: _ukit(cfg, **kw),
    "initialize_state": lambda cfg, grid, **kw: initialize_state(grid, cfg,
                                                                 **kw),
    "state_from_numpy": lambda cfg, grid, **kw: state_from_numpy(
        _arrays(grid), **kw),
}


def _tensors(out):
    if hasattr(out, "tensors"):
        return out.tensors()
    return [v for v in vars(out).values() if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", list(CALLS))
def test_constructor_asks_for_cuda_by_default(small, name):
    cfg, grid = small
    if torch.cuda.is_available():
        out = CALLS[name](cfg, grid)
        assert all(t.is_cuda for t in _tensors(out))
    else:
        with pytest.raises(DeviceUnavailable, match='device="cpu"'):
            CALLS[name](cfg, grid)
        with pytest.raises(DeviceUnavailable, match='device="cpu"'):
            CALLS[name](cfg, grid, device="cuda")


@pytest.mark.parametrize("name", list(CALLS))
def test_constructor_on_the_cpu_when_asked(small, name):
    cfg, grid = small
    out = CALLS[name](cfg, grid, device="cpu")
    tensors = _tensors(out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_the_cpu_state_is_the_numpy_round_trip(small):
    cfg, grid = small
    st = initialize_state(grid, cfg, device="cpu")
    again = state_from_numpy(_arrays(grid), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st.tensors(),
                                                  again.tensors()))
    assert np.array_equal(again.node_type.numpy(), grid.node_type)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_asks_for_cuda_by_default(one_rank_group):
    from pd_mg_pin_corrosion_tpu_torch.parallel.sharding import make_mesh

    if torch.cuda.is_available():
        assert make_mesh(1, backend="gloo").device.type == "cuda"
    else:
        with pytest.raises(DeviceUnavailable, match='device="cpu"'):
            make_mesh(1, backend="gloo")
    assert make_mesh(1, backend="gloo", device="cpu").device.type == "cpu"


def test_shard_kit_and_state_on_the_mesh_device(small, one_rank_group):
    from pd_mg_pin_corrosion_tpu_torch.parallel.sharding import (
        Mesh, make_mesh, shard_kit, shard_state)

    cfg, grid = small
    kit = build_kit(grid, cfg, device="cpu")
    st = initialize_state(grid, cfg, device="cpu")
    mesh = make_mesh(1, backend="gloo", device="cpu")
    sk = shard_kit(kit, mesh)
    assert all(t.device.type == "cpu" for t in _tensors(sk))
    assert all(t.device.type == "cpu" for t in shard_state(st, mesh).tensors())
    if not torch.cuda.is_available():
        card = Mesh(rank=0, size=1, group=None, backend="gloo",
                    device=torch.device("cuda"))
        with pytest.raises(DeviceUnavailable, match='device="cpu"'):
            shard_kit(kit, card)
