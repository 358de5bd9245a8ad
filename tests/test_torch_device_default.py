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


@pytest.mark.parametrize("name", ["build_kit", "build_bkit", "build_ukit"])
def test_gmres_runner_follows_the_kit_device(small, name):
    """A kit's GmresRunner keeps its basis on the kit's device and takes
    the graph route on the card only: on a CPU kit its capture raises
    DeviceUnavailable rather than running the step on the host."""
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    cfg, grid = small
    kit = CALLS[name](cfg, grid, device="cpu")
    run = gmres.GmresRunner()
    V = run.basis(3, 10, kit.dtype, kit.device)
    assert V.device.type == "cpu" and run.S.device.type == "cpu"
    assert run.F.device.type == "cpu"
    assert not gmres.runner_for(kit).graph_route
    fns = (lambda x: x, lambda x: x, gmres.basis_dots_plain,
           gmres.basis_axpy_plain)
    with pytest.raises(DeviceUnavailable):
        run.program(("solve",), lambda: gmres.cycles(run, fns),
                    graphed=True)
    if torch.cuda.is_available():
        assert gmres.runner_for(CALLS[name](cfg, grid)).graph_route


@pytest.mark.parametrize("name", ["build_kit", "build_bkit", "build_ukit"])
def test_step_graph_route_needs_a_card(small, name):
    """The implicit step's graph route is the card's: a CPU kit's
    StepRunner never takes it, and a program asked to replay with the
    runner's buffers on the CPU raises DeviceUnavailable before any of its
    work runs (no program runs on the host in its place)."""
    from pd_mg_pin_corrosion_tpu_torch import coupling
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    cfg, grid = small
    kit = CALLS[name](cfg, grid, device="cpu")
    stepper = coupling.step_runner_for(kit)
    assert not stepper.graph_route and not stepper.run.graph_route
    run = gmres.GmresRunner()
    run.setup(torch.zeros(10, dtype=kit.dtype), 3, refine=True)
    assert run.S.device.type == "cpu" and not run.S_host.is_pinned()
    ran = []
    gmres.reset_step_counts()
    with pytest.raises(DeviceUnavailable):
        run.program(("step", False), lambda: ran.append(1), graphed=True)
    assert not ran and not run.graphs
    assert gmres.STEP_COUNTS == dict.fromkeys(gmres.STEP_COUNTS, 0)
    if torch.cuda.is_available():
        assert coupling.step_runner_for(CALLS[name](cfg, grid)).graph_route
