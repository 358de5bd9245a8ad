"""The flow solve's FlowRunner (``solvers.FlowRunner``): the in-place body
that the CUDA graph captures, run on the CPU as the graph would replay it.

Within the port, bit for bit: ``solve_steady`` through the runner against
the functional loop it replaced (kept below as the reference), across a
check boundary, the dt refresh at iteration 200, a break on convergence
that keeps the pre-step buffers and the blow-up guard, on the three kit
kinds (parity.cfg 2D f64, the 8,303-node 3D grid f32, the block grid of
tests/test_amr_coupled.py, the gather grid of
tests/test_torch_amr_gather_coupled.py); two solves through one cached
runner with node_type and C changed in between against fresh runners.
Against the JAX package's ``solve_steady`` on parity.cfg f64, the gates of
tests/test_torch_implicit.py: iterations, conv and div exact, eps and the
fields within 1e-9.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from test_torch_amr_blocks import COUPLED

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu import solvers as j_solvers
from pd_mg_pin_corrosion_tpu_torch import Config, cli, kernels, solvers
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.config import FrozenConfig
from pd_mg_pin_corrosion_tpu_torch.dispatch import is_structured, ops_for
from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable, State
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, SOLID_MG

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
# tests/test_torch_3d_implicit.py's 8,303-node grid
SMALL_3D = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "Q_flow=1.667e-10", "eta_density=1.0", "D_grain=5e-11",
            "D_gb=5e-9"]
KITS = {
    "parity_f64": (PARITY, ["precision=f64"]),
    "grid3d_f32": (os.devnull, [*SMALL_3D, "precision=f32"]),
    "blocks_f64": (os.devnull, [*COUPLED, "precision=f64"]),
    "gather_f64": (os.devnull, [*COUPLED, "amr_backend=gather",
                                "precision=f64"]),
}


@functools.cache
def _built(name):
    """(kit, initial state) of a named configuration, on the CPU; cached,
    so the tests of one file share each kit and its runner."""
    path, overrides = KITS[name]
    cfg = Config.load(path)
    cfg.apply_overrides(overrides)
    _, kit, state = cli.build(cfg.compute_derived(), "cpu")
    return kit, state


def reference_solve(state, kit, cap):
    """The functional loop the runner replaced: every iteration a new
    State, checks at 1-10 and every 100th, dt refreshed at it % 200 == 0,
    the pre-step buffers kept on a break."""
    cfg = kit.cfg
    ops = ops_for(kit)
    corrections = cfg.channel_flow_corrections and is_structured(kit)
    dt = ops.compute_dt_ns(state, kit)
    it, eps, conv, div = 1, 1.0, False, False
    while it <= cap:
        st_bc = solvers._pre_bcs(state, kit, ops)
        st_new = ops.ns_step(st_bc, kit, dt)
        st_new = ops.apply_wall_bc(st_new, kit)
        if corrections:
            st_new = solvers._channel_flow_corrections(st_new, kit)
        if it <= 10 or it % 100 == 0:
            eps, _, _, _, eps_ok, div = solvers._check(st_bc, st_new, kit)
            conv = eps_ok and it > 100
            if conv or div:
                state = st_bc
                break
        state = ops.update_fictitious(st_new, kit)
        if it % 200 == 0:
            dt = ops.compute_dt_ns(state, kit)
        it += 1
    state = dataclasses.replace(state, pressure=ops.tait_pressure(state.rho,
                                                                   kit))
    return state, it, eps, conv, div


def _bits(t):
    """A float tensor as integers of its width (NaNs compare equal)."""
    if t.is_floating_point():
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_same(got, ref):
    """States equal bit for bit, and (iters, eps, conv, div) equal (repr:
    a NaN eps equals a NaN eps)."""
    (gs, *gn), (rs, *rn) = got, ref
    assert repr(gn) == repr(rn)
    for f in dataclasses.fields(State):
        a, b = getattr(gs, f.name), getattr(rs, f.name)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f.name


def _kit_cfg(kit, **keys):
    """A copy of the kit (and, for a block kit, of its blocks) whose
    frozen cfg has ``keys`` replaced: a kit of its own, so it gets a runner
    of its own."""
    def re(k):
        return FrozenConfig(dataclasses.replace(
            object.__getattribute__(k.cfg, "_cfg"), **keys))
    if hasattr(kit, "fine"):
        return dataclasses.replace(kit, cfg=re(kit), fine=dataclasses.replace(
            kit.fine, cfg=re(kit.fine)), coarse=dataclasses.replace(
            kit.coarse, cfg=re(kit.coarse)))
    return dataclasses.replace(kit, cfg=re(kit))


# (configuration, cfg keys, cap, (iters, conv, div) of the run)
CASES = {
    # exhausts the cap: checks 1-10, 100 and 200, the dt refresh at 200
    "parity_cap": ("parity_f64", {}, 250, (251, False, False)),
    # converges at the 400th iteration (tests/test_torch_implicit.py)
    "parity_converges": ("parity_f64", {"flow_conv_tol": 1.2e-3}, 1000,
                         (400, True, False)),
    # too large a step: the guard trips at the 100th (NaN velocities)
    "parity_blows_up": ("parity_f64", {"cfl_factor": 1.5}, 1000,
                        (100, False, True)),
    "parity_corrections": ("parity_f64", {"channel_flow_corrections": 1},
                           250, (251, False, False)),
    "grid3d_cap": ("grid3d_f32", {}, 201, (202, False, False)),
    "blocks_cap": ("blocks_f64", {}, 250, (251, False, False)),
    "gather_cap": ("gather_f64", {}, 250, (251, False, False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_equals_the_functional_loop(case):
    """solve_steady through the runner's in-place body, bit for bit the
    functional loop's state and (iters, eps, conv, div)."""
    name, keys, cap, expect = CASES[case]
    kit, state = _built(name)
    if keys:
        kit = _kit_cfg(kit, **keys)
    solvers.reset_flow_counts()
    got = solvers.solve_steady(state, kit, max_iters=cap)
    counts = dict(solvers.FLOW_COUNTS)
    run = solvers.runner_for(kit)
    _assert_same(got, reference_solve(state, kit, cap))
    assert (got[1], got[3], got[4]) == expect
    # on the CPU every iteration is a direct call of the body
    assert counts == {"replays": 0, "eager": min(got[1], cap),
                      "captures": 0}
    assert run.graph is None and not run.graph_route
    # the eager argument takes the same route here
    _assert_same(solvers.solve_steady(state, kit, max_iters=cap, eager=True),
                 got)


def _changed(state, seed):
    """The state after a phase change: a few SOLID nodes turned FLUID
    (phase 1, C below saturation) and C perturbed everywhere."""
    rng = np.random.default_rng(seed)
    nt = state.node_type.clone()
    solid = (nt == SOLID_MG).reshape(-1).nonzero().reshape(-1)
    pick = solid[torch.as_tensor(rng.permutation(solid.numel())[:5])]
    nt.view(-1)[pick] = FLUID
    phase = state.phase.clone()
    phase.view(-1)[pick] = 1
    noise = torch.as_tensor(rng.random(state.C.shape), dtype=state.C.dtype)
    return dataclasses.replace(state, node_type=nt, phase=phase,
                               C=state.C * (0.9 + 0.1 * noise))


@pytest.mark.parametrize("name", sorted(KITS))
def test_cached_runner_reads_the_new_state(name):
    """Two solves through one cached runner, node_type and C changed in
    between, give what two fresh runners give: no buffer keeps a previous
    solve's node types."""
    kit, state = _built(name)
    kit = _kit_cfg(kit)   # a runner of this test's own
    first, *_ = solvers.solve_steady(state, kit, max_iters=120)
    run = solvers.runner_for(kit)
    second = solvers.solve_steady(_changed(first, 1), kit, max_iters=150)
    assert solvers.runner_for(kit) is run

    fresh = _kit_cfg(kit)
    ref_first, *_ = solvers.solve_steady(state, fresh, max_iters=120)
    _assert_same((first,), (ref_first,))
    solvers._runners.pop(fresh)
    ref_second = solvers.solve_steady(_changed(ref_first, 1), fresh,
                                      max_iters=150)
    assert solvers.runner_for(fresh) is not run
    _assert_same(second, ref_second)
    _assert_same(second, reference_solve(_changed(first, 1), kit, 150))
    # the node type change reached the solve
    assert not torch.equal(second[0].node_type, first.node_type)


def test_result_shares_no_buffer_with_the_runner():
    """The returned state's tensors are the caller's own (fields the flow
    never writes) or fresh copies: the next solve cannot overwrite them."""
    kit, state = _built("parity_f64")
    kit = _kit_cfg(kit)
    out, *_ = solvers.solve_steady(state, kit, max_iters=20)
    run = solvers.runner_for(kit)
    bufs = {t.data_ptr() for t in run.state.tensors()}
    assert not bufs & {t.data_ptr() for t in out.tensors()}
    for f in ("node_type", "phase", "D_map", "grain_id", "is_gb",
              "is_precip"):
        assert getattr(out, f) is getattr(state, f)
    assert run.written == {"rho", "vel", "pressure", "C"}
    keep = [t.clone() for t in out.tensors()]
    solvers.solve_steady(_changed(out, 2), kit, max_iters=20)
    assert all(torch.equal(a, b) for a, b in zip(out.tensors(), keep))


def test_capture_needs_a_card():
    """The graph route is the card's: capturing on a CPU kit raises
    DeviceUnavailable, and a CPU kit never takes the graph route."""
    kit, _ = _built("parity_f64")
    run = solvers.runner_for(kit)
    assert not run.graph_route
    with pytest.raises(DeviceUnavailable):
        run.capture(kit)


def test_add_launch_counts_adds_to_the_wrappers():
    """What a replay adds: each named kernel's launches to its wrapper's
    counter (per counter attribute), the others untouched."""
    before = kernels.launch_counts()
    try:
        kernels.add_launch_counts({"ns2d": 3, "matvec3d_bf16": 2})
        after = kernels.launch_counts()
        assert after["ns2d"] == before["ns2d"] + 3
        assert after["matvec3d_bf16"] == before["matvec3d_bf16"] + 2
        assert after["matvec3d"] == before["matvec3d"]
        assert kernels.matvec3d.launches_bf16 == after["matvec3d_bf16"]
    finally:
        kernels.add_launch_counts({"ns2d": -3, "matvec3d_bf16": -2})
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("keys, expect", [
    ({"flow_conv_tol": 1.2e-3}, (400, True, False)),
    ({}, (251, False, False)),
], ids=["converges", "cap"])
def test_runner_against_jax_solve_steady(keys, expect):
    """parity.cfg f64 from the same initial state: the JAX package's
    on-device segment loop and the port's runner."""
    j = JConfig.load(PARITY)
    j.apply_overrides(["precision=f64"] + [f"{k}={v}" for k, v in
                                            keys.items()])
    jg = j_build_grid(j)
    jk = j_build_kit(jg, j)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    kit = _kit_cfg(_built("parity_f64")[0], **keys)
    state = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                              for f in dataclasses.fields(js)},
                             dtype=torch.float64, device="cpu")
    cap = 1000 if keys else 250
    jst, jit_, jeps, jconv, jdiv = j_solvers.solve_steady(js, jk,
                                                          max_iters=cap)
    tst, tit, teps, tconv, tdiv = solvers.solve_steady(state, kit,
                                                       max_iters=cap)
    assert (int(jit_), bool(jconv), bool(jdiv)) == (tit, tconv, tdiv) == expect
    np.testing.assert_allclose(teps, float(jeps), rtol=1e-9)
    for t, a in ((tst.rho, jst.rho), (tst.vel, jst.vel),
                 (tst.pressure, jst.pressure), (tst.C, jst.C)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-9)
