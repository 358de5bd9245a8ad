"""The explicit step's ExplicitRunner (``coupling.ExplicitRunner``): the
in-place body that the CUDA graph captures, run on the CPU as the graph
would replay it.

Within the port, bit for bit: ``explicit_chunk`` through the runner
against the functional loop it replaced (kept below as the reference), two
cycles with different dt and volume loss through one cached runner (the
second cycle's values reach the step through the runner's 0-d buffers),
on parity.cfg 2D f32 and f64, the 8,303-node 3D grid, the block grid of
tests/test_amr_coupled.py and its gather grid, each with a volume-loss
decay so that the volume loss changes the step; the CLI's explicit run
through the runner against the CLI through the old loop, CSV and VTI bytes.
Against the JAX package's ``explicit_chunk`` on parity.cfg f64 (five
steps), to round-off. The ard2d wrapper with a 0-d tensor dt (the graph's
dt buffer) against a float dt; the graph route's conditions; a capture
without a card raises.
"""

import dataclasses
import functools
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_amr_blocks import COUPLED
from test_torch_flow_graph import SMALL_3D

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import coupling as j_coupling
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu_torch import Config, cli, coupling, kernels
from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable, State
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, SOLID_MG
from pd_mg_pin_corrosion_tpu_torch.ops import ard as t_ard
from pd_mg_pin_corrosion_tpu_torch.ops.ns import vel_magnitude
from pd_mg_pin_corrosion_tpu_torch.solvers import graph_refusal

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
# the micro-diffusivity's volume-loss decay (off in these configurations),
# so that the volume loss reaches the step
DECAY = "corrosion_decay_l=0.5"
KITS = {
    "parity_f32": (PARITY, ["precision=f32", DECAY]),
    "parity_f64": (PARITY, ["precision=f64", DECAY]),
    "grid3d_f32": (os.devnull, [*SMALL_3D, "precision=f32", DECAY]),
    "blocks_f32": (os.devnull, [*COUPLED, "precision=f32", DECAY]),
    "gather_f32": (os.devnull, [*COUPLED, "amr_backend=gather",
                                "precision=f32", DECAY]),
}
STEPS = 4


def _seeded(state, kit, seed):
    """``state`` with FLUID velocities perturbed and C seeded: SOLID_MG in
    [0.5, 1), FLUID 0.95 u^4 for u uniform in [0, 1) (about 1 % reach C_sat
    and salt-block their solid neighbours' bonds, and on every grid some
    interface nodes stay open), the rest as it was."""
    rng = np.random.default_rng(seed)
    nt = state.node_type.numpy()
    fluid = nt == FLUID
    vel = state.vel.numpy() + np.where(
        fluid[..., None], rng.normal(0, 0.05 * kit.cfg.U_in,
                                     state.vel.shape), 0.0)
    C = np.where(nt == SOLID_MG, 1.0 - 0.5 * rng.random(nt.shape),
                 np.where(fluid, 0.95 * rng.random(nt.shape) ** 4,
                          state.C.numpy()))
    return dataclasses.replace(state, vel=torch.tensor(vel, dtype=kit.dtype),
                               C=torch.tensor(C, dtype=kit.dtype))


@functools.cache
def _built(name):
    """(kit, seeded state) of a named configuration, on the CPU; cached, so
    the tests of one file share each kit and its runner."""
    path, overrides = KITS[name]
    cfg = Config.load(path)
    cfg.apply_overrides(overrides)
    _, kit, state = cli.build(cfg.compute_derived(), "cpu")
    return kit, _seeded(state, kit, seed=len(name))


def reference_chunk(state, kit, dt, vol_loss, n):
    """The functional loop the runner replaced: every op a new State."""
    ops = ops_for(kit)
    for _ in range(n):
        state = ops.apply_inlet_bc(state, kit)
        state = ops.apply_outlet_bc(state, kit)
        state = ops.apply_wall_concentration_bc(state, kit)
        state = ops.ard_step(state, kit, dt, vol_loss)
    return state


def _bits(t):
    """A float tensor as integers of its width (NaNs compare equal)."""
    if t.is_floating_point():
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_same(got, ref):
    for f in dataclasses.fields(State):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f.name


@pytest.mark.parametrize("name", sorted(KITS))
def test_two_cycles_through_one_runner_equal_the_functional_loop(name):
    """Two cycles of STEPS steps, the second with another dt (a Python
    float) and volume loss (a 0-d tensor), through the kit's cached
    runner: every field bit for bit the functional loop's; the second
    cycle's dt and volume loss both change its result; the fields the
    step does not replace are the caller's own tensors; every step eager,
    no capture on the CPU."""
    kit, st = _built(name)
    run = coupling.explicit_runner_for(kit)
    assert run.refusal == "the CPU" and not run.graph_route
    coupling.reset_explicit_counts()
    dt1 = float(ops_for(kit).ard_compute_dt(st, kit))
    vol1 = coupling.volume_loss_fraction(st, kit)
    got1 = coupling.explicit_chunk(st, kit, dt1, vol1, STEPS)
    _assert_same(got1, reference_chunk(st, kit, dt1, vol1, STEPS))
    assert not torch.equal(got1.C, st.C)
    assert got1.node_type is st.node_type and got1.is_gb is st.is_gb

    dt2, vol2 = 0.6 * dt1, vol1 + 0.25
    got2 = coupling.explicit_chunk(got1, kit, dt2, vol2, STEPS)
    assert coupling.explicit_runner_for(kit) is run
    ref2 = reference_chunk(got1, kit, dt2, vol2, STEPS)
    _assert_same(got2, ref2)
    for other in ((dt1, vol2), (dt2, vol1)):
        assert not torch.equal(
            reference_chunk(got1, kit, *other, STEPS).C, ref2.C), other
    assert coupling.EXPLICIT_COUNTS == {"replays": 0, "eager": 2 * STEPS,
                                        "captures": 0}


def old_explicit_cycle(self, cfg, grid, state, kit, t_corr):
    """CoupledSolver._explicit_cycle before the ExplicitRunner: chunks of
    the functional loop."""
    vol_loss = coupling.volume_loss_fraction(state, kit)
    dt_corr = float(ops_for(kit).ard_compute_dt(state, kit))
    step = 0
    while step < cfg.corrosion_steps_per_check and t_corr < cfg.T_final:
        n_chunk = min(cfg.output_every_corr,
                      cfg.corrosion_steps_per_check - step)
        n_fit = int(max(1, min(n_chunk, math.ceil(
            (cfg.T_final - t_corr) / dt_corr))))
        state = reference_chunk(state, kit, dt_corr, vol_loss, n_fit)
        t_corr += dt_corr * n_fit
        step += n_fit
        self.explicit_steps += n_fit
        if n_fit == n_chunk or t_corr >= cfg.T_final:
            self._write_state(cfg, grid, state, "corr", t_corr, self.writer)
            self._write_diagnostics(cfg, t_corr, torch.stack(
                [d.to(torch.float64)
                 for d in coupling.diagnostics(state, kit)]).tolist())
    return state, t_corr


def _files(path):
    """{name: bytes} of a run's CSVs and VTI snapshots."""
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))
            if n.endswith((".csv", ".vti"))}


def test_cli_run_equals_the_old_loop(tmp_path, monkeypatch, capsys):
    """parity.cfg explicit in f32 with the decay, three cycles of 12 steps
    in chunks of 5 (a row and a VTI after each full chunk and at T_final):
    the CLI through the runner against the CLI through the functional
    loop, CSV and VTI bytes; every step eager on the CPU, and no line
    about the graph route (the CPU always steps eagerly)."""
    args = [PARITY, "precision=f32", "flow_max_iters=50", "use_implicit=0",
            DECAY, "corrosion_steps_per_check=12", "output_every_corr=5",
            "T_final=2.2e-5", "--device", "cpu"]
    capsys.readouterr()
    new = cli.run([*args, f"output_dir={tmp_path / 'new'}"])
    assert "explicit steps:" not in capsys.readouterr().out
    monkeypatch.setattr(coupling.CoupledSolver, "_explicit_cycle",
                        old_explicit_cycle)
    old = cli.run([*args, f"output_dir={tmp_path / 'old'}"])
    assert new.cycles == old.cycles == 3
    assert new.explicit_steps == old.explicit_steps > 24
    assert new.explicit_graph == {"replays": 0, "captures": 0,
                                  "eager": new.explicit_steps}
    files = _files(tmp_path / "new")
    assert files == _files(tmp_path / "old")
    assert len([n for n in files if n.startswith("corr_")]) >= 6


def test_explicit_chunk_f64_matches_jax():
    """parity.cfg f64 with the decay, five steps from one seeded state
    through the port's explicit_chunk and the JAX package's: C to
    round-off, the other fields' rows as the BCs leave them."""
    kit, st = _built("parity_f64")
    jc = JConfig.load(PARITY)
    jc.apply_overrides(["precision=f64", DECAY])
    jg = j_build_grid(jc)
    jk = j_build_kit(jg, jc)
    js = j_initialize_state(jg, jc, grains=j_grains.generate(jg, jc),
                            dtype=jk.jdtype)
    js = type(js)(**{f.name: jnp.asarray(getattr(st, f.name).numpy())
                     for f in dataclasses.fields(js)})
    dt = float(ops_for(kit).ard_compute_dt(st, kit))
    vol = 0.1
    ref = j_coupling.explicit_chunk(js, jk, dt, vol, 5)
    got = coupling.explicit_chunk(st, kit, dt, vol, 5)
    for f in ("C", "rho", "vel"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-14 * np.abs(b).max(), err_msg=f)
    assert not np.array_equal(got.C.numpy(), st.C.numpy())


def test_ard2d_takes_a_tensor_dt():
    """ard2d_plain (and the wrapper on CPU tensors) with dt as a 0-d
    float32 tensor, as the graph's dt buffer hands it, equals the same
    call with the float."""
    kit, st = _built("parity_f32")
    dt = float(t_ard.compute_dt(st, kit))
    Ds = t_ard.solid_diffusivity(st.is_gb, st.is_precip, kit.cfg,
                                 t_ard.micro_d_factor(kit.cfg, 0.2,
                                                      kit.dtype, "cpu"))
    args = (st.C, st.vel, vel_magnitude(st.vel), st.node_type, Ds,
            t_ard.compute_salt_blocked(st, kit))
    want = kernels.ard2d_plain(*args, dt, kit)
    dt_t = torch.tensor(dt, dtype=torch.float32)
    assert not torch.equal(want, st.C)
    assert torch.equal(kernels.ard2d_plain(*args, dt_t, kit), want)
    assert torch.equal(kernels.ard2d(*args, dt_t, kit), want)


def _fake_kit(device="cuda", dtype=torch.float32, **extra):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 **extra)


@pytest.mark.parametrize("kit, why", [
    (_fake_kit(), None),
    (_fake_kit(device="cpu"), "the CPU"),
    (_fake_kit(dtype=torch.float64), "float64"),
    (_fake_kit(gs=object()), "gs_parity's host sweeps"),
    (_fake_kit(fine=types.SimpleNamespace(gs=object())),
     "gs_parity's host sweeps"),
    (_fake_kit(slab=object()), "a mesh"),
], ids=["graph", "cpu", "f64", "gs_parity", "gs_parity_block", "mesh"])
def test_graph_route_conditions(kit, why):
    """The explicit graph's route is the flow graph's (one function): the
    card, float32, no gs_parity tables (on the kit or a block), no mesh."""
    assert graph_refusal(kit) == why


def test_capture_needs_a_card():
    """Capturing on a CPU kit raises DeviceUnavailable: no fallback."""
    kit, st = _built("parity_f32")
    run = coupling.ExplicitRunner(kit)
    run.load(st, kit, 1e-6, 0.0)
    with pytest.raises(DeviceUnavailable, match="explicit step"):
        run.capture(kit)
    assert run.graph is None
