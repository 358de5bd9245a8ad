"""The implicit step over static buffers (``coupling.StepRunner``): the
step loop (head, GMRES's restart cycles and the refinement, tail) run
directly, its gates read on the host, as the card's graph runs it with
conditional nodes.

Within the port, bit for bit: the runner's steps against the implicit step
it replaced (``reference_inner_step`` below: the adaptive dt, the BCs, the
old solve of tests/test_torch_gmres_graph.py over the host-driven loop,
the smoothing, the fictitious refresh, n_below and the diagnostics, each a
functional call) on parity.cfg in f32 and f64, the 8,303-node 3D grid in
f32 with the card's packed operator built on the CPU, and the block and
gather grids in f32: C and every other field, dt, the residual, n_below,
the four diagnostics, the Arnoldi steps and cycles. Cases: several steps of
one cycle with the extrapolated start (C_prev carried in the runner's
buffer; the states handed out are copies), a refinement that takes two
passes and one that takes none, a cycle whose restart is rejected, a
second cycle after a phase change whose packed store outgrows the buffers,
and a short CoupledSolver run on parity.cfg f32 whose CSVs are
byte-identical to the old step's. The smoothing's axial offsets from the
kit's table, against the per-call host tensor they replaced. Against the
JAX package's ``_implicit_inner_core`` on parity.cfg f64, the gates of
tests/test_parity.py.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from test_torch_flow_graph import _bits
from test_torch_gmres_graph import (CONFIGS, PARITY, _built, _operator,
                                    _phase_changed, reference_step)

from pd_mg_pin_corrosion_tpu import coupling as j_coupling
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu_torch import amr_blocks, boundary, cli, coupling
from pd_mg_pin_corrosion_tpu_torch.config import FrozenConfig
from pd_mg_pin_corrosion_tpu_torch.dispatch import is_block, ops_for
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, SOLID_MG
from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops import gmres as t_gmres

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the step the runner replaced
# ---------------------------------------------------------------------------

def reference_inner_step(state, op, kit, C_prev=None, counts=None):
    """The port's implicit_inner_step before its segments ran over static
    buffers: every op a functional call on ``op`` itself, GMRES the old
    host-driven loop; (state, dt, n_below, residual, diagnostics) with
    tensors where that step returned them."""
    ops = ops_for(kit)
    dt = ops.compute_adaptive_dt(state, op, kit)
    state = ops.apply_inlet_bc(state, kit)
    state = ops.apply_outlet_bc(state, kit)
    state = ops.apply_wall_concentration_bc(state, kit)
    x0 = None if C_prev is None else 2.0 * state.C - C_prev
    state, res = reference_step(state, op, kit, dt, x0=x0, counts=counts)
    state = ops.smooth_boundary_concentration(state, kit)
    state = ops.update_fictitious(state, kit)
    n_below = ((state.node_type == SOLID_MG)
               & (state.C < kit.cfg.C_thresh)).sum()
    return state, dt, n_below, res, coupling.diagnostics(state, kit)


def reference_cycle(state, op, kit, n, extrapolate, counts=None):
    """n old steps of one cycle: the state and each step's numbers."""
    C_prev = state.C if extrapolate else None
    rows = []
    for _ in range(n):
        C_pre = state.C
        state, dt, n_below, res, diag = reference_inner_step(
            state, op, kit, C_prev, counts)
        if C_prev is not None:
            C_prev = C_pre
        rows.append((float(dt), int(n_below), res, tuple(
            torch.stack([d.to(torch.float64) for d in diag]).tolist())))
    return state, rows


def _fresh_stepper(kit):
    """A new StepRunner for ``kit`` over a new GmresRunner."""
    t_gmres._runners.pop(kit, None)
    coupling._steppers.pop(kit, None)
    return coupling.step_runner_for(kit)


def _cycle(stepper, state, op, kit, n, extrapolate):
    """n steps of the runner from one cycle's start."""
    stepper.begin(state, op, kit, state.C if extrapolate else None)
    rows = [stepper.step(kit) for _ in range(n)]
    return stepper.result(state), [(dt, nb, res, diag)
                                   for dt, nb, res, diag in rows]


def _equal(got, ref):
    """Two (state, rows) results equal bit for bit: every float field,
    node types, and each step's numbers (repr: a NaN equals a NaN)."""
    (gs, grows), (rs, rrows) = got, ref
    assert repr(grows) == repr(rrows)
    for f in dataclasses.fields(gs):
        assert torch.equal(_bits(getattr(gs, f.name)),
                           _bits(getattr(rs, f.name))), f.name


def _trips(stepper) -> dict:
    """The runner's trip counters at its last read, by name: restart
    cycles, accepted restarts ("take"), cycles that ended at j = 0 (each
    summed over the main solve's and the corrections' cycle loops), the
    refinement's first residuals and passes ("correct")."""
    run = stepper.run
    lay, t = run.lay, run._trips_seen
    loops = range(device_loop.COPIES)

    def over_loops(at):
        return sum(int(t[at(c)]) for c in loops)

    return {"cycle": over_loops(lay.cyc), "take": over_loops(lay.take),
            "end0": over_loops(lay.end),
            "first": int(t[lay.trip["first"]]),
            "correct": int(t[lay.trip["correct"]])}


def _rejections(trips) -> int:
    """Restart cycles of at least one Arnoldi step whose answer was not
    taken (the true residual did not fall)."""
    return trips["cycle"] - trips["end0"] - trips["take"]


# ---------------------------------------------------------------------------
# the smoothing's axial offsets
# ---------------------------------------------------------------------------

def old_smooth(state, kit):
    """The uniform grid's smoothing with its axial offsets built on the
    host at every call (before they were read from ``kit.slot_offsets``)."""
    fluid = state.node_type == FLUID
    near_in = kit.near_inlet_mask & fluid
    near_out = kit.near_outlet_mask & fluid
    d_ax = torch.tensor([o[0] for o in kit.offsets], device=kit.device)
    d_ax = d_ax.view((-1,) + (1,) * kit.dim)
    fl_p = kit.pad(fluid.to(kit.dtype), 0.0)
    C_p = kit.pad(state.C, 0.0)
    tot = torch.zeros_like(state.C)
    cnt = torch.zeros_like(state.C)
    for s0, s1 in kit.slot_chunks():
        d = d_ax[s0:s1]
        use = ((d > 0) & near_in) | ((d < 0) & near_out)
        sel = torch.where(use, kit.neighbors(fl_p, s0=s0, s1=s1), 0.0)
        tot += (kit.neighbors(C_p, s0=s0, s1=s1) * sel).sum(0)
        cnt += sel.sum(0)
    C_sm = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), state.C)
    C = torch.where((near_in | near_out) & (cnt > 0), C_sm, state.C)
    return dataclasses.replace(state, C=C)


@pytest.mark.parametrize("name", ["parity_f32", "parity_f64", "grid3d_f32",
                                  "blocks_f32"])
def test_smoothing_reads_the_axial_offsets_from_the_kit(name, monkeypatch):
    """smooth_boundary_concentration with the kit's offsets, bit for bit
    the host-built ones, with the slot sum in one chunk and in several."""
    kit, st = _built(name)
    if is_block(kit):
        new = amr_blocks.smooth_boundary_concentration(st, kit)
        old = amr_blocks._per_block(None, old_smooth)(st, kit)
    else:
        new = boundary.smooth_boundary_concentration(st, kit)
        old = old_smooth(st, kit)
        import pd_mg_pin_corrosion_tpu_torch.kit as kit_mod
        monkeypatch.setattr(kit_mod, "SLOT_CHUNK_ELEMS",
                            7 * st.C.numel())
        assert len(kit.slot_chunks()) > 1
        assert torch.equal(_bits(boundary.smooth_boundary_concentration(
            st, kit).C), _bits(old_smooth(st, kit).C))
    assert torch.equal(_bits(new.C), _bits(old.C))
    assert not torch.equal(new.C, st.C)   # the smoothing moved C


# ---------------------------------------------------------------------------
# steps of a cycle
# ---------------------------------------------------------------------------

# (kit, steps, extrapolated start): the 3D grid's packed walks are slow on
# the CPU, so it takes two steps
CYCLES = [(k, 2 if k == "grid3d_f32" else 3, x)
          for k in CONFIGS for x in (True, False)
          if not (k == "grid3d_f32" and not x)]


@pytest.mark.parametrize("name, n, extrapolate", CYCLES,
                         ids=[f"{k}-{'x0' if x else 'C'}"
                              for k, _, x in CYCLES])
def test_cycle_through_the_step_runner_equals_the_old_steps(name, n,
                                                            extrapolate):
    """n steps of one cycle through a fresh StepRunner, bit for bit the
    old steps: every field of the state, and each step's dt, n_below,
    residual and diagnostics; the same Arnoldi steps and cycles, every
    segment run directly on the CPU. A state handed out is a copy: the
    next step leaves it as it was."""
    kit, st = _built(name)
    op = _operator(st, kit, packed=name == "grid3d_f32")
    stepper = _fresh_stepper(kit)
    assert not stepper.graph_route
    t_gmres.reset_gmres_counts()
    t_gmres.reset_step_counts()
    stepper.begin(st, op, kit, st.C if extrapolate else None)
    rows = [stepper.step(kit)]
    first = stepper.result(st)
    kept = first.C.clone()
    rows += [stepper.step(kit) for _ in range(n - 1)]
    got = stepper.result(st), rows
    counts, steps = dict(t_gmres.GMRES_COUNTS), dict(t_gmres.STEP_COUNTS)
    ref_counts = {"steps": 0, "cycles": 0}
    _equal(got, reference_cycle(st, op, kit, n, extrapolate, ref_counts))
    assert (counts["eager"], counts["cycles"]) == (ref_counts["steps"],
                                                   ref_counts["cycles"])
    assert counts["replays"] == steps["replays"] == steps["captures"] == 0
    # n steps run directly, each read once at its end besides its gates'
    assert steps["eager"] == steps["steps"] == n and steps["launches"] == 0
    assert steps["host_reads"] > n
    assert torch.equal(first.C, kept)
    assert first.C.data_ptr() != stepper.state.C.data_ptr()
    # the one-step library call, eager or not, is the runner's step too
    one = coupling.implicit_inner_step(st, op, kit, eager=True)
    ref = reference_inner_step(st, op, kit)
    assert repr(one[1:3]) == repr((float(ref[1]), int(ref[2])))
    assert torch.equal(_bits(one[0].C), _bits(ref[0].C))


@pytest.mark.parametrize("name, dt_max, passes", [
    ("parity_f32", 1e-6, 0), ("parity_f32", 3e5, 2)],
    ids=["none", "two"])
def test_refinement_passes(name, dt_max, passes):
    """A step whose f64 residual meets the tolerance at once (dt = 1e-6 s)
    and one that takes both refinement passes (a stiff dt, whose f32
    cycles also reject restarts), each bit for bit the old step; the
    passes and the rejected restarts counted from gmres_qr's trip
    counters."""
    kit, st = _built(name)
    kit = dataclasses.replace(kit, cfg=_with(kit.cfg, implicit_dt_max=dt_max,
                                             implicit_dt_min_frac=1.0))
    op = _operator(st, kit)
    stepper = _fresh_stepper(kit)
    got = _cycle(stepper, st, op, kit, 1, False)
    trips = _trips(stepper)
    assert trips["correct"] == passes and trips["first"] == 1
    assert (_rejections(trips) > 0) == (passes == 2)
    _equal(got, reference_cycle(st, op, kit, 1, False))


def _with(cfg, **values):
    """A frozen config with ``values`` replaced."""
    return FrozenConfig(dataclasses.replace(cfg._cfg, **values))


def test_rejected_restart():
    """A stiff f64 step on parity.cfg whose cycles run into round-off: a
    restart that raised the true residual is rejected (the runner keeps
    x), bit for bit the old step."""
    kit, st = _built("parity_f64")
    kit = dataclasses.replace(kit, cfg=_with(kit.cfg, implicit_dt_max=3e6,
                                             implicit_dt_min_frac=1.0))
    op = _operator(st, kit)
    stepper = _fresh_stepper(kit)
    got = _cycle(stepper, st, op, kit, 1, False)
    assert _rejections(_trips(stepper)) > 0
    _equal(got, reference_cycle(st, op, kit, 1, False))


@pytest.mark.parametrize("name", ["parity_f32", "grid3d_f32", "blocks_f32",
                                  "gather_f32"])
def test_second_cycle_after_a_phase_change(name, monkeypatch):
    """Two cycles through one cached StepRunner, the second on the
    phase-changed state after the first and its operator (a longer packed
    store on the 3D grid, whose buffers it outgrows: no headroom here),
    bit for bit the old steps and a fresh runner."""
    monkeypatch.setattr(t_gmres, "PACKED_HEADROOM", 1.0)
    kit, st = _built(name)
    packed = name == "grid3d_f32"
    op1 = _operator(st, kit, packed)
    stepper = _fresh_stepper(kit)
    got1 = _cycle(stepper, st, op1, kit, 1, True)
    st2 = _phase_changed(got1[0], 0.3, 5)
    op2 = _operator(st2, kit, packed)
    growths = stepper.run.growths
    got2 = _cycle(stepper, st2, op2, kit, 2, True)
    assert coupling.step_runner_for(kit) is stepper
    assert (stepper.run.growths > growths) == packed
    _equal(got1, reference_cycle(st, op1, kit, 1, True))
    _equal(got2, reference_cycle(st2, op2, kit, 2, True))
    _equal(_cycle(_fresh_stepper(kit), st2, op2, kit, 2, True), got2)


@pytest.mark.parametrize("name", ["parity_f32", "blocks_f32", "gather_f32"])
def test_runners_let_their_kit_go(name):
    """A kit that took implicit steps (the coupled loop's and the library's)
    is freed once its caller drops it: its StepRunner and GmresRunner,
    keyed weakly on it, hold no reference to it, and go with it."""
    kit, st = _built.__wrapped__(name)    # a kit of its own, not cached
    op = _operator(st, kit)
    coupling.implicit_inner_step(st, op, kit, C_prev=st.C)
    t_gmres.implicit_step(ops_for(kit).linear_system, st, op, kit, 10.0)
    refs = [weakref.ref(o) for o in (kit, coupling.step_runner_for(kit),
                                     t_gmres.runner_for(kit))]
    del kit
    gc.collect()
    assert [r() for r in refs] == [None, None, None]


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def old_implicit_cycle(self, cfg, grid, state, kit, t_corr, gmres_tol):
    """CoupledSolver._implicit_cycle before the StepRunner: the old step,
    one at a time, C_prev threaded on the host by the JAX package's rule
    (the knob acts under implicit_fused_chunk only; the history is seeded
    with C wherever a JAX chunk starts: at the cycle's start, after the
    launch cap, after a step on an output boundary)."""
    op = coupling.assemble(state, kit,
                           coupling.volume_loss_fraction(state, kit))
    n, dissolved = 0, False
    cap = cfg.implicit_fused_chunk if cfg.implicit_fused_chunk > 1 else 50
    seeded = cfg.implicit_extrapolate_x0 and cfg.implicit_fused_chunk
    C_prev = state.C if seeded else None
    in_chunk = 0
    while (n < cfg.corrosion_steps_per_check and t_corr < cfg.T_final
           and not dissolved):
        C_pre = state.C
        state, dt, n_below, res, diag = reference_inner_step(
            state, op, kit, C_prev)
        if C_prev is not None:
            C_prev = C_pre
        t_corr += float(dt)
        n += 1
        in_chunk += 1
        self.total_implicit_steps += 1
        if seeded and (in_chunk == cap or self.total_implicit_steps
                       % cfg.implicit_output_every == 0):
            C_prev, in_chunk = state.C, 0
        if self.total_implicit_steps % cfg.diagnostic_every == 0:
            self._write_diagnostics(cfg, t_corr, torch.stack(
                [d.to(torch.float64) for d in diag]).tolist())
        dissolved = int(n_below) >= max(cfg.dissolution_batch, 1)
    self.cycle_steps.append(n)
    return state, t_corr


def test_coupled_run_csvs_equal_the_old_step(tmp_path, monkeypatch):
    """parity.cfg in f32 with the extrapolated start in chunks of 2 (a VTI
    every 3 steps ends one early), three coupling cycles of up to 4 steps
    (dissolutions and flow re-solves between them): the CLI's
    diagnostics.csv and mass_loss.csv through the StepRunner's chunks byte
    for byte those of the old step one at a time."""
    args = [PARITY, "precision=f32", "flow_max_iters=300", "T_final=5.4",
            "implicit_extrapolate_x0=1", "implicit_fused_chunk=2",
            "implicit_output_every=3", "dissolution_batch=1000",
            "corrosion_steps_per_check=4", "--device", "cpu"]
    new = cli.run([*args, f"output_dir={tmp_path / 'new'}"])
    monkeypatch.setattr(coupling.CoupledSolver, "_implicit_cycle",
                        old_implicit_cycle)
    old = cli.run([*args, f"output_dir={tmp_path / 'old'}"])
    assert new.cycle_steps == old.cycle_steps and new.cycles >= 3
    assert new.step_graph["eager"] > 0 and new.total_dissolved > 0
    for name in ("diagnostics.csv", "mass_loss.csv"):
        text = (tmp_path / "new" / name).read_text()
        assert text == (tmp_path / "old" / name).read_text(), name
        assert text.count("\n") >= 4


def test_steps_against_jax_inner_core():
    """parity.cfg f64 from the same seeded state, three steps through one
    StepRunner against the JAX package's ``_implicit_inner_core``: dt
    within 1e-9, n_below and solid exact, the other diagnostics within
    1e-6 (tests/test_parity.py's gates), C within 1e-10."""
    from test_torch_implicit import _close, _states

    jk, js, tk, ts = _states("f64", seed=2)
    jop = j_ai.assemble(js, jk)
    top = t_ai.assemble(ts, tk)
    step = jax.jit(j_coupling._implicit_inner_core)
    stepper = _fresh_stepper(tk)
    stepper.begin(ts, top, tk)
    for _ in range(3):
        js, jdt, jn, jres, jdiag = step(js, jop, jk)
        dt, n_below, res, diag = stepper.step(tk)
        np.testing.assert_allclose(dt, float(jdt), rtol=1e-9)
        assert n_below == int(jn) and diag[1] == float(jdiag[1])
        for k in (0, 2, 3):
            np.testing.assert_allclose(diag[k], float(jdiag[k]), rtol=1e-6)
        assert res < 1e-10 and float(jres) < 1e-10
    _close(stepper.result(ts).C, js.C, 1e-10, 1e-12)
