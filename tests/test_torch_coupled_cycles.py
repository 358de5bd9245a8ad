"""``coupled_fused_cycles``: whole coupling cycles ([flow segment] ->
assemble -> implicit steps -> phase change) run as one program a launch
(``coupling.CycleRunner``, the JAX package's ``coupled_cycles_chunk``),
every decision cycle_qr's, one host read a launch.

Within the port, on the CPU (the program's eager route: each gate a host
read, cycle_qr's plain twin), the CLI with coupled_fused_cycles = 3 (4,
6) against the same run with 0 (the host loop) on parity.cfg f32: the
same diagnostics.csv and mass_loss.csv bytes, VTI and PVD files (names
and bytes), steps a cycle, flow solves and final state, with launch caps,
a VTI every step and a flow snapshot every second solve, T_final inside a
cycle, the whole wire dissolved, and a checkpoint due under output exits
whose resume equals the uninterrupted run. cycle_qr_plain's modes, the
refusal of the routes the program does not take, the verbose flow lines,
and pack3d's plain walk from the state against the dense assembly and
pack_stencil byte for byte on the 8,303-node 3D grid before and after a
phase change.
"""

import dataclasses
import os
import shutil

import pytest
import torch

from pd_mg_pin_corrosion_tpu_torch import (Config, build_grid, build_kit,
                                           cli, initialize_state, kernels)
from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
BASE = [PARITY, "precision=f32", "flow_max_iters=300"]
# overrides of each case (parity.cfg's steps are 0.6 s at first, its
# cycles end at a dissolution batch of 20 after 1-3 steps)
CASES = {
    "batch": (3, ["dissolution_batch=20", "T_final=3.6"]),
    # launches of at most 3 steps and 50 flow iterations: a flow segment
    # overshoots the flow budget, steps split cycles across launches
    "launch_caps": (4, ["dissolution_batch=20", "T_final=4.2",
                        "coupled_launch_steps=3",
                        "coupled_launch_flow_iters=50"]),
    # an output exit at every step, a flow-snapshot exit every second solve
    "output_cadence": (3, ["dissolution_batch=20", "T_final=3.6",
                           "implicit_output_every=1",
                           "flow_output_stride=2"]),
    # cycles of 6 steps (no dissolution ends one); T_final inside the
    # second
    "T_final_in_cycle": (3, ["dissolution_batch=1000",
                             "corrosion_steps_per_check=6",
                             "T_final=5.4"]),
    # re-solves capped at 400 iterations, above flow_max_iters (300): the
    # host loop runs the cap (the JAX segment would stop at 300 and never
    # end the solve)
    "resolve_cap_above_max": (3, ["dissolution_batch=20", "T_final=2.4",
                                  "flow_max_iters_resolve=400"]),
    # re-solves capped at 100 iterations; the last cycle dissolves the
    # wire's last 38 nodes
    "all_dissolved": (6, ["dissolution_batch=40", "T_final=100",
                          "flow_max_iters_resolve=100"]),
}


def _run(tmp, tag, extra):
    return cli.run([*BASE, *extra, f"output_dir={tmp / tag}", "--device",
                    "cpu"])


def _files(path):
    """{name: bytes} of a run's CSVs, VTI snapshots and PVD collections."""
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))
            if n.endswith((".csv", ".vti", ".pvd"))}


def _same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_cycles_equal_the_host_loop(case, tmp_path):
    """The CLI with coupled_fused_cycles against the host loop: the same
    CSV, VTI and PVD bytes, steps a cycle, flow solves (iterations, eps,
    flags), final state; the fused run's cycles all ran in launches of
    the program, whose exits the run's cadences and caps set."""
    n, extra = CASES[case]
    host = _run(tmp_path, "host", [*extra, "coupled_fused_cycles=0"])
    fused = _run(tmp_path, "fused", [*extra, f"coupled_fused_cycles={n}"])
    files = _files(tmp_path / "fused")
    assert files == _files(tmp_path / "host")
    assert fused.cycle_steps == host.cycle_steps
    assert fused.flow_results == host.flow_results
    assert fused.flow_solve_count == host.flow_solve_count
    assert fused.total_implicit_steps == host.total_implicit_steps
    assert fused.total_dissolved == host.total_dissolved
    assert _same_state(fused.final_state, host.final_state)
    g = fused.cycle_graph
    assert host.cycle_graph["eager_launches"] == 0
    assert g["eager_launches"] >= 1 and g["launches"] == 0
    assert g["cycles"] == fused.cycles == host.cycles
    assert g["flow_iters"] == fused.flow_iters == host.flow_iters
    assert fused.step_graph["chunks"] == 0
    assert fused.step_graph["steps"] == sum(host.cycle_steps)
    vti = [f for f in files if f.startswith("corr_")]
    flow = [f for f in files if f.startswith("flow_")]
    if case == "launch_caps":
        # a launch stops within one micro-op of each budget
        assert g["eager_launches"] >= sum(host.cycle_steps) / 3
    if case == "output_cadence":
        assert len(vti) == sum(host.cycle_steps)
        assert len(flow) == -(-host.flow_solve_count // 2) >= 2
        assert g["eager_launches"] >= len(vti) + len(flow)
    if case == "T_final_in_cycle":
        assert host.cycle_steps[0] == 6 and sum(host.cycle_steps) == 9
    if case == "all_dissolved":
        assert host.total_dissolved == 180 and len(host.cycle_steps) == 4
        assert int((fused.final_state.node_type == 1).sum()) == 0


def test_checkpoint_under_output_exits_resumes(tmp_path, monkeypatch):
    """A VTI every step makes every launch end at an output exit; a
    checkpoint every second cycle still falls due at a cycle boundary
    (the launch's cycle cap), as the host loop writes it, and a run
    resumed from the one after cycle 2 ends as the uninterrupted run: the
    same CSV bytes and final state."""
    from pd_mg_pin_corrosion_tpu_torch import coupling

    extra = ["dissolution_batch=20", "T_final=4.2", "implicit_output_every=1",
             "checkpoint_every=2"]
    kept = []
    real = coupling.save_checkpoint

    def keeping(path, state, t, meta, *a, **k):
        real(path, state, t, meta, *a, **k)
        kept.append((meta["cycle"], t))
        shutil.copy(path, f"{path}.cycle{meta['cycle']}")

    monkeypatch.setattr(coupling, "save_checkpoint", keeping)
    host = _run(tmp_path, "host", [*extra, "coupled_fused_cycles=0"])
    host_kept, kept[:] = list(kept), []
    whole = _run(tmp_path, "whole", [*extra, "coupled_fused_cycles=8"])
    assert kept == host_kept and [c for c, _ in kept] == [2]
    assert _files(tmp_path / "whole") == _files(tmp_path / "host")
    resumed_dir = tmp_path / "resumed"
    shutil.copytree(tmp_path / "whole", resumed_dir)
    resumed = _run(tmp_path, "resumed", [
        *extra, "coupled_fused_cycles=8",
        f"resume_from={resumed_dir / 'checkpoint.npz.cycle2'}"])
    assert resumed.cycles == whole.cycles == 3
    assert _same_state(resumed.final_state, whole.final_state)
    for name in ("diagnostics.csv", "mass_loss.csv"):
        assert (resumed_dir / name).read_bytes() == (
            tmp_path / "whole" / name).read_bytes()


def test_routes_the_program_does_not_take(tmp_path, capsys):
    """gs_parity's host sweeps keep the host loop, with one line saying
    so; so do explicit runs, silently (the JAX package's fused cycles are
    implicit only)."""
    solver = _run(tmp_path, "gs", ["gs_parity=1", "T_final=0.6",
                                   "coupled_fused_cycles=3"])
    out = capsys.readouterr().out
    assert ("coupled_fused_cycles = 3: the fused coupling cycles do not "
            "run on gs_parity's host sweeps; this run takes the host loop"
            ) in out
    assert solver.cycle_graph["eager_launches"] == 0 < solver.cycles
    solver = _run(tmp_path, "explicit", ["use_implicit=0", "T_final=1e-4",
                                         "coupled_fused_cycles=3"])
    assert solver.cycle_graph["eager_launches"] == 0
    assert "fused coupling cycles" not in capsys.readouterr().out


def test_verbose_flow_lines(tmp_path, capsys, monkeypatch):
    """Under PD_TPU_VERBOSE_FLOW the program prints the host loop's flow
    lines, at the same iterations with the same numbers."""
    monkeypatch.setenv("PD_TPU_VERBOSE_FLOW", "1")
    extra = ["dissolution_batch=20", "T_final=2.4"]

    def flow_lines(tag, n):
        capsys.readouterr()
        _run(tmp_path, tag, [*extra, f"coupled_fused_cycles={n}"])
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip().startswith("Flow iter")]

    host = flow_lines("host", 0)
    # iterations 1-10 of each of the two solves (output_every_flow is
    # parity.cfg's 100,000)
    assert len(host) == 20
    assert flow_lines("fused", 3) == host


def _states(m=4):
    lay, glay = cl.CycleLayout(4), dl.QrLayout(m, 8)
    S = torch.zeros(glay.size, dtype=torch.float64)
    S[glay.sc("T_FINAL")] = 40.0
    return (torch.zeros(lay.size, dtype=torch.float64),
            torch.zeros(cl.N_FLAGS, dtype=torch.bool), S,
            torch.zeros(dl.N_FLAGS, dtype=torch.bool), glay.SC)


def _params(**kw):
    p = dict.fromkeys(cl.PARAMS, 0.0)
    p.update(T_FINAL=40.0, MAX_CYCLES=3, MAX_INNER=5, FLOW_CAP=150,
             FLOW_CAP_INIT=250, STEP_CAP=7, FLOW_ITER_CAP=300,
             OUT_EVERY=4, FLOW_STRIDE=2, CYCLE_CAP=3, NREC=4, NEED_FLOW=1)
    p.update(kw)
    return [p[n] for n in cl.PARAMS]


def test_flow_blocks_follow_the_check_cadence():
    """FLOW_NEXT over a fresh solve's segment: check iterations 1-10 and
    every 100th, between them blocks of 64, 32, ... 1 plain iterations
    that end before the next check and at the segment's end (the run's
    first solve: flow_max_iters; here 250)."""
    Y, CF, S, F, sc = _states()
    cl.cycle_qr_plain(cl.BEGIN, Y, CF, S, F, sc, _params())
    cl.cycle_qr_plain(cl.CYC_START, Y, CF, S, F, sc)
    assert CF[cl.FLOW] and CF[cl.FRESH] and CF[cl.FLOW_GO]
    assert Y[cl.SC["LIM"]] == 250 and Y[cl.SC["CAP_TOTAL"]] == 250
    seq = []
    while CF[cl.FLOW_GO]:
        it = int(Y[cl.SC["IT"]])
        cl.cycle_qr_plain(cl.FLOW_NEXT, Y, CF, S, F, sc)
        kind = int(Y[cl.SC["KIND"]])
        if kind == 0:
            Y[cl.SC["CHK_EPS"]] = 0.5
            cl.cycle_qr_plain(cl.FLOW_CHECK, Y, CF, S, F, sc)
            seq.append((it, "check"))
        else:
            seq.append((it, cl.BLOCKS[kind - 1]))
    assert seq == ([(i, "check") for i in range(1, 11)]
                   + [(11, 64), (75, 16), (91, 8), (99, 1), (100, "check"),
                      (101, 64), (165, 32), (197, 2), (199, 1),
                      (200, "check"), (201, 32), (233, 16), (249, 2)])
    assert Y[cl.SC["IT"]] == 251 and not CF[cl.REFRESH] is None
    cl.cycle_qr_plain(cl.FLOW_END, Y, CF, S, F, sc)
    # the budget spent: the solve is done, its record kept
    lay = cl.CycleLayout(4)
    assert CF[cl.FIN] and CF[cl.ASM] and Y[cl.SC["FLOW_SOLVES"]] == 1
    assert Y[lay.REC_FLOW:lay.REC_FLOW + 4].tolist() == [251.0, 0.5, 0.0,
                                                          0.0]
    assert Y[cl.SC["FLOW_ITERS"]] == 250 and Y[cl.SC["F_IT"]] == 0
    # the first solve's flow snapshot (count 1, stride 2)
    assert Y[cl.SC["EXIT_FLOW"]] == 1


def test_check_breaks_and_refreshes():
    """FLOW_CHECK: convergence counts only past iteration 100, divergence
    at once; a break keeps the pre-step buffers and ends the segment;
    dt is refreshed at every 200th iteration that does not break."""
    Y, CF, S, F, sc = _states()
    cl.cycle_qr_plain(cl.BEGIN, Y, CF, S, F, sc, _params())
    cl.cycle_qr_plain(cl.CYC_START, Y, CF, S, F, sc)
    for it, ok, div, brk, refresh in ((50, 1, 0, False, False),
                                      (200, 0, 0, False, True),
                                      (200, 1, 0, True, False),
                                      (7, 0, 1, True, False)):
        Y[cl.SC["IT"]] = it
        Y[cl.SC["CHK_OK"]], Y[cl.SC["CHK_DIV"]] = ok, div
        cl.cycle_qr_plain(cl.FLOW_CHECK, Y, CF, S, F, sc)
        assert (bool(CF[cl.BRK]), bool(CF[cl.REFRESH])) == (brk, refresh)
        assert bool(CF[cl.FLOW_GO]) == (not brk)
        assert Y[cl.SC["IT"]] == it + 1
    cl.cycle_qr_plain(cl.FLOW_END, Y, CF, S, F, sc)
    lay = cl.CycleLayout(4)
    assert Y[cl.SC["DIVERGED"]] == 1 and CF[cl.FIN]
    assert Y[lay.REC_FLOW:lay.REC_FLOW + 4].tolist() == [7.0, 0.0, 0.0, 1.0]
    cl.cycle_qr_plain(cl.OUTER, Y, CF, S, F, sc)
    assert not CF[cl.MORE]


def test_inner_window_and_phase_change():
    """INNER_START writes gmres_qr's chunk parameters (t, the global step
    count, the cycle's and the launch's steps left) with its step flag;
    INNER_END takes its t and steps back, ends the cycle on a dissolution
    or the cycle's budget, and exits at an output step; PC_END closes the
    cycle, its steps recorded, a re-solve due after a dissolution."""
    Y, CF, S, F, sc = _states()
    cl.cycle_qr_plain(cl.BEGIN, Y, CF, S, F, sc, _params(
        PHASE=cl.PH_INNER, INNER_K=2, T=3.0, TOTAL0=10, NEED_FLOW=0))
    cl.cycle_qr_plain(cl.INNER_START, Y, CF, S, F, sc)
    g = {n: float(S[sc + dl.SC_INDEX[n]]) for n in
         ("T", "KK", "TOTAL0", "STEPS_LEFT", "CAP")}
    assert g == {"T": 3.0, "KK": 0.0, "TOTAL0": 10.0, "STEPS_LEFT": 3.0,
                 "CAP": 7.0}
    assert F[dl.STEP]
    S[sc + dl.SC_INDEX["KK"]] = 2.0
    S[sc + dl.SC_INDEX["T"]] = 4.5
    cl.cycle_qr_plain(cl.INNER_END, Y, CF, S, F, sc)
    # steps 11 and 12: 12 is an output step (every 4th); 4 of 5 steps done
    assert Y[cl.SC["STEPS"]] == 2 and Y[cl.SC["INNER_K"]] == 4
    assert Y[cl.SC["PHASE"]] == cl.PH_INNER and Y[cl.SC["EXIT_OUTPUT"]] == 1
    cl.cycle_qr_plain(cl.OUTER, Y, CF, S, F, sc)
    assert not CF[cl.MORE]
    Y[cl.SC["EXIT_OUTPUT"]] = 0
    cl.cycle_qr_plain(cl.INNER_START, Y, CF, S, F, sc)
    assert float(S[sc + dl.SC_INDEX["STEPS_LEFT"]]) == 1.0
    S[sc + dl.SC_INDEX["KK"]] = 1.0
    S[sc + dl.SC_INDEX["DISSOLVED"]] = 1.0
    cl.cycle_qr_plain(cl.INNER_END, Y, CF, S, F, sc)
    assert Y[cl.SC["PHASE"]] == cl.PH_PC
    Y[cl.SC["N_DISS"]], Y[cl.SC["N_SOLID"]] = 3.0, 9.0
    cl.cycle_qr_plain(cl.PC_END, Y, CF, S, F, sc)
    lay = cl.CycleLayout(4)
    assert Y[lay.REC_STEPS] == 5 and Y[cl.SC["CYCLES"]] == 1
    assert Y[cl.SC["NEED_FLOW"]] == 1 and Y[cl.SC["PHASE"]] == cl.PH_START
    assert Y[cl.SC["DISSOLVED"]] == 3
    cl.cycle_qr_plain(cl.OUTER, Y, CF, S, F, sc)
    assert CF[cl.MORE]
    Y[cl.SC["N_DISS"]], Y[cl.SC["N_SOLID"]] = 9.0, 0.0
    Y[cl.SC["PHASE"]] = cl.PH_PC
    cl.cycle_qr_plain(cl.PC_END, Y, CF, S, F, sc)
    cl.cycle_qr_plain(cl.OUTER, Y, CF, S, F, sc)
    assert Y[cl.SC["ANY_SOLID"]] == 0 and not CF[cl.MORE]


def test_walk_reaches_every_mode_and_exit():
    """cycle_loop.walk (the card tests' and chip_smoke's sequence) reaches
    every mode, and its launches end at every kind of exit."""
    Y, CF, S, F, sc = _states()
    ends = set()

    def run_mode(mode, params, ys, ss):
        for k, v in ys.items():
            Y[cl.SC[k]] = v
        for k, v in ss.items():
            S[sc + dl.SC_INDEX[k]] = v
        cl.cycle_qr_plain(mode, Y, CF, S, F, sc, params)
        if mode == cl.OUTER and not CF[cl.MORE]:
            ends.update(n for n in ("EXIT_OUTPUT", "EXIT_FLOW", "EXIT_PACK",
                                    "DIVERGED") if Y[cl.SC[n]])
            if Y[cl.SC["STEPS"]] >= Y[cl.SC["STEP_CAP"]]:
                ends.add("steps")
            if Y[cl.SC["FLOW_ITERS"]] >= Y[cl.SC["FLOW_ITER_CAP"]]:
                ends.add("flow")
            if Y[cl.SC["CYCLES"]] >= min(Y[cl.SC["CYCLE_CAP"]],
                                         Y[cl.SC["MAX_CYCLES"]]):
                ends.add("cycles")

    modes = []
    for seed in range(4):
        modes += cl.walk(run_mode, lambda: (Y.tolist(), CF.tolist()), seed)
    assert set(modes) == set(range(cl.N_MODES))
    assert {"EXIT_OUTPUT", "EXIT_FLOW", "EXIT_PACK", "steps", "flow",
            "cycles"} <= ends


def _grid3d():
    cfg = Config()
    cfg.apply_overrides(["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
                         "R_tube=48e-6", "L_upstream=32e-6",
                         "L_downstream=32e-6", "precision=f32"])
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg, device="cpu")
    st = initialize_state(grid, cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    fluid, solid = st.node_type == 0, st.node_type == 1
    u = torch.rand(st.C.shape, generator=g)
    st = dataclasses.replace(
        st, C=torch.where(solid, 1.0 - 0.9 * u, torch.where(fluid, 0.9 * u,
                                                            0.0)),
        vel=torch.where(fluid[..., None], st.vel + 0.05 * torch.randn(
            st.vel.shape, generator=g), st.vel))
    return kit, st


def test_pack3d_plain_equals_pack_stencil():
    """pack3d's plain walk from the state into capacity buffers against the
    dense assembly and pack_stencil on the 8,303-node 3D grid (S = 178),
    before and after a phase change: diag, unknown, count, slice_ptr, the
    stored slots, float32 and bfloat16 values byte for byte, padding 0; a
    capacity one entry short sets the overflow flag and writes no value.
    Launches nothing."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import SLICE, pack3d
    from pd_mg_pin_corrosion_tpu_torch.ops.ard import micro_d_factor

    kit, st = _grid3d()
    before = kernels.launch_counts()
    changed, n_dis = ops_for(kit).apply_phase_change(st, kit)
    assert int(n_dis) > 0
    decay = micro_d_factor(kit.cfg, 0.0, kit.dtype, kit.device)
    for state in (st, changed):
        W, diag, unknown = ai._dense_operator(state, kit, 0.0)
        ref = kernels.pack_stencil(W, unknown, kit)
        ref16 = ref.to(torch.bfloat16)
        n = ref.values.numel()
        for cap in (n + 5 * SLICE, n - 1):
            packed = dataclasses.replace(
                ref, count=torch.zeros_like(ref.count),
                slice_ptr=torch.zeros_like(ref.slice_ptr),
                slots=torch.full((cap,), 7, dtype=torch.uint8),
                values=torch.full((cap,), 7.0))
            packed16 = dataclasses.replace(
                packed, values=torch.full((cap,), 7.0, dtype=torch.bfloat16))
            status = torch.zeros(2, dtype=torch.int64)
            d, u = torch.full_like(diag, 7.0), torch.zeros_like(unknown)
            pack3d(state, decay, kit, d, u, packed, packed16, status)
            assert torch.equal(d.view(torch.int32), diag.view(torch.int32))
            assert torch.equal(u, unknown)
            assert torch.equal(packed.count, ref.count)
            assert torch.equal(packed.slice_ptr, ref.slice_ptr)
            assert status.tolist() == [ref.nnz, int(cap < n)]
            if cap < n:
                assert bool((packed.slots == 7).all())
                continue
            assert torch.equal(packed.slots[:n], ref.slots)
            assert torch.equal(packed.values[:n].view(torch.int32),
                               ref.values.view(torch.int32))
            assert torch.equal(packed16.values[:n].view(torch.int16),
                               ref16.values.view(torch.int16))
    assert kernels.launch_counts() == before
