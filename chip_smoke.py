#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [phase ...]

Phases (each prints its own lines; any failure exits non-zero; with no
argument all of them run, in this order):

1. Device: the card's name and power limit; build (or load) the CUDA
   kernels from csrc/ (one nvcc per source, all started together; ptxas
   register / spill lines printed).
2. ``kernels``, 2D kernel vs plain: ns2d, matvec2d, basis_dots,
   basis_axpy and ard2d against their plain PyTorch twins at the 2D
   slices' shapes (the 567 x 347 = 196,749-node fine-calibration grid with
   a real Kit and seeded State; a 26-row basis of 196,749-long vectors
   with GMRES's row pitch, basis_axpy also over its first 13 rows), twice
   for identical bits, with median times of both, the bound (bytes
   over the HBM rate or flops over the peak rate, whichever is larger) and
   the time of one PyTorch library call that computes the same function,
   where there is one (LIBRARY); basis_dots must be one device launch a
   call (counted in a torch.profiler window); ns2d's and ard2d's tile,
   staged bytes, halo factor, unfused issue floor and time behind another
   kernel; ard2d bit-equal to its twin on seeded C with salt-blocked SOLID
   nodes.
3. ``kernels3d``, 3D kernel vs plain at the flagship shape: ns3d, matvec3d
   (packed f32 and bf16 weights against the dense twin; the packing's
   nonzero count, padding, bytes and time on a line of its own),
   slots3d_f64 (packed f32 weights against the dense twin, one device
   launch a call, beside an f64 CSR torch.mv), basis_axpy and basis_dots
   on a 26-row basis of that length
   (basis_dots also on its first 13 rows and as the k = 1 self-dot), ns3d's
   staged bytes and halo factor, and the four forms of
   ns3d_chunked.cu (chunked XLA / factored / jconv, and j-static; NCHUNK 6,
   BZ 16), each bit-equal to its twin and against ns3d at the script's
   gate, with its tile, staged bytes, unfused issue floor and time behind
   another kernel, on
   config/params_3d.cfg's 157 x 82 x 82 = 1,055,668-node grid (S = 178)
   with a real Kit, seeded State and its assembled operator (which keeps
   no dense W on the card: the twins get one built for them); pack3d
   from that state against its twin and the operator's packing, timed
   beside the route it replaced (the dense assembly, then the W-reading
   pack); the same checks and numbers.
4. ``ladder``, the chunked / j-static kernels' main path:
   scripts/exp_ns3d_chunked_torch.py's ladder (every rung checked against
   ns3d and timed, each rung's BZ -> tile printed) on the flagship grid.
5. ``main``, 2D main path: ``cli.run`` on params_fine_calibration.cfg at
   full size on CUDA, capped by MAIN_CAPS; checks the run and that the 2D
   path's four kernels launched in it.
6. ``explicit``, 2D explicit-transport path: ``cli.run`` on
   params_fine_calibration.cfg with use_implicit=0 at full size on CUDA,
   capped by EXPLICIT_CAPS; checks the run, that ard2d launched once per
   explicit step, and profiles a window of explicit steps.
7. ``main3d``, 3D main path: ``cli.run`` on params_3d.cfg at full size on
   CUDA, capped by MAIN3D_CAPS (one cycle of 20 implicit steps at the 30 s
   dt ceiling, one checkpoint), on the route the configuration selects:
   the fused coupling cycles (coupled_fused_cycles = 8: one CUDA graph
   launch and one read a launch, no read inside); checks the run and the
   fused 3D path's kernels (PATH_CYCLES), reloads the checkpoint, and
   holds the 20 rows against the banked docs/runs/3d_1M/diagnostics.csv
   within BANKED_GATES; prints the peak device memory, whether assembly
   or the steps set it, and whether the operator held a dense W.
8. ``cycles3d``, the flagship's fused coupling cycles at full size to
   T_final = 7,000 s (~400 steps, the bank's first two phase changes and
   their re-solves) from one kit, on the fused route as shipped and on
   the host loop (coupled_fused_cycles = 0), with their phase timers and
   walls: CSV, VTI and PVD bytes, steps a cycle, flow solves and final
   state equal, rows against the bank (solid_nodes exact, time_s within
   CYCLES3D_TIME_GATE, the rest within BANKED_GATES), one read a launch, every kernel of
   PATH_CYCLES launched (cycle_qr and pack3d with the 3D path's); then
   one 2,000-iteration flow segment of the program against solve_steady's
   (the same bits, ms an iteration each) and the operator's assembly on
   the device (assemble_into, pack3d) against the host loop's.
9. ``warm3d``, the warm-started flagship: ``cli.run`` on params_3d.cfg at
   full size on CUDA with flow_warm_start=2 and MAIN3D_CAPS on the host
   loop (coupled_fused_cycles = 0: the fine solve is solve_steady's): the coarse
   solve at 2 dx (166,050 nodes) and the fine solve both on ns3d, then
   main3d's implicit cycle; prints both solves, ns3d's launches on each
   grid, ms per implicit step and peak memory, and the FLUID-node relative
   L2 of vel and rho against a cold solve_steady of its own; both solves
   must converge, the
   fine one in fewer iterations than the cold one, vel within
   WARM_L2_GATE, and every kernel of the 3D path must launch.
10. ``explicit3d``, 3D explicit transport (plain PyTorch: no kernel, as in
   the JAX package): ``cli.run`` on params_3d.cfg at full size with
   use_implicit=0 after the warm start, the flow capped, one chunk of
   ~140 explicit steps; ms per step, a profiler window (device ops per
   step, busy share) and peak memory; then the 8,303-node grid of
   tests/test_torch_3d_slice.py on CUDA against the CPU path.
11. ``subcell3d``, the sub-cell 3D wall mirror: the same small grid with
   wall_mirror_subcell=1, CUDA against the CPU path; the flagship kit built
   with it (primary columns, and how many carry more than one weight).
12. ``amr``, block AMR on config/params_amr.cfg at full size (blocks
   208 x 80 and 194 x 120, 39,920 nodes): ns2d, matvec2d and ard2d on
   each block and basis_dots / basis_axpy on GMRES's (26, 39,920) basis
   against their twins, with times, in-situ times, bounds and library
   calls as in ``kernels``; the implicit path (capped by AMR_CAPS) and the
   explicit one (AMR_EXPLICIT_CAPS, ~250 steps) on CUDA against the CPU
   within 1e-4; then the warm-started run (AMR_WARM_CAPS) on the card,
   whose coarse and fine iteration counts must come within 10 % of the
   JAX package's 49,800 / 9,300, with ms per flow iteration on each grid
   and per implicit step, and its rows beside the banked
   docs/runs/amr/diagnostics.csv (printed, not a gate). PATH_AMR must
   launch in the warm run, PATH_AMR_EXPLICIT in the explicit one.
13. ``amrg``, the gather AMR backend (``amr_backend = gather``) on
   params_amr.cfg at full size (38,976 nodes, padded degree K = 40; its
   flow, BCs, transport and matvec are plain PyTorch gathers, as in the
   JAX package): basis_dots / basis_axpy on GMRES's (26, 38,976) basis
   against their twins with times, bounds and library calls; the capped
   implicit (AMR_CAPS) and explicit (AMR_EXPLICIT_CAPS) runs and
   parity.cfg with implicit_extrapolate_x0 = 1 on CUDA against the CPU
   within 1e-4 (the AMR runs' mass loss, whose float32 sum over 5,120
   solid nodes keeps only its last bits, may instead differ by
   AMRG_LOSS_ATOL); the gather run on the card against the block run on the
   card within BANKED_GATES (solid_nodes and time_s exact); PATH_AMRG
   must launch, the run must print the JAX package's AMR line, and no
   GMRES warning may appear.
14. ``amr3d``, the 7,655-node 3D block grid (params_3d.cfg at SMALL_3D's
   geometry with use_amr = 1), CUDA against the CPU within 1e-4; PATH_AMR3D
   must launch.
15. ``calib``, the calibration scripts' path: ns3d, matvec3d (f32, bf16),
   slots3d_f64 and basis_dots / basis_axpy (26 rows and k = 1) at the
   3D calibration grid's shapes (params_3d.cfg at dx = 8e-6: 45 x 45 x 82 =
   166,050 nodes), ns2d, matvec2d and the basis kernels at the 2D one's
   (params_implicit_test.cfg: 119 x 67 = 7,973 nodes), each against its
   twin as in ``kernels3d`` / ``amr`` (``name@calib3d``, ``name@calib2d``
   rows); then scripts/calibrate_3d_torch.py's run_one on twoanchor-c (with
   the banked runs' grain draw) and scripts/calibrate_2d_torch.py's on
   twoanchor-a, each to CALIB_T_FINAL
   on the card, their rows against the first rows of
   docs/runs/calib_3d/twoanchor-c and docs/runs/calib_2d/twoanchor-a
   within BANKED_GATES (solid_nodes and time_s exact); PATH_3D / PATH_2D
   must launch.
16. ``parity``, kernels vs plain end to end: tests/golden/parity.cfg, the
   implicit and the explicit path, the gs_parity path and the fused
   coupling cycles (PARITY_FUSED_CAPS: graph launches with one read each)
   in float32, on CUDA (kernels) and on the CPU (plain twins);
   diagnostics.csv must agree. And the whole gs_parity run in float64 on CUDA against the C++
   reference binary's tests/golden/parity_diagnostics_ref.csv, byte for
   byte and with tests/test_parity.py's gates.
17. ``shard``, the flagship over a mesh: params_3d.cfg at full size
   padded to 158 axial rows (157 is prime), SHARD_RANKS = 2 ranks on this
   one card (``parallel.launch.spawn`` over gloo: the halo rows staged
   through pinned host memory; NCCL refuses two ranks on one card). The
   3D path kernels at a rank's shapes (its extended slab of 87 x 82 x 82,
   the basis kernels over its 79 own rows) against their twins, as in
   ``kernels3d`` (``name@shard`` rows); one rank's capped flow solve
   (SHARD_FLOW_ITERS) and coupled run (SHARD_CAPS: one cycle of five
   implicit steps and a checkpoint) on the same padded grid; the ranks'
   (``parallel.checks.coupled``): the flow state must equal one rank's
   bit for bit, with ns3d launched every iteration on each rank, the rows
   within 1e-4 (the loss within 4 ulps of its float32 sum), every kernel
   of the 3D path launched on each rank; the checkpoint (rank 0 writes
   the single rank's file) loads equal to the ranks' final state and one
   rank resumes it for two steps. Prints ms per flow iteration and per
   implicit step of each rank beside one rank's, and each rank's
   launches (``launches_per_rank`` in the JSON line).
18. ``flowgraph``, the flow solve's CUDA graph (``solvers.FlowRunner``)
   on the four flows it serves (FLOW_CASES: the fine-calibration grid,
   the flagship, params_amr.cfg's blocks and its gather grid; the kits
   and seeded states of the kernels, kernels3d and amr phases when they
   ran): FLOWGRAPH_ITERS capped iterations on the eager route
   (``solve_steady(..., eager=True)``) and on the graph route from one
   state, which must agree bit for bit (rho, vel, C), in (iters, eps,
   conv, div) and in launch counts, with replays on the graph route
   only; then ms per iteration between checks by each route (windows of
   FLOWGRAPH_WINDOW iterations, eager, graph, graph, eager), host records
   per iteration (a replay must be one), the work a replay stands for,
   the busy share in a profiler window, the capture's ms and the graph
   pool's bytes.
19. ``gmresgraph``, GMRES's solve as one CUDA graph with conditional
   nodes (``gmres.implicit_step``'s program: the restart cycles a WHILE,
   the Arnoldi steps nested IFs, the cycle ends a SWITCH, the refinement
   passes IFs, each decision the gmres_qr kernel's) on the same four
   grids, from the seeded state after FLOWGRAPH_ITERS flow iterations
   (flowgraph's kits and solves, when it ran): GMRESGRAPH_STEPS solves
   from that state and its operator on the eager route (``eager=True``,
   each gate a host read) and on the graph route, which must agree bit
   for bit in C and every residual, in Arnoldi steps, cycles and launch
   counts, with launches on the graph route only, one capture and one
   host read a solve; a second operator (the state after them, phase
   changed) the same, reusing the graph; then ms a solve by route
   (windows of GMRESGRAPH_WINDOW solves), host records and host reads a
   solve, the busy share in a profiler window, Arnoldi steps a solve,
   the graph's kernel nodes, capture ms and pool.
20. ``stepgraph``, the implicit step loop as one CUDA graph
   (``coupling.StepRunner.steps``: a WHILE over the steps, each its head
   with the adaptive dt and the BCs, the solve, its tail with the
   smoothing, the diagnostics and gmres_qr's exits) on the same four
   grids from the same states: STEPGRAPH_STEPS steps of one cycle with
   the extrapolated start, one at a time and as one chunk, on the eager
   and on the graph route, which must agree bit for bit in every field,
   in each step's dt, n_below, residual and diagnostics and in the
   chunk's time, in Arnoldi steps, cycles, steps and launch counts, with
   launches on the graph route only and one host read a step (a chunk);
   then windows of STEPGRAPH_WINDOW steps by route and as chunks: ms an
   implicit step, host records (at most STEPGRAPH_RECORDS a graphed
   step) and host reads an implicit step, busy share, the step graphs'
   kernel nodes, capture ms, graph pool and peak memory.
21. ``configs``, the shipped configurations no other phase runs
   (params.cfg, the CLI's default; params_diagnostic, params_calibration,
   params_poiseuille, params_transport_viz, params_fine,
   params_calibration_v2) and the flagship's geometry at dx = 16e-6
   (params_3d.cfg, 30,420 nodes): each through ``cli.run`` with its file
   unchanged but for CONFIGS_CAPS, CUDA against the CPU in float32 with
   the graph routes replaying (the loss may differ by 4 ulps of its
   float32 sum over the initially solid nodes; the coarse flagship within
   main3d's BANKED_GATES), every kernel of its path launched (ns2d,
   matvec2d and the basis kernels; ns2d and ard2d for the explicit
   poiseuille run; the 3D path at 16e-6), CONFIGS_F64 again in float64
   within tests/test_parity.py's gates; then CONFIGS_WHOLE whole on the
   card to their own T_final with PD_TPU_PHASE_TIMERS=1: wall, simulated
   hours per wall hour, cycles, steps, flow iterations, the phase
   breakdown and the final row beside docs/PARITY.md's record (RECORDS,
   printed), params_poiseuille held to tests/test_flow.py's gates
   (converged, L2 relative error < 5 %, v_max within 10 % of 1.5 U_in).

Every CLI run on the card prints its flow iterations by route
(``[flow]`` lines: graph replays, eager iterations, captures), its
Arnoldi steps (``[gmres]`` lines: in graphs and eager, cycles, solve
graph launches, captures, chunks, host reads inside steps, kernel nodes)
and its implicit steps (``[step]`` lines: in graphs and eager, graph
launches, captures, chunks, host reads and reads a step, kernel nodes);
the main paths' checks and every CUDA-against-CPU run (but gs_parity's,
whose host sweeps keep its flow on the eager route, and float64 ones,
whose NS step is the plain twin) fail when the flow replayed no graph,
and every implicit one when its Arnoldi steps or (but gs_parity's, whose
steps' heads and tails run directly) its steps ran in no graph.

Launch counts are set to 0 just before each main path and read just after
it. Then one JSON line about the kernels (the AMR, gather AMR and calib
phases' shapes as ``name@shape`` rows, with the launches of the run at
that shape), the nvidia-smi line, and the result line. Imports nothing of JAX. Exits non-zero without a CUDA device
or without the repository beside it.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
FINE = os.path.join(ROOT, "config", "params_fine_calibration.cfg")
FLAGSHIP = os.path.join(ROOT, "config", "params_3d.cfg")
BANKED = os.path.join(ROOT, "docs", "runs", "3d_1M", "diagnostics.csv")
PARITY = os.path.join(ROOT, "tests", "golden", "parity.cfg")
LADDER = os.path.join(ROOT, "scripts", "exp_ns3d_chunked_torch.py")
PROFILE = os.path.join(ROOT, "scripts", "profile_torch_3d.py")

# Main-path caps: 20,000 iterations for the initial flow solve and 2,000 per
# re-solve; 1,200 s of physics in cycles of at most 20 implicit steps (two
# cycles at the 30 s adaptive-dt ceiling).
MAIN_CAPS = ["flow_max_iters=20000", "flow_max_iters_resolve=2000",
             "T_final=1200", "corrosion_steps_per_check=20"]
# 3D main-path caps: the initial flow solve converged at ~6,500 iterations
# in the banked run; 600 s of physics is 20 implicit steps at the 30 s dt
# ceiling in one cycle, and checkpoint_every=1 writes one 1M-node checkpoint
MAIN3D_CAPS = ["flow_max_iters=10000", "T_final=600", "checkpoint_every=1"]
# max relative difference of the 20 rows against the banked run's first 20
# (measured on an H100 at 700 W: 2.1e-5, 1.0e-6 and 7.4e-5)
BANKED_GATES = {"pin_mass_loss_pct": 1e-3, "v_max": 1e-3, "C_max_fluid": 1e-2}
# explicit-transport caps: an initial flow solve of 2,000 iterations (the
# explicit path's checks do not need it converged); cycles of 1,000 steps
# in chunks (diagnostics rows) of 250; T_final = 0.02 s of physics is
# ~1,400 steps at the 1.4e-5 s CFL dt of the initial state
EXPLICIT_EVERY, EXPLICIT_T_FINAL = 250, 0.02
EXPLICIT_CAPS = ["use_implicit=0", "flow_max_iters=2000",
                 "flow_max_iters_resolve=2000", "corrosion_steps_per_check=1000",
                 f"output_every_corr={EXPLICIT_EVERY}",
                 f"T_final={EXPLICIT_T_FINAL}"]
EXPLICIT_PROFILE_STEPS = 100
# the warm-started flagship: MAIN3D_CAPS with the coarse warm start at 2 dx;
# the JAX package recorded a FLUID-node relative L2 of vel of 5.9e-3 between
# the warm and the cold solve at this configuration (its config.py)
# (the host loop: the phase times the fine solve through solve_steady)
WARM3D_CAPS = MAIN3D_CAPS + ["flow_warm_start=2", "coupled_fused_cycles=0"]
# cycles3d: the flagship as shipped (coupled_fused_cycles = 8, launches of
# at most 200 steps and 6,000 flow iterations) to T_final = 7,000 s, about
# 400 implicit steps with the bank's first two phase changes (4,558.972 s:
# 31,600 -> 31,524 solid; 6,783.001 s: -> 31,391) and their re-solves, on
# the fused route and on the host loop from one kit; then one flow segment
# of the program (2,000 iterations) against solve_steady's from the
# initial state
CYCLES3D_T_FINAL = 7000.0
CYCLES3D_SOLIDS = (31600, 31524, 31391)
# the bank prints time_s to 7 digits; after the first phase change the
# port's times (both routes, byte-identical CSVs) differ from it in the
# last of them (3.67e-7 relative at most on an H100 at 700 W; PERF.md)
CYCLES3D_TIME_GATE = 1e-6
WARM_L2_GATE = 2e-2
# 3D explicit transport at full size: the warm start, both solves capped at
# 2,000 iterations, then one chunk of explicit steps up to T_final (~140
# steps at a CFL dt of ~2.1e-6 s; 283 before the fused cycles' phase took
# its time)
EXPLICIT3D_T_FINAL = 3e-4
EXPLICIT3D_CAPS = ["use_implicit=0", "flow_warm_start=2", "flow_max_iters=2000",
                   "corrosion_steps_per_check=1000", "output_every_corr=1000",
                   f"T_final={EXPLICIT3D_T_FINAL}"]
EXPLICIT3D_PROFILE_STEPS = 20
# tests/test_torch_3d_slice.py's SMALL: params_3d.cfg cut to the 8,303-node
# grid, in f32; the explicit run as tests/test_torch_explicit3d.py's (62
# steps), the sub-cell run the first 3 s of the implicit one
SMALL_3D = ["dx=8e-6", "R_wire=16e-6", "L_wire=64e-6", "R_tube=48e-6",
            "L_upstream=32e-6", "L_downstream=32e-6", "Q_flow=1.667e-10",
            "D_grain=5e-12", "D_gb=5e-10", "corrosion_accel_l=0",
            "dissolution_batch=1", "flow_max_iters=100",
            "flow_max_iters_resolve=50", "precision=f32"]
SMALL_EXPLICIT_CAPS = SMALL_3D + ["use_implicit=0", "T_final=0.0025",
                                  "corrosion_steps_per_check=25",
                                  "output_every_corr=10"]
SMALL_SUBCELL_CAPS = SMALL_3D + ["wall_mirror_subcell=1", "T_final=3"]
# gs_parity: the whole f64 run against the C++ reference binary (as
# tests/test_parity.py), and the CPU slice tests' capped f32 run
PARITY_GS_CAPS = ["precision=f64", "gs_parity=1",
                  "implicit_output_every=1000000000"]
GOLDEN = os.path.join(ROOT, "tests", "golden", "parity_diagnostics_ref.csv")
# the CPU slice tests' flow cap (tests/test_torch_slice.py), in f32; the
# explicit run as tests/test_torch_explicit.py: 151 steps of 6.6e-7 s
PARITY_CAPS = ["precision=f32", "flow_max_iters=300"]
# the implicit run on the fused coupling cycles, three a launch (nine
# cycles, the wire dissolved at 6 s; the CUDA rows are the host loop's
# bit for bit, so the gate is parity_implicit's)
PARITY_FUSED_CAPS = PARITY_CAPS + ["coupled_fused_cycles=3"]
PARITY_EXPLICIT_CAPS = PARITY_CAPS + ["use_implicit=0", "T_final=1e-4",
                                      "output_every_corr=25"]
# 4 units in the last place of a float32 sum of 180 values near 1, as a
# mass loss in % (tests/test_torch_explicit.py holds the f32 run to it)
LOSS_ATOL = 4 * 100.0 * float(np.spacing(np.float32(180))) / 180
# block AMR: config/params_amr.cfg at full size (blocks 208 x 80 and
# 194 x 120, 39,920 nodes). CUDA against the CPU: the implicit path capped
# (a flow solve of 300 iterations, 120 s of physics: four steps at the
# 30 s dt ceiling), the explicit path (a flow solve of 100 iterations)
# ~250 steps at the capped flow's CFL dt of ~1.4e-5 s in rows of 50 (the
# CPU side is most of the phase: 290.7 s for 1,200 flow iterations and 17
# implicit steps on the card machine's host, NVIDIA H100 80GB HBM3 at
# 700.00 W); then the warm-started run on
# the card alone, to 600 s of physics, whose coarse (2 dx, uniform) and
# fine iteration counts must come within AMR_WARM_GATE of the JAX
# package's record (config.py, flow_warm_start: 49,800 and 9,300 on this
# configuration)
AMR_CFG = os.path.join(ROOT, "config", "params_amr.cfg")
AMR_BANKED = os.path.join(ROOT, "docs", "runs", "amr", "diagnostics.csv")
AMR_CAPS = ["precision=f32", "flow_max_iters=300", "T_final=120",
            "corrosion_steps_per_check=10"]
AMR_EXPLICIT_EVERY = 50
AMR_EXPLICIT_CAPS = ["precision=f32", "use_implicit=0", "flow_max_iters=100",
                     "corrosion_steps_per_check=1000",
                     f"output_every_corr={AMR_EXPLICIT_EVERY}",
                     "T_final=3.5e-3"]
# the gather AMR backend on the same configuration (amr_backend = gather:
# 14,400 fine, 21,672 coarse and 2,904 fictitious nodes, 38,976 in all,
# padded degree K = 40): AMR_CAPS and AMR_EXPLICIT_CAPS, CUDA against the
# CPU, and the gather run on the card against the block run on the card
# within BANKED_GATES (the grids hold the same nodes and the same grain
# draw); parity.cfg with implicit_extrapolate_x0 = 1, CUDA against the CPU
GATHER = ["amr_backend=gather"]
# the mass loss 100 (1 - sum C / n0) over params_amr.cfg's n0 = 5,120
# initially solid nodes keeps only the last bits of the float32 sum near
# n0, which CUDA and the CPU take in different orders: after the first
# 30 s step one ulp of it is 2.2e-4 of the 0.0423 % loss; CUDA against the
# CPU it may differ by 4 such ulps (the gather runs' other columns keep
# the 1e-4 limit)
AMRG_LOSS_ATOL = 4 * 100.0 * float(np.spacing(np.float32(5120))) / 5120
AMRG_LINE = ("AMR: 14400 fine, 21672 coarse, 2904 fictitious nodes "
             "(total 38976); K=40")
AMR_WARM_CAPS = ["flow_warm_start=2", "T_final=600"]
AMR_WARM_ITERS = (49_800, 9_300)
AMR_WARM_GATE = 0.10
# the 3D block grid: params_3d.cfg at SMALL_3D's geometry with block AMR
# (7,655 nodes, blocks 20 x 16 x 16 and 15 x 13 x 13), tests/test_torch_
# 3d_slice.py's 21 s of physics
AMR3D_CAPS = SMALL_3D + ["use_amr=1", "amr_ratio=2", "amr_buffer=16e-6",
                         "T_final=21"]
# the calibration scripts (scripts/calibrate_3d_torch.py, _2d_torch.py):
# the ladder points twoanchor-c of docs/runs/calib_3d (params_3d.cfg at
# dx = 8e-6, 166,050 nodes; label, dx, D_grain, D_gb, gb_width_cells,
# grain_size_mean, corrosion_accel_l) and twoanchor-a of docs/runs/calib_2d
# (params_implicit_test.cfg, 7,973 nodes; label, D_grain, D_gb, decay_l,
# accel_l), each run by its script's run_one to CALIB_T_FINAL (20 implicit
# steps at the 30 s dt ceiling) and held against the banked run's first
# rows within BANKED_GATES. The 3D bank was made with the grain draw of
# replay_banked_amr.py (the whole point on the card gives its 2,540 rows
# with it, 2,523 without; NVIDIA H100 80GB HBM3 at 700.00 W), so the 3D
# point runs with --grain-draw=banked; both draws give the 2D bank's run
CALIB3D = os.path.join(ROOT, "scripts", "calibrate_3d_torch.py")
CALIB2D = os.path.join(ROOT, "scripts", "calibrate_2d_torch.py")
CALIB3D_POINT = ("twoanchor-c", 8e-6, 2.1609e-17, 2.1609e-15, 0, 40e-6,
                 1.2790)
CALIB2D_POINT = ("twoanchor-a", 5.826e-17, 5.826e-15, None, None)
CALIB_T_FINAL = 600.0
CALIB3D_CFG = ["dx=8e-6", "D_grain=2.1609e-17", "D_gb=2.1609e-15",
               "gb_width_cells=0", "grain_size_mean=40e-6",
               "corrosion_accel_l=1.2790"]
CALIB2D_CFG = os.path.join(ROOT, "config", "params_implicit_test.cfg")
# the mesh: params_3d.cfg at full size padded to 158 axial rows, two ranks
# on this one card over gloo (halos staged through pinned host memory):
# a capped flow solve held bit for bit against one rank on the same padded
# grid, then one cycle of five implicit steps at the 30 s dt ceiling and
# a checkpoint, whose rows must come within 1e-4 of the one rank's (the
# mass loss within 4 ulps of its float32 sum, as AMRG_LOSS_ATOL; GMRES's
# dots are summed over the ranks); one rank then resumes the checkpoint
# for two steps more
SHARD_RANKS = 2
SHARD_FLOW_ITERS = 1000
# (the host loop on every side: a mesh takes no fused cycles, and the
# one-rank runs it is held against take the same route)
SHARD_CAPS = [f"flow_max_iters={SHARD_FLOW_ITERS}", "T_final=150",
              "corrosion_steps_per_check=5", "checkpoint_every=1",
              "coupled_fused_cycles=0"]
SHARD_RESUME_T_FINAL = 210
SEED = 20261016
# configs: the seven shipped configurations that no other phase runs
# (ROADMAP A.13) and the flagship's geometry at dx = 16e-6 (26 x 26 x 45 =
# 30,420 nodes, 500 SOLID_MG: A.2 gate 2's grid), each through the CLI with
# its file unchanged but for the caps below, in f32 on CUDA against the
# CPU: every flow solve capped at 20 iterations (checks 1-10 eager, the
# graph captured at the 11th and replayed after), the physical time at the first
# implicit steps (the 30 s step of the 60 s ceiling; the 0.6 s floor of
# the fast-dissolving ones, each step ending its cycle with a phase
# change), params_poiseuille.cfg as shipped (no wire: one explicit step).
# Rows within 1e-4 (the coarse flagship: main3d's BANKED_GATES); the mass
# loss, 100 (1 - sum C / n0) over the n0 initially solid nodes, may instead
# differ by 4 ulps of its float32 sum (as LOSS_ATOL): after the first 30 s
# step it is ~0.07 % and one ulp of the sum of 1,296 values near 1 is
# 1.4e-4 of it. CONFIGS_F64 run again in float64, CUDA against the CPU
# within tests/test_parity.py's gates (GATES_F64), to show that such a
# difference is the float32 sum's and not the path's. Then the
# five cheapest whole, on the card alone (CONFIGS_WHOLE), each to its own
# T_final with PD_TPU_PHASE_TIMERS=1, its final row beside docs/PARITY.md's
# record where one exists (RECORDS; printed, not a gate: a record may
# predate the grid or the mode the configuration runs now, ROADMAP C)
CONFIG_DIR = os.path.join(ROOT, "config")
CONFIGS_FLOW = "flow_max_iters=20"
CONFIGS_CAPS = {
    "params": ("params", [CONFIGS_FLOW, "T_final=90"]),
    "params_diagnostic": ("params_diagnostic", [CONFIGS_FLOW, "T_final=90"]),
    "params_calibration": ("params_calibration", [CONFIGS_FLOW,
                                                  "T_final=90"]),
    "params_poiseuille": ("params_poiseuille", [CONFIGS_FLOW]),
    "params_transport_viz": ("params_transport_viz", [CONFIGS_FLOW,
                                                      "T_final=1.2"]),
    "params_fine": ("params_fine", [CONFIGS_FLOW]),
    "params_calibration_v2": ("params_calibration_v2", [CONFIGS_FLOW,
                                                        "T_final=60"]),
    # four cycles of two 30 s steps, the re-solves capped too
    "params_3d@16um": ("params_3d", ["dx=16e-6", CONFIGS_FLOW,
                                     "flow_max_iters_resolve=20",
                                     "corrosion_steps_per_check=2",
                                     "T_final=240"]),
}
CONFIGS_F64 = ("params_diagnostic", "params_calibration")
GATES_F64 = {"time_s": 1e-9, "pin_mass_loss_pct": 1e-6, "v_max": 1e-6,
             "C_max_fluid": 1e-6}
CONFIGS_WHOLE = ("params", "params_diagnostic", "params_poiseuille",
                 "params_transport_viz", "params_fine")
# docs/PARITY.md's records of the JAX package's whole runs on a TPU
# (trajectories, not times): final time_s, pin_mass_loss_pct, solid_nodes,
# v_max; None where it recorded none
RECORDS = {"params_transport_viz": (2.4, 65.80, 789, 4.17e-1),
           "params_fine": (0.6, None, 8200, None)}
# flowgraph: FLOWGRAPH_ITERS capped flow iterations of each flow the CUDA
# graph serves (name: configuration, overrides, nodes), from one seeded
# state, on the eager route and on the graph's; timing and profiler
# windows of FLOWGRAPH_WINDOW iterations between checks
FLOWGRAPH_ITERS = 1000
FLOWGRAPH_WINDOW = 200
# gmresgraph: implicit steps of each of those grids on each route from one
# seeded, assembled state; timing and profiler windows of
# GMRESGRAPH_WINDOW implicit steps
GMRESGRAPH_STEPS = 5
GMRESGRAPH_WINDOW = 3
# stepgraph: implicit steps of one cycle on each route from that state;
# timing and profiler windows of STEPGRAPH_WINDOW steps; the host records a
# graphed step may take besides one a replayed Arnoldi step
STEPGRAPH_STEPS = 5
STEPGRAPH_WINDOW = 3
STEPGRAPH_RECORDS = 4
FLOW_CASES = {"fine": (FINE, (), 196_749),
              "flagship": (FLAGSHIP, (), 1_055_668),
              "amr": (AMR_CFG, (), 39_920),
              "amrg": (AMR_CFG, ("amr_backend=gather",), 38_976)}
# (kit, seeded state) of a flow case, left by the phase that built it,
# and the state after flowgraph's capped solve from it
FLOW_KITS = {}
FLOWED = {}
PHASES = ("kernels", "kernels3d", "ladder", "main", "explicit", "main3d",
          "cycles3d",
          "warm3d", "explicit3d", "subcell3d", "amr", "amrg", "amr3d",
          "calib", "parity", "shard", "flowgraph", "gmresgraph",
          "stepgraph", "configs")
# the kernels each main path must launch
PATH_2D = ("ns2d", "matvec2d", "basis_dots", "basis_axpy", "gmres_qr")
PATH_3D = ("ns3d", "matvec3d", "matvec3d_bf16", "slots3d_f64", "basis_dots",
           "basis_axpy", "gmres_qr")
# and the fused coupling cycles' (params_3d.cfg's coupled_fused_cycles)
PATH_CYCLES = PATH_3D + ("cycle_qr", "pack3d")
PATH_EXPLICIT = ("ard2d",)
PATH_AMR = ("ns2d", "matvec2d", "basis_dots", "basis_axpy", "gmres_qr")
PATH_AMR_EXPLICIT = ("ns2d", "ard2d")
PATH_AMRG = ("basis_dots", "basis_axpy", "gmres_qr")
PATH_AMR3D = ("ns3d", "matvec3d", "slots3d_f64", "basis_dots", "basis_axpy",
              "gmres_qr")
PATH_LADDER = ("ns3d", "ns3d_chunked_xla", "ns3d_chunked_factored",
               "ns3d_chunked_jconv", "ns3d_jstat")
CHUNKED_FORMS = (("ns3d_chunked_xla", False), ("ns3d_chunked_factored", True),
                 ("ns3d_chunked_jconv", "jconv"), ("ns3d_jstat", "jstat"))
# published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 bytes/s,
# float32 and float64 (outside the tensor cores) flop/s
HBM_RATE, F32_RATE, F64_RATE = 3.35e12, 67e12, 34e12
L2_BYTES = 50e6


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def load_script(path):
    """The module of a script in scripts/, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, calls, reps=7):
    """Median over ``reps`` of the device time per call of fn(), in ms:
    CUDA events around ``calls`` back-to-back calls, all queued behind a
    ~10 ms spin kernel so the host's launch overhead is hidden and the
    events time the device work only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def apart_ms(fn, other, reps=30):
    """Median device time of single fn() calls, each right behind a call
    of ``other`` (a kernel on other data): on a main path other work runs
    between two calls of a kernel, and what back-to-back calls of one
    kernel leave in the caches for each other is gone."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        other()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_launches(fn, calls=20):
    """Device work items (kernel launches, memsets, copies) per fn() call:
    the CUDA runtime and driver calls that enqueue them, in a
    torch.profiler window (CPU and CUDA activities) of ``calls`` calls,
    rounded. Counted from these host-side records, not from the device's
    kernel records: in a process that has run for minutes a window loses a
    growing share of its kernel records (none at all in the calib pass of
    a whole run; scripts/profiler_windows_torch.py), while every launch
    record stays. A replay of a CUDA graph is one record
    (cudaGraphLaunch), whatever the graph holds."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return round(launch_records(prof) / calls)


def launch_records(prof):
    """The host's records of enqueued device work in a profiler window."""
    return sum(e.name.startswith("cu") and any(
        k in e.name for k in ("LaunchKernel", "Memset", "Memcpy",
                              "GraphLaunch"))
        for e in prof.events())


def seeded(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.tensor(rng.normal(0.0, scale, shape), dtype=dtype,
                        device="cuda")


def bound(nbytes, flops, rate=F32_RATE):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes through HBM and to do flops at the peak rate."""
    t_bytes, t_ops = nbytes / HBM_RATE, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_ms(name, fn, ref, calls):
    """Median time of one PyTorch library call computing the kernel's
    function (a yardstick; the port never calls it), after checking its
    result against the kernel's ``ref`` (max |d| <= 1e-4 max |ref|)."""
    y = fn()
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max() / ref.abs().max())
    del y
    ms = median_ms(fn, calls)
    print(f"[library] {name}: {ms:.4f} ms, max rel diff vs the kernel "
          f"{err:.2e}")
    if err > 1e-4:
        fail(f"{name}: the library call does not compute the kernel's function")
    return ms


def recorder(tag, results, calls=20, plain_calls=3):
    """record(name, err, ok, fn, plain, what, nbytes, flops, rate,
    library, timed): two launches of fn() must give the same bits; median
    times of fn (or of ``timed``, the launch alone where fn copies its
    outputs out of fixed buffers) and plain; the bound from nbytes and
    flops; the library call's time (a zero-argument function whose result
    must match fn()'s first output) or None; fails unless ok. Fills
    results[name] with the kernel's row of the JSON line."""
    def record(name, err, ok, fn, plain, what, nbytes, flops, rate=F32_RATE,
               library=None, timed=None):
        k1, k2 = fn(), fn()
        same = all(torch.equal(a, b) for a, b in zip(k1, k2))
        if not same:
            fail(f"{name}: two launches gave different bits")
        lib_ms = (library_ms(name, library, k1[0], calls)
                  if library is not None else None)
        del k1, k2
        ms = median_ms(fn if timed is None else timed, calls)
        plain_ms = median_ms(plain, plain_calls)
        b_ms, b_by = bound(nbytes, flops, rate)
        print(f"[{tag}] {name}: max_abs_err={err:.3e} ({what}) "
              f"repeat-identical={same} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'no single call' if lib_ms is None else f'{lib_ms:.4f} ms'};"
              f" {nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP per call "
              f"-> bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / ms:.1f} % "
              f"of it), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
        if not ok:
            fail(f"{name}: disagrees with its plain version ({what})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib_ms}
    return record


def bond_counts(kit, centre, pads, classes):
    """{class: [S] float64 tensor}: per stencil slot, the number of bonds
    from a node in ``centre`` whose neighbour satisfies ``classes[class]``
    (a function of the neighbour views of the padded fields ``pads``,
    out-of-grid neighbours reading the pad fill). Counts the work a
    kernel's data needs."""
    out = {c: torch.zeros(kit.S, dtype=torch.float64, device=kit.device)
           for c in classes}
    for s0, s1 in kit.slot_chunks():
        nb = {k: kit.neighbors(p, s0=s0, s1=s1) for k, p in pads.items()}
        for c, fn in classes.items():
            out[c][s0:s1] = (centre & fn(nb)).reshape(s1 - s0, -1).sum(
                1, dtype=torch.float64)
    return out


def csr_of(W, diag, unknown, kit):
    """The implicit operator y = diag x + sum_s W_s shift_s(x) on the
    unknown rows as one CSR matrix (int32 indices, W's exact zeros and
    out-of-grid neighbours dropped, columns sorted; no diagonal when
    ``diag`` is None), for the library call ``torch.mv``."""
    n = unknown.numel()
    rows = unknown.reshape(-1).nonzero().squeeze(1)
    strides = [math.prod(kit.shape[a + 1:]) for a in range(kit.dim)]
    flat = [sum(o * st for o, st in zip(off, strides)) for off in kit.offsets]
    # column kit.S is the diagonal
    order = sorted(range(kit.S + (diag is not None)),
                   key=lambda c: 0 if c == kit.S else flat[c])
    coord, rem = [], rows
    for st, ext in zip(strides, kit.shape):
        coord.append(rem // st)
        rem = rem % st
    vals, cols, keep = [], [], []
    for c in order:
        if c == kit.S:
            vals.append(diag.reshape(-1)[rows])
            cols.append(rows)
            keep.append(torch.ones_like(rows, dtype=torch.bool))
            continue
        inside = torch.ones_like(rows, dtype=torch.bool)
        for a, ext in enumerate(kit.shape):
            q = coord[a] + kit.offsets[c][a]
            inside &= (q >= 0) & (q < ext)
        w = W[c].reshape(-1)[rows].float()
        vals.append(w)
        cols.append(rows + flat[c])
        keep.append(inside & (w != 0))
    keep = torch.stack(keep, 1)
    val = torch.stack(vals, 1)[keep]
    col = torch.stack(cols, 1)[keep].to(torch.int32)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=W.device)
    crow[rows + 1] = keep.sum(1)
    crow = crow.cumsum(0).to(torch.int32)
    return torch.sparse_csr_tensor(crow, col, val, size=(n, n))


def record_basis_axpy(record, name, c, V, w):
    """basis_axpy at the shape of (c, V, w) against its twin, bit for bit,
    beside torch.addmv on the same V with c already in float32. Bytes: the
    basis, w and out, and the f64 coefficients."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    k, n = V.shape
    a, ap = kernels.basis_axpy(c, V, w), kernels.basis_axpy_plain(c, V, w)
    err = float((a - ap).abs().max())
    same = torch.equal(a, ap) and torch.equal(
        kernels.basis_axpy(c, V), kernels.basis_axpy_plain(c, V))
    print(f"[basis_axpy] {name} ({k}, {n}) bit-equal to its plain twin, with "
          f"and without w: {same}")
    del a, ap
    c32 = c.float()
    record(name, err, same, lambda: (kernels.basis_axpy(c, V, w),),
           lambda: kernels.basis_axpy_plain(c, V, w), "bit-equal",
           4 * k * n + 8 * n + 8 * k, 2.0 * k * n,
           library=lambda: torch.addmv(w, V.T, c32, alpha=-1))
    if 4 * k * n < L2_BYTES:
        print(f"[basis_axpy] {name}: the {4 * k * n / 1e6:.1f} MB basis stays "
              f"in the {L2_BYTES / 1e6:.0f} MB L2 across back-to-back calls, "
              f"so its time may lie under the bound, which counts HBM bytes")


def record_basis_dots(record, name, V, w):
    """basis_dots at the shape of (V, w) against its twin (rtol 2e-6: f64
    sums in another order) and against the kernel's own order in PyTorch
    (basis_dots_walk_plain, printed), beside torch.mv on the same tensors.
    Bytes: the basis, w and the f64 result; for the self-dot (V is w[None])
    the vector once."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    k, n = V.shape
    self_dot = k == 1 and V.data_ptr() == w.data_ptr()
    d, dp = kernels.basis_dots(V, w), kernels.basis_dots_plain(V, w)
    err = float((d - dp).abs().max())
    walk = kernels.basis_dots_walk_plain(
        V, w, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"[basis_dots] {name} ({k}, {n}): max rel diff vs the plain f64 sum "
          f"{float(((d - dp) / dp).abs().max()):.2e}; equal to the kernel's "
          f"order of sums taken in PyTorch: {torch.equal(d, walk)}")
    del walk
    record(name, err, torch.allclose(d, dp, rtol=2e-6, atol=0.0),
           lambda: (kernels.basis_dots(V, w),),
           lambda: kernels.basis_dots_plain(V, w),
           "rtol 2e-6 vs f64 plain sum",
           4 * n * (1 if self_dot else k + 1) + 8 * k, 2.0 * k * n,
           library=lambda: torch.mv(V, w))


def qr_check_sequence(dl, m, rng):
    """gmres_qr's modes in a step's order, for holding the kernel against
    its twin (as tests/test_torch_device_loop.py): (mode, j, arg), arg
    BEGIN's params or a dict of scalars to set first (upper case; ACCEPT's
    RNEW the candidate's self-dot) and raw inputs (START's self-dot
    ``dot``; ARNOLDI's CGS2 coefficients ``c1``, ``c2`` and self-dot
    ``dot``). The main solve's loop (COPY 0) runs a cycle that breaks down
    at once on a negative pivot (cosine -1), one on a zero column (denom
    0: cosine 1) and m steps with two zero subdiagonals; then the
    refinement and both correction loops (COPY 1 and 2), each with a
    breakdown, the second opening on a negative pivot; then the step's
    end."""
    def col(j, zero=False):
        h = abs(rng.normal()) + 0.1
        return {"c1": rng.normal(size=j + 1),
                "c2": 1e-3 * rng.normal(size=j + 1),
                "dot": 0.0 if zero else h * h}

    def cols(js, zero=()):
        return [(dl.ARNOLDI, j, col(j, j in zero)) for j in js]

    def pivot(h0):
        return (dl.ARNOLDI, 0, {"c1": np.array([h0]), "c2": np.zeros(1),
                                "dot": 0.0})

    def end(rnew):
        return [(dl.FINISH, 0, None), (dl.ACCEPT, 0, {"RNEW": rnew * rnew})]

    half = max(m // 2, 2)
    return [
        (dl.BEGIN, 0, (0.0, 1e9, 1e-4, 1e-6, 8, 3, 10, 4, 1, 2, 1000)),
        (dl.HEAD, 0, {"BN": 3.0, "RN": 1.0}),
        (dl.START, 0, {"dot": 1.0}), pivot(-2.0), *end(2.0),
        (dl.START, 0, {"dot": 1.0}), pivot(0.0), *end(2.0),
        (dl.START, 0, {"dot": 1.0}), *cols(range(m), {m // 3, m // 2}),
        *end(0.5),
        (dl.REF_FIRST, 0, {"BN": 2.0, "RN": 1e-5}),
        (dl.CORRECT, 0, {"BN": 1e-5, "RN": 1e-5}),
        (dl.START, 0, {"dot": 1e-10}), *cols(range(half), {1}), *end(1e-7),
        (dl.UPDATE, 0, {"RN": 1e-6}),
        (dl.CORRECT, 0, {"BN": 1e-6, "RN": 1e-6}),
        (dl.START, 0, {"dot": 1e-12}), pivot(-1.0), *cols(range(1, half)),
        *end(1e-8),
        (dl.UPDATE, 0, {"RN": 1e-9}),
        (dl.TAIL, 1, {"DT": 30.0, "NBELOW": 0.0, "LOSS": 1.0, "SOLID": 9.0,
                      "VMAX": 2.0, "CMAX": 0.5})]


def qr_apply(lay, S, arg, scale):
    """Set the scalars of a qr_check_sequence entry into S (on any
    device); its raw inputs as gmres_qr keyword arguments on S's device,
    with ``scale`` for the basis vector's scale."""
    if not isinstance(arg, dict):
        return {}
    raw = {}
    for name, v in arg.items():
        if name.isupper():
            S[lay.sc(name)] = v
        else:
            raw[name] = torch.tensor(v, dtype=torch.float64,
                                     device=S.device)
    if raw:
        raw["scale"] = scale
    return raw


def record_gmres_qr(record, m, rng):
    """gmres_qr at restart length m (float32 runs' GMRES(25)): every mode
    of a step in order from the raw inputs (qr_check_sequence: cycles of
    the main solve and of both refinement corrections, breakdowns on a
    negative pivot, a zero column and zero subdiagonals), S, F and the
    float32 scale, the trip counters included, bit for bit against the
    plain twin on the host after each; then the ARNOLDI launch at j = m -
    1 (the longest step: its m - 1 rotations) timed, and the FINISH launch
    (the back-substitution of m coefficients, the longest mode) timed
    against the twin and against torch.linalg.solve_triangular on the same
    R and g (no library call does a Givens step). Bound: FINISH's bytes
    (R's upper triangle and g read, y written) over HBM and its float64
    operations at the card's rate; the chain of dependent float64
    operations sits far above both (latency;
    scripts/gmres_qr_modes_torch.py measures that floor)."""
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    lay = dl.QrLayout(m, 4)
    # the twin's copy lies on the card too: its self-dots' square roots
    # are then torch.sqrt's there (IEEE), as the kernel's are
    S = torch.zeros(lay.size, dtype=torch.float64, device="cuda")
    F = torch.zeros(lay.n_flags, dtype=torch.bool, device="cuda")
    scale = torch.zeros(1, dtype=torch.float32, device="cuda")
    Sd, Fd, scale_d = S.clone(), F.clone(), scale.clone()
    same = True
    with np.errstate(divide="ignore", invalid="ignore"):
        for mode, j, arg in qr_check_sequence(dl, m, rng):
            params = arg if mode == dl.BEGIN else None
            raw = qr_apply(lay, S, arg, scale)
            raw_d = qr_apply(lay, Sd, arg, scale_d)
            dl.gmres_qr_plain(mode, j, S, F, m, params, **raw)
            dl.gmres_qr(mode, j, Sd, Fd, m, params, **raw_d)
            torch.cuda.synchronize()
            same = same and torch.equal(S.view(torch.int64),
                                        Sd.view(torch.int64)) and (
                torch.equal(F, Fd)) and torch.equal(scale, scale_d)
    # ARNOLDI at j = m - 1 on the state the cycle left (it rewrites step
    # m - 1's rotation, g[m - 1 :] and R's last column each call)
    j = m - 1
    S2, F2 = Sd.clone(), Fd.clone()
    arn = {"c1": seeded(rng, (j + 1,), dtype=torch.float64),
           "c2": seeded(rng, (j + 1,), 1e-3, dtype=torch.float64),
           "dot": torch.tensor(0.49, dtype=torch.float64, device="cuda")}

    def arnoldi():
        dl.gmres_qr(dl.ARNOLDI, j, S2, F2, m, scale=scale_d, **arn)

    arnoldi_ms = median_ms(arnoldi, 20)
    print(f"[kernels] gmres_qr: ARNOLDI at j = {j}: {arnoldi_ms:.4f} ms a "
          f"launch (no library call does a Givens step)")
    # the FINISH launch on the state the cycle left (idempotent: it reads
    # R and g, writes yc)
    S2, F2 = Sd.clone(), Fd.clone()
    S2[lay.sc("J")] = float(m)
    Sh, Fh = S2.cpu(), F2.cpu()
    yc = S2[lay.YC:lay.YC + m]
    R = S2[:lay.G].view(m, m + 1).T[:m, :m].contiguous()
    g = S2[lay.G:lay.G + m].clone()

    def kernel():
        dl.gmres_qr(dl.FINISH, 0, S2, F2, m)
        return (yc.clone(),)

    def plain():
        dl.gmres_qr_plain(dl.FINISH, 0, Sh, Fh, m)
        return (Sh[lay.YC:lay.YC + m],)

    ref = plain()[0]
    err = float((kernel()[0].cpu() - ref).abs().max())
    n_r = m * (m + 1) // 2
    record("gmres_qr", err, same and err == 0.0, kernel, plain,
           f"every mode bit-equal {same}; FINISH m={m}; ARNOLDI j={j} "
           f"{arnoldi_ms:.4f} ms", 8 * (n_r + 2 * m), 2.0 * n_r + 2 * m,
           F64_RATE,
           library=lambda: torch.linalg.solve_triangular(
               R, g[:, None], upper=True)[:, 0].neg())


def record_cycle_qr(record):
    """cycle_qr: every mode on cycle_loop.walk's sequences (every exit,
    launches resumed from carried values) bit for bit against the plain
    twin on the host after each mode (Y, CF and gmres_qr's S, F); then one
    INNER_START launch (an inner window's start: seven scalars of Y read,
    six of gmres_qr's and its step flag written; a mode that leaves Y as
    it found it) timed against the twin. Bound: those bytes over HBM; a
    launch's latency sits far above it. No library call takes a coupling
    cycle's decisions."""
    from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    def states(device):
        lay, glay = cl.CycleLayout(4), dl.QrLayout(4, 8)
        S = torch.zeros(glay.size, dtype=torch.float64, device=device)
        S[glay.sc("T_FINAL")] = 40.0
        return [torch.zeros(lay.size, dtype=torch.float64, device=device),
                torch.zeros(cl.N_FLAGS, dtype=torch.bool, device=device), S,
                torch.zeros(dl.N_FLAGS, dtype=torch.bool, device=device),
                glay.SC]

    same, n_modes, seen = True, 0, set()
    for seed in range(4):
        dev, host = states("cuda"), states("cpu")

        def run_mode(mode, params, ys, ss):
            nonlocal same
            for Y, CF, S, F, sc in (dev, host):
                for k, v in ys.items():
                    Y[cl.SC[k]] = v
                for k, v in ss.items():
                    S[sc + dl.SC_INDEX[k]] = v
                cl.cycle_qr(mode, Y, CF, S, F, sc, params)
            same = same and all(torch.equal(a.cpu(), b)
                                for a, b in zip(dev[:4], host[:4]))

        modes = cl.walk(run_mode, lambda: (host[0].tolist(),
                                           host[1].tolist()), seed)
        n_modes += len(modes)
        seen |= set(modes)
    Y, CF, S, F, sc = dev
    Yh, CFh, Sh, Fh, _ = host
    err = float((Y.cpu() - Yh).abs().max())
    print(f"[kernels] cycle_qr: {n_modes} modes over 4 sequences, "
          f"{len(seen)} of {cl.N_MODES} kinds, every one bit-equal to the "
          f"twin: {same}")

    def kernel():
        cl.cycle_qr(cl.INNER_START, Y, CF, S, F, sc)
        return (S.clone(), F.clone())

    def plain():
        cl.cycle_qr_plain(cl.INNER_START, Yh, CFh, Sh, Fh, sc)
        return (Sh, Fh)

    record("cycle_qr", err, same and err == 0.0 and len(seen) == cl.N_MODES,
           kernel, plain, f"every mode bit-equal {same}; INNER_START timed",
           8 * 7 + 8 * 6 + 1, 4.0, F64_RATE)


def record_pack3d(record, tag, kit, st, op, W):
    """pack3d at the flagship's shape from the state (volume loss 0) into
    capacity buffers with PACKED_HEADROOM of room: diag, unknown, count,
    slice_ptr, the stored slots, the float32 and bfloat16 values and
    status byte for byte against its twin (the dense assembly, then the
    packing walk) and the operator's own packing (``assemble``:
    pack3d_alloc, one sizing read); a capacity one entry short sets the
    overflow flag and writes no slot or value. Timed alone and with its
    outputs copied out (the recipe of the dense-W kernel's earlier time),
    against the twin; beside them the route it replaced, the dense
    assembly (``_dense_operator``: the salt-blocking pass and every slot
    over the whole grid) then the W-reading pack (``pack3d_dense``), and
    that pack alone. Bound: the state's per-node fields read once
    (node_type, vel, C, is_gb, is_precip), the slot tables, the outputs
    written once (diag, unknown, count, slice_ptr, the stored slots and
    both values); operations: the float32 operations of this state's
    bonds (2 a bond of an unknown row, V_j and the diagonal's subtraction;
    15 more a liquid-liquid bond, 8 more an interface bond), 1 a row."""
    from pd_mg_pin_corrosion_tpu_torch.grid import (FICTITIOUS, FLUID, INLET,
                                                    OUTLET, OUTSIDE, SOLID_MG)
    from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import (
        SLICE, pack3d, pack3d_dense, pack3d_plain)
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu_torch.ops.ard import micro_d_factor
    from pd_mg_pin_corrosion_tpu_torch.ops.gmres import PACKED_HEADROOM

    ref, ref16 = op.packed, op.W16
    n = ref.values.numel()
    decay = micro_d_factor(kit.cfg, 0.0, kit.dtype, kit.device)

    def buffers(cap):
        packed = dataclasses.replace(
            ref, count=torch.zeros_like(ref.count),
            slice_ptr=torch.zeros_like(ref.slice_ptr),
            slots=torch.zeros(cap, dtype=torch.uint8, device="cuda"),
            values=torch.zeros(cap, device="cuda"))
        return (torch.zeros_like(op.diag), torch.zeros_like(op.unknown),
                packed, dataclasses.replace(packed, values=torch.zeros(
                    cap, dtype=torch.bfloat16, device="cuda")),
                torch.zeros(2, dtype=torch.int64, device="cuda"))

    def bits(diag, unknown, packed, packed16, status):
        return (diag.view(torch.int32), unknown, packed.count,
                packed.slice_ptr, packed.slots[:n],
                packed.values[:n].view(torch.int32),
                packed16.values[:n].view(torch.int16), status)

    short = buffers(n - 1)
    pack3d(st, decay, kit, *short)
    overflow = (short[4].tolist() == [ref.nnz, 1]
                and not bool(short[2].slots.any())
                and not bool(short[2].values.any())
                and torch.equal(short[2].count, ref.count))
    del short
    out = buffers(math.ceil(n * PACKED_HEADROOM))
    twin = buffers(math.ceil(n * PACKED_HEADROOM))

    def launch():
        pack3d(st, decay, kit, *out)

    def kernel():
        launch()
        return tuple(t.clone() for t in bits(*out))

    def plain():
        pack3d_plain(st, decay, kit, *twin)
        return bits(*twin)

    got = kernel()
    same_twin = all(torch.equal(a, b) for a, b in zip(got, plain()))
    same_op = all(torch.equal(a, b) for a, b in zip(got, bits(
        op.diag, op.unknown, ref, ref16, torch.tensor(
            [ref.nnz, 0], device="cuda"))))
    err = float((got[5].view(torch.float32) - ref.values).abs().max())
    del got
    dense = buffers(n)

    def dense_route():
        W_now = ai._dense_operator(st, kit, 0.0)[0]
        pack3d_dense(W_now, op.unknown, kit, *dense[2:])

    dense_route()
    same_dense = all(torch.equal(a, b) for a, b in zip(
        bits(op.diag, op.unknown, *dense[2:])[2:], bits(
            op.diag, op.unknown, ref, ref16, torch.tensor(
                [ref.nnz, 0], device="cuda"))[2:]))
    route_ms = median_ms(dense_route, 3)
    pack_ms = median_ms(lambda: pack3d_dense(W, op.unknown, kit, *dense[2:]),
                        10)
    cloned_ms = median_ms(kernel, 10)
    del dense
    N = math.prod(kit.shape)
    n_slices = ref.slice_ptr.numel() - 1
    nbytes = (19 * N + 4 + 36 * kit.S + 7 * N + 4 * (n_slices + 1)
              + n * (1 + 4 + 2))
    fluid, solid = st.node_type == FLUID, st.node_type == SOLID_MG
    nt = kit.pad(st.node_type, OUTSIDE)
    liquid = (lambda nb: (nb["nt"] == FLUID) | (nb["nt"] == INLET)
              | (nb["nt"] == OUTLET) | (nb["nt"] == FICTITIOUS))
    from_fluid = bond_counts(kit, fluid, {"nt": nt}, {
        "ll": liquid, "iface": lambda nb: nb["nt"] == SOLID_MG})
    from_solid = bond_counts(kit, solid, {"nt": nt}, {"iface": liquid})
    n_unk = int(op.unknown.sum())
    flops = (2 * kit.S * n_unk + n_unk + 15 * float(from_fluid["ll"].sum())
             + 8 * float(from_fluid["iface"].sum() + from_solid["iface"].sum()))
    print(f"[{tag}] pack3d: {n} stored entries ({n // SLICE} value rows), "
          f"{ref.nnz} nonzeros, from the state with no dense W; byte-equal "
          f"to its twin {same_twin} and to the operator's own packing "
          f"(assemble: pack3d_alloc) {same_op}; a capacity one entry short "
          f"overflows and writes nothing: {overflow}")
    print(f"[{tag}] pack3d with its outputs copied out each call (the dense-W "
          f"kernel's earlier recipe) {cloned_ms:.4f} ms; the route it "
          f"replaced, the dense assembly then the W-reading pack "
          f"(pack3d_dense, byte-equal {same_dense}) {route_ms:.4f} ms, that "
          f"pack alone {pack_ms:.4f} ms ({W.numel() * 4 / 1e6:.1f} MB of W "
          f"read by its count)")
    record("pack3d", err, same_twin and same_op and same_dense and overflow,
           kernel, plain, "byte-equal to its twin and to pack_stencil",
           nbytes, flops, timed=launch)


def phase_kernels(pkg):
    """Phase 2; returns {name: JSON row fields}."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import ard as ard_ops
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    cfg = pkg.Config.load(FINE)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg,
                              grains=pkg.grains.generate(grid, cfg),
                              device="cuda")
    print(f"[kernels] fine-calibration grid {kit.shape} = {grid.N_total} "
          f"nodes, S={kit.S}, mext={kit.mext}, {kit.dtype}")
    rng = np.random.default_rng(SEED)
    fluid = st.node_type == pkg.FLUID
    solid = st.node_type == pkg.SOLID_MG
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    st.C = torch.where(solid, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"), 0.0)
    FLOW_KITS["fine"] = (kit, dataclasses.replace(st))
    n = grid.N_total
    nt_p = kit.pad(st.node_type, pkg.OUTSIDE)
    results = {}
    record = recorder("kernels", results)

    # ns2d: 29 B/node (rho, vel[2], p, node_type in; rho, vel[2] out); per
    # FLUID node ~26 flops, per bond to an active neighbour 52 flops (37 on
    # an axis bond, whose zero e component's terms the kernel skips)
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    (r, v), (rp, vp) = kernels.ns2d(*args), kernels.ns2d_plain(*args)
    torch.cuda.synchronize()
    ok = (torch.allclose(r, rp, rtol=1e-6, atol=0.0)
          and torch.allclose(v, vp, rtol=1e-5, atol=1e-9))
    err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
    act = bond_counts(kit, fluid, {"nt": nt_p},
                      {"act": lambda nb: nb["nt"] != pkg.OUTSIDE})["act"]
    diag = torch.tensor([ex != 0 and ey != 0 for ex, ey in kit.evec],
                        device="cuda")
    flops = float((act * torch.where(diag, 52.0, 37.0)).sum()
                  + 26 * fluid.sum())
    print(f"[kernels] ns2d bit-equal to its plain twin: "
          f"{torch.equal(r, rp) and torch.equal(v, vp)}")
    record("ns2d", err, ok, lambda: kernels.ns2d(*args),
           lambda: kernels.ns2d_plain(*args), "rho rtol 1e-6, v rtol 1e-5 atol 1e-9",
           29 * n, flops)
    geo = kernels.ns2d_geometry()
    tiles, busy, staged, halo = kernels.ns2d_staging(kit, st.node_type, geo)
    clock = torch.cuda.clock_rate()
    issue_ms = 1e3 * flops / (
        128 * torch.cuda.get_device_properties(0).multi_processor_count
        * 1e6 * clock)
    other = torch.empty_like(st.vel)
    apart = apart_ms(lambda: kernels.ns2d(*args),
                     lambda: torch.add(st.vel, st.vel, out=other))
    print(f"[kernels] ns2d tile {geo.tx} x {geo.ty} (x, y), {geo.r} x nodes a "
          f"thread, {geo.threads} threads, {geo.tile_bytes / 1e3:.1f} KB of "
          f"staged fields a block: {busy} of {tiles} tiles hold a FLUID node "
          f"and stage {geo.staged} positions each ({halo:.2f} per node of "
          f"the tile, 4 floats and a node_type byte): "
          f"{staged / 1e6:.2f} MB a launch from L2 / HBM; behind another "
          f"kernel (an elementwise add), one call at a time: {apart:.4f} ms; "
          f"its flops as unfused instructions would take {issue_ms:.4f} ms "
          f"of issue slots at {clock} MHz ("
          f"{100 * issue_ms / results['ns2d']['ms']:.1f} % of the kernel's "
          f"time back to back, {100 * issue_ms / apart:.1f} % behind "
          f"another kernel)")
    del other

    # matvec2d, on the operator of this state: W of the unknown rows, plus
    # x, diag, unknown and y (13 B/node); 2 flops per in-grid bond and 1
    # per unknown row
    op = ai.assemble(st, kit)
    n_unk = int(op.unknown.sum())
    x = torch.tensor(rng.random(kit.shape), dtype=torch.float32, device="cuda")
    mv = (x, op.W, op.diag, op.unknown, kit)
    y, yp = kernels.matvec2d(*mv), kernels.matvec2d_plain(*mv)
    err = float((y - yp).abs().max())
    inside = bond_counts(kit, op.unknown, {"one": kit.pad(
        torch.ones_like(x), 0.0)}, {"in": lambda nb: nb["one"] != 0})["in"]
    A = csr_of(op.W, op.diag, op.unknown, kit)
    xf = x.reshape(-1)
    record("matvec2d", err, err <= 1e-5 * float(yp.abs().max()),
           lambda: (kernels.matvec2d(*mv),), lambda: kernels.matvec2d_plain(*mv),
           "max|dy| <= 1e-5 max|y|", n_unk * kit.S * 4 + 13 * n,
           float(2 * inside.sum() + n_unk),
           library=lambda: torch.mv(A, xf).view(kit.shape))
    del A

    # basis kernels: a 26-row basis (restart 25) of 196,749-long vectors,
    # rows on 128-byte lines as ops.gmres allocates them. The 20.5 MB basis
    # stays in the 50 MB L2 across back-to-back calls.
    k = 26
    V = kernels.pitched_basis(k, n, torch.float32, "cuda")
    V.copy_(seeded(rng, (k, n)))
    w = seeded(rng, (n,))
    c = seeded(rng, (k,), dtype=torch.float64)
    print(f"[kernels] basis: {k} rows of {n} floats, {V.stride(0)} apart")
    record_basis_dots(record, "basis_dots", V, w)
    n_dev = device_launches(lambda: kernels.basis_dots(V, w))
    print(f"[kernels] basis_dots: {n_dev} device launch(es) a call")
    if n_dev != 1:
        fail("basis_dots is not one launch a call")
    record_basis_axpy(record, "basis_axpy", c, V, w)
    record_basis_axpy(record, "basis_axpy_k13", c[:13], V[:13], w)
    del V, w
    record_gmres_qr(record, 25, rng)
    record_cycle_qr(record)

    # ard2d: 26 B/node (C, vel[2], |v|, Ds, node_type, salt in; C out). C
    # seeded so that some FLUID neighbours of the wire reach C_sat: their
    # SOLID neighbours are salt-blocked. Flops per bond from the source:
    # liquid-liquid 17, FLUID-SOLID 10 (6 when blocked), SOLID-FLUID 6; per
    # FLUID or SOLID node 4, and 4 more per unblocked SOLID node
    st.C = torch.where(solid, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"),
        torch.where(fluid, torch.tensor(rng.random(kit.shape),
                                        dtype=torch.float32, device="cuda"),
                    0.0))
    salt = ard_ops.compute_salt_blocked(st, kit)
    Ds = ard_ops.solid_diffusivity(st.is_gb, st.is_precip, cfg,
                                   ard_ops.micro_d_factor(cfg, 0.05,
                                                          kit.dtype, "cuda"))
    vmag = ns.vel_magnitude(st.vel)
    dt_corr = float(ard_ops.compute_dt(st, kit))
    ard = (st.C, st.vel, vmag, st.node_type, Ds, salt, dt_corr, kit)
    cn, cp = kernels.ard2d(*ard), kernels.ard2d_plain(*ard)
    torch.cuda.synchronize()
    err = float((cn - cp).abs().max())
    jf = (pkg.FLUID, pkg.INLET, pkg.OUTLET, pkg.FICTITIOUS)
    counts = bond_counts(
        kit, fluid | solid,
        {"nt": nt_p, "salt": kit.pad(salt, False)},
        {"ll": lambda nb: fluid & sum(nb["nt"] == t for t in jf).bool(),
         "fs_open": lambda nb: fluid & (nb["nt"] == pkg.SOLID_MG) & ~nb["salt"],
         "fs_blocked": lambda nb: fluid & nb["salt"],
         "sf": lambda nb: solid & sum(nb["nt"] == t for t in jf).bool()})
    flops = float(17 * counts["ll"].sum() + 10 * counts["fs_open"].sum()
                  + 6 * counts["fs_blocked"].sum() + 6 * counts["sf"].sum()
                  + 4 * (fluid | solid).sum() + 4 * (solid & ~salt).sum())
    print(f"[kernels] ard2d inputs: {int(salt.sum())} of {int(solid.sum())} "
          f"SOLID nodes salt-blocked, dt {dt_corr:.4e} s; bonds: "
          + ", ".join(f"{k} {int(v.sum())}" for k, v in counts.items()))
    print(f"[kernels] ard2d bit-equal to its plain twin: {torch.equal(cn, cp)}")
    record("ard2d", err, torch.equal(cn, cp),
           lambda: (kernels.ard2d(*ard),), lambda: kernels.ard2d_plain(*ard),
           "bit-equal", 26 * n, flops)
    geo = kernels.ard2d_geometry()
    tiles, busy, staged, halo = kernels.ard2d_staging(kit, st.node_type, geo)
    issue_ms = 1e3 * flops / (
        128 * torch.cuda.get_device_properties(0).multi_processor_count
        * 1e6 * torch.cuda.clock_rate())
    other = torch.empty_like(st.vel)
    apart = apart_ms(lambda: kernels.ard2d(*ard),
                     lambda: torch.add(st.vel, st.vel, out=other))
    del other
    print(f"[kernels] ard2d tile {geo.tx} x {geo.ty} (x, y), {geo.r} x nodes "
          f"a thread, {geo.threads} threads, {geo.tile_bytes / 1e3:.1f} KB of "
          f"staged fields a block: {busy} of {tiles} tiles hold a FLUID or "
          f"SOLID node and stage {geo.staged} positions each ({halo:.2f} per "
          f"node of the tile, C, |v|, Ds, node_type and salt): "
          f"{staged / 1e6:.2f} MB a launch from L2 / HBM; behind another "
          f"kernel (an elementwise add), one call at a time: {apart:.4f} ms; "
          f"its flops as unfused instructions would take {issue_ms:.4f} ms "
          f"of issue slots at {torch.cuda.clock_rate()} MHz ("
          f"{100 * issue_ms / results['ard2d']['ms']:.1f} % of the kernel's "
          f"time back to back, {100 * issue_ms / apart:.1f} % behind "
          f"another kernel)")
    return results


def packed_traffic(packed, itemsize):
    """Bytes of the packed value and slot streams a matvec3d launch asks
    memory for, counted in whole 32-byte sectors: a thread loads a group's
    16-byte pieces only while its row has entries left in them, and lanes
    whose pieces share a sector share the fetch."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.matvec3d import (SLICE,
                                                                lane_chunk)

    count = packed.count.to(torch.int64)
    count = torch.nn.functional.pad(count, (0, -count.numel() % SLICE)).view(
        -1, SLICE)
    groups = -(-count // packed.group)           # groups a lane walks
    total = 0
    for size, chunk in ((itemsize, lane_chunk(packed.dtype, packed.group)),
                        (1, packed.group)):
        run = chunk * size                       # bytes side by side a lane
        if run >= 32:
            total += int(groups.sum()) * packed.group * size
        else:
            share = 32 // run                    # lanes to a sector
            per = groups.view(-1, SLICE // share, share).max(2).values
            total += int(per.sum()) * 32 * (packed.group // chunk)
    return total


def phase_chunked(kit, st, args, act, n_fluid, record, results):
    """kernels3d part: the four forms of csrc/ns3d_chunked.cu on the
    flagship's ns3d inputs ``args``, each bit-equal to its twin and
    within the script's gate of ns3d."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    n = math.prod(kit.shape)
    # the four forms of csrc/ns3d_chunked.cu at the script's defaults
    # (NCHUNK 6, BZ 16), each against its twin and against ns3d at the
    # script's gate (rel 1e-4). 37 B/node (rho, vel[3], p, node_type in;
    # rho, vel[3] out), j-static 16 more (the pure-act sums). Flops from
    # the source: (per active bond, per FLUID node in the epilogue,
    # accumulators), each accumulator added once per chunk; products of
    # the centre's values alone are counted once per node
    r0, v0 = kernels.ns3d(*args)
    actconv = kernels.compute_actconv(kit, st.node_type)
    flop_counts = {"ns3d_chunked_xla": (85, 25, 11),
                   "ns3d_chunked_factored": (46, 28, 11),
                   "ns3d_chunked_jconv": (33, 54, 15),
                   "ns3d_jstat": (29, 54, 11)}
    for name, form in CHUNKED_FORMS:
        if form == "jstat":
            def fn():
                return kernels.ns3d_jstat(*args, actconv, nchunk=6, bz=16)

            def plain():
                return kernels.ns3d_jstat_plain(*args, actconv, nchunk=6)
        else:
            def fn(form=form):
                return kernels.ns3d_chunked(*args, nchunk=6, bz=16,
                                            factored=form)

            def plain(form=form):
                return kernels.ns3d_chunked_plain(*args, nchunk=6,
                                                  factored=form)
        (r, v), (rp, vp) = fn(), plain()
        torch.cuda.synchronize()
        ok = torch.equal(r, rp) and torch.equal(v, vp)
        err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
        gate = max(float((r - r0).abs().max() / r0.abs().max()),
                   float((v - v0).abs().max() / v0.abs().max()))
        print(f"[kernels3d] {name} bit-equal to its plain twin: {ok}; max rel "
              f"diff vs ns3d {gate:.2e} (gate 1e-4)")
        if gate > 1e-4:
            fail(f"{name}: differs from ns3d by {gate:.2e} (gate 1e-4)")
        del r, v, rp, vp
        per_bond, per_node, n_acc = flop_counts[name]
        flops = per_bond * act + (per_node + 6 * n_acc) * n_fluid
        record(name, err, ok, fn, plain, "bit-equal",
               (53 if form == "jstat" else 37) * n, flops)
        geo = kernels.ns3d_chunked_geometry(
            {False: "xla", True: "factored"}.get(form, form), 16)
        tiles, busy, staged, halo = kernels.ns3d_staging(kit, st.node_type,
                                                         geo)
        issue_ms = 1e3 * flops / (
            128 * torch.cuda.get_device_properties(0).multi_processor_count
            * 1e6 * torch.cuda.clock_rate())
        other = torch.empty_like(st.vel)
        apart = apart_ms(fn, lambda: torch.add(st.vel, st.vel, out=other))
        del other
        ms = results[name]["ms"]
        print(f"[kernels3d] {name} at BZ 16: tile {geo.tx} x {geo.ty} x "
              f"{geo.tz} (x, y, z), {geo.r} z nodes a thread, {geo.threads} "
              f"threads, {geo.tile_bytes / 1e3:.1f} KB of staged fields a "
              f"block: {busy} of {tiles} tiles hold a FLUID node and stage "
              f"{geo.staged} positions each ({halo:.2f} per node of the "
              f"tile): {staged / 1e6:.1f} MB a launch from L2 / HBM; behind "
              f"another kernel (an elementwise add), one call at a time: "
              f"{apart:.4f} ms; its flops as unfused instructions would take "
              f"{issue_ms:.4f} ms of issue slots at "
              f"{torch.cuda.clock_rate()} MHz ({100 * issue_ms / ms:.1f} % of "
              f"the kernel's time back to back, {100 * issue_ms / apart:.1f} "
              f"% behind another kernel)")
    del r0, v0, actconv


def phase_kernels3d(pkg, overrides=(), suffix="", tag="kernels3d",
                    slab=None):
    """Phase 3 on params_3d.cfg with ``overrides``; returns {name: JSON row
    fields}. With a ``suffix`` (the calibration grid, ``@calib3d``) the
    path kernels are named ``name@shape``, and the ns3d_chunked forms,
    which run only in the ladder, are left out. With ``slab`` (a rank
    count) the grid is padded for that many ranks and the kernels run on
    rank 0's extended slab (own rows and a halo of mext rows a side), the
    basis kernels on its own rows: the shapes each rank of the ``shard``
    phase gives them (its operator keeps the halo rows' weights, which the
    sharded path zeroes: the same shapes, a few more unknown rows)."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    t0 = time.time()
    cfg = pkg.Config.load(FLAGSHIP)
    cfg.apply_overrides(list(overrides))
    grid = pkg.build_grid(cfg)
    if slab:
        from pd_mg_pin_corrosion_tpu_torch.grid import pad_grid_axial
        grid = pad_grid_axial(grid, slab)
    t1 = time.time()
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg,
                              grains=pkg.grains.generate(grid, cfg),
                              device="cuda")
    n_basis = grid.N_total
    if slab:
        kit, st, n_basis = rank0_slab(kit, st, slab)
    torch.cuda.synchronize()
    n, S = math.prod(kit.shape), kit.S
    print(f"[{tag}] grid {kit.shape} = {n} nodes, S={S}, "
          f"mext={kit.mext}, {kit.dtype}; grid built in {t1 - t0:.2f} s, "
          f"grains + kit + state in {time.time() - t1:.2f} s")
    rng = np.random.default_rng(SEED + 3)
    fluid = st.node_type == 0
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    st.C = torch.where(st.node_type == 1, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"), 0.0)
    if tag == "kernels3d":
        FLOW_KITS["flagship"] = (kit, dataclasses.replace(st))
    results = {}
    record = recorder(tag, results, calls=10)

    # ns3d: 53 B/node of unique HBM traffic (rho, vel[3], p, node_type and
    # the four pure-act sums in; rho, vel[3] out); flops from the source:
    # 29 per bond to an in-grid, non-OUTSIDE neighbour, 54 per FLUID node
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    (r, v), (rp, vp) = kernels.ns3d(*args), kernels.ns3d_plain(*args)
    torch.cuda.synchronize()
    ok = (torch.allclose(r, rp, rtol=1e-6, atol=0.0)
          and torch.allclose(v, vp, rtol=1e-4, atol=1e-9))
    err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
    print(f"[{tag}] ns3d bit-equal to its plain twin: "
          f"{torch.equal(r, rp) and torch.equal(v, vp)}")
    del r, v, rp, vp
    n_fluid = float(fluid.sum())
    act = float(bond_counts(kit, fluid, {"nt": kit.pad(st.node_type,
                                                       pkg.OUTSIDE)},
                            {"act": lambda nb: nb["nt"] != pkg.OUTSIDE}
                            )["act"].sum())
    print(f"[{tag}] {int(n_fluid)} FLUID nodes, {int(act)} bonds to "
          f"active neighbours")
    record("ns3d" + suffix, err, ok, lambda: kernels.ns3d(*args),
           lambda: kernels.ns3d_plain(*args),
           "rho rtol 1e-6, v rtol 1e-4 atol 1e-9", 53 * n,
           29 * act + 54 * n_fluid)
    geo = kernels.ns3d_geometry()
    tiles, busy, staged, halo = kernels.ns3d_staging(kit, st.node_type, geo)
    issue_ms = 1e3 * 29 * S * n_fluid / (
        128 * torch.cuda.get_device_properties(0).multi_processor_count
        * 1e6 * torch.cuda.clock_rate())
    print(f"[{tag}] ns3d tile {geo.tx} x {geo.ty} x {geo.tz} (x, y, z), "
          f"{geo.r} z nodes a thread, {geo.threads} threads, "
          f"{geo.tile_bytes / 1e3:.1f} KB of staged fields a block: {busy} of "
          f"{tiles} tiles hold a FLUID node and stage {geo.staged} positions "
          f"each ({halo:.2f} per node of the tile, 5 floats and a node_type "
          f"byte): {staged / 1e6:.1f} MB a launch from L2 / HBM, "
          f"{staged / (results['ns3d' + suffix]['ms'] * 1e-3) / 1e12:.3f} TB/s; 29 "
          f"unfused instructions a bond on every slot of every FLUID node "
          f"would take {issue_ms:.4f} ms of issue slots at "
          f"{torch.cuda.clock_rate()} MHz "
          f"({100 * issue_ms / results['ns3d' + suffix]['ms']:.1f} % of the "
          f"kernel's time)")
    other = torch.empty_like(st.vel)
    apart = apart_ms(lambda: kernels.ns3d(*args),
                     lambda: torch.add(other, other, out=other))
    results["ns3d" + suffix]["apart_ms"] = apart
    print(f"[{tag}] ns3d behind another kernel (an elementwise add), one call "
          f"at a time: {apart:.4f} ms")
    del other
    if not suffix:
        phase_chunked(kit, st, args, act, n_fluid, record, results)

    # matvec3d on the operator of this state, packed f32 and bf16 weights
    # against the dense twin. The least the card must move, whatever the
    # encoding: the nonzero weights, one bit per slot of every unknown row
    # (which slots they belong to, in whole 32-bit words), and x, diag,
    # unknown and y (13 B/node); 2 flops per nonzero weight and 1 per
    # unknown row. The
    # dense stream's count (every weight of the unknown rows, 2 flops per
    # in-grid bond) is printed beside it. Library call (f32 only): the same
    # operator as one CSR matrix, torch.mv; PyTorch has no CSR product of
    # bf16 weights with a float32 vector, so bf16 has no single call
    torch.cuda.synchronize()
    t_a = time.time()
    op = ai.assemble(st, kit)
    torch.cuda.synchronize()
    t_assemble = time.time() - t_a
    if op.W is not None:
        fail("the card's 3D f32 operator kept its dense W after packing")
    # the dense weights of the same operator, for the twins and the CSR
    # library calls only
    W = ai._dense_operator(st, kit, 0.0)[0]
    pack_s = []
    for _ in range(3):
        t_a = time.time()
        again = kernels.pack_stencil(W, op.unknown, kit)
        again16 = again.to(torch.bfloat16)
        torch.cuda.synchronize()
        pack_s.append(time.time() - t_a)
    same_pack = all(torch.equal(getattr(again, f), getattr(op.packed, f))
                    for f in ("count", "slice_ptr", "slots", "values")
                    ) and torch.equal(
                        again16.values, op.W16.values)
    del again, again16
    n_unk = int(op.unknown.sum())
    nnz, words = op.packed.nnz, -(-S // 32)
    stored = op.packed.values.numel()
    x = torch.tensor(rng.random(kit.shape), dtype=torch.float32, device="cuda")
    inside = float(bond_counts(kit, op.unknown, {"one": kit.pad(
        torch.ones_like(x), 0.0)}, {"in": lambda nb: nb["one"] != 0}
                               )["in"].sum())
    print(f"[{tag}] operator: {n_unk} unknown rows, {int(inside)} "
          f"in-grid bonds, {nnz} nonzero weights; dense W "
          f"{W.numel() * 4 / 1e6:.1f} MB f32 (built for the twins: the "
          f"operator holds none)")
    print(f"[{tag}] packed: {stored} stored values (slice padding "
          f"{stored / max(nnz, 1):.4f} stored per nonzero), a slot byte "
          f"beside each; {op.packed.nbytes() / 1e6:.1f} MB with f32 "
          f"values, {op.W16.nbytes() / 1e6:.1f} MB with bf16 values (slot "
          f"bytes, counts and slice_ptr shared, "
          f"{(op.packed.nbytes() - 4 * stored) / 1e6:.1f} MB); pack_stencil "
          f"+ bf16 copy of the dense W "
          f"{1e3 * statistics.median(pack_s):.2f} ms per cycle (median of "
          f"3, host clock), assemble (pack3d from the state, one sizing "
          f"read) {1e3 * t_assemble:.2f} ms; pack_stencil gives the "
          f"operator's bits: {same_pack}")
    if not same_pack:
        fail("pack_stencil of the dense W differs from the operator's "
             "packing (pack3d)")
    if not suffix and not slab:
        record_pack3d(record, tag, kit, st, op, W)
    A = csr_of(W, op.diag, op.unknown, kit)
    xf = x.reshape(-1)
    print(f"[{tag}] CSR operator: {A.values().numel()} nonzeros")
    for name, packed, wbytes, lib in (
            ("matvec3d", op.packed, 4,
             lambda: torch.mv(A, xf).view(kit.shape)),
            ("matvec3d_bf16", op.W16, 2, None)):
        mv = (x, packed, op.diag, op.unknown, kit)
        W_dense = W if wbytes == 4 else W.to(torch.bfloat16)
        twin = (x, W_dense, op.diag, op.unknown, kit)
        y, yp = kernels.matvec3d(*mv), kernels.matvec3d_plain(*twin)
        err = float((y - yp).abs().max())
        same = torch.equal(y, yp)
        print(f"[{tag}] {name} bit-equal to its dense twin: {same}")
        del y, yp
        dense_ms, _ = bound(n_unk * S * wbytes + 13 * n, 2 * inside + n_unk)
        print(f"[{tag}] {name} bound of the dense stream "
              f"({(n_unk * S * wbytes + 13 * n) / 1e6:.1f} MB): "
              f"{dense_ms:.4f} ms")
        record(name + suffix, err, same,
               lambda mv=mv: (kernels.matvec3d(*mv),),
               lambda twin=twin: kernels.matvec3d_plain(*twin),
               "bit-equal", nnz * wbytes + 4 * words * n_unk + 13 * n,
               2.0 * nnz + n_unk, library=lib)
        other = torch.empty_like(x)
        apart = apart_ms(lambda: kernels.matvec3d(*mv),
                         lambda: torch.add(x, x, out=other))
        results[name + suffix]["apart_ms"] = apart
        moved = packed_traffic(packed, wbytes) + 15 * n
        print(f"[{tag}] {name} behind another kernel (an elementwise "
              f"add), one call at a time: {apart:.4f} ms; its streams ask "
              f"for {moved / 1e6:.1f} MB in whole sectors (slot bytes, "
              f"counts and vectors included): "
              f"{moved / (results[name + suffix]['ms'] * 1e-3) / 1e12:.3f} "
              f"TB/s")
        del W_dense, twin, other
    # the f64 slot sum's library call: the same nonzeros (no diagonal) as
    # one float64 CSR matrix, the f32 weights widened exactly
    A_slots = csr_of(W, None, op.unknown, kit)
    A64 = torch.sparse_csr_tensor(A_slots.crow_indices(),
                                  A_slots.col_indices(),
                                  A_slots.values().double(), size=A.shape)
    del A, A_slots

    # basis_axpy on a 26-row basis of grid-long vectors (flagship: 110 MB,
    # from HBM, not the L2)
    V = kernels.pitched_basis(26, n_basis, torch.float32, "cuda")
    V.copy_(seeded(rng, (26, n_basis)))
    w = seeded(rng, (n_basis,))
    c = seeded(rng, (26,), dtype=torch.float64)
    # basis_dots on the same basis, on its first 13 rows (flagship only),
    # and the k = 1 self-dot that is every GMRES norm
    if suffix:
        record_basis_axpy(record, "basis_axpy" + suffix, c, V, w)
        record_basis_dots(record, "basis_dots" + suffix, V, w)
        record_basis_dots(record, f"basis_dots{suffix}_k1", w[None], w)
    else:
        record_basis_axpy(record, "basis_axpy_3d", c, V, w)
        record_basis_dots(record, "basis_dots_3d", V, w)
        record_basis_dots(record, "basis_dots_3d_k13", V[:13], w)
        record_basis_dots(record, "basis_norm_3d", w[None], w)
    del V, w

    # slots3d_f64 over the packed f32 weights against the dense twin, x of
    # both signs with exact zeros. The least it must move, on matvec3d's
    # count: the nonzero weights, a bit per slot of every unknown row (whole
    # 32-bit words), x and y in f64 and the unknown mask (17 B/node); 2 f64
    # flops per nonzero weight
    x64 = torch.tensor(rng.normal(size=kit.shape) * (rng.random(kit.shape)
                                                     > 0.1),
                       dtype=torch.float64, device="cuda")
    y = kernels.slots3d_f64(x64, op.packed, kit)
    yp = kernels.slots3d_f64_plain(x64, W, kit)
    err = float((y - yp).abs().max())
    same = torch.equal(y, yp)
    print(f"[{tag}] slots3d_f64 (packed f32 weights) bit-equal to its "
          f"dense plain twin: {same}")
    del y, yp
    n_dev = device_launches(lambda: kernels.slots3d_f64(x64, op.packed, kit))
    print(f"[{tag}] slots3d_f64: {n_dev} device launch(es) a call")
    if n_dev != 1:
        fail("slots3d_f64 is not one launch a call")
    nbytes = nnz * 4 + 4 * words * n_unk + 17 * n
    dense_ms, _ = bound(n * S * 4 + 16 * n, 2.0 * nnz, F64_RATE)
    print(f"[{tag}] slots3d_f64: {nbytes / 1e6:.1f} MB on the nonzeros "
          f"(the dense W and its vectors, {(n * S * 4 + 16 * n) / 1e6:.1f} "
          f"MB, would bound it at {dense_ms:.4f} ms)")
    x64f = x64.reshape(-1)
    record("slots3d_f64" + suffix, err, same,
           lambda: (kernels.slots3d_f64(x64, op.packed, kit),),
           lambda: kernels.slots3d_f64_plain(x64, W, kit), "bit-equal",
           nbytes, 2.0 * nnz, rate=F64_RATE,
           library=lambda: torch.mv(A64, x64f).view(kit.shape))
    other = torch.empty_like(x64)
    apart = apart_ms(lambda: kernels.slots3d_f64(x64, op.packed, kit),
                     lambda: torch.add(x64, x64, out=other))
    results["slots3d_f64" + suffix]["apart_ms"] = apart
    moved = packed_traffic(op.packed, 4) + 19 * n
    print(f"[{tag}] slots3d_f64 behind another kernel (an elementwise "
          f"add), one call at a time: {apart:.4f} ms "
          f"({100 * results['slots3d_f64' + suffix]['bound_ms'] / apart:.1f} % of the "
          f"bound); its streams ask for {moved / 1e6:.1f} MB in whole "
          f"sectors (slot bytes, counts and vectors included)")
    del A64, other, W
    print(f"[{tag}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return results


def print_gmres(tag, solver):
    """The ``[gmres]`` and ``[step]`` lines of a run: its Arnoldi steps and
    implicit steps by route, graph launches, chunks and host reads."""
    g, t = solver.gmres_graph, solver.step_graph
    print(f"[gmres] {tag}: {g['replays']} graph replays, {g['eager']} eager "
          f"Arnoldi steps, {g['cycles']} GMRES cycles, {g['launches']} solve "
          f"graph launches, {g['captures']} captures ({g['recaptures']} "
          f"recaptures), {t['chunks']} chunks, {g['host_reads']} host reads "
          f"inside steps, kernel nodes {g['captured_kernels']} captured / "
          f"{g['replayed_kernels']} replayed")
    print(f"[step] {tag}: {t['replays']} graph replays, {t['eager']} eager "
          f"steps, {t['launches']} graph launches, {t['captures']} captures "
          f"({t['recaptures']} recaptures), {t['chunks']} chunks, "
          f"{t['host_reads']} host reads ({t['host_reads'] / max(t['steps'], 1):.3f}"
          f" a step), kernel nodes {t['captured_kernels']} captured / "
          f"{t['replayed_kernels']} replayed")


def run_cli(out_dir, args):
    """cli.run with its console output kept in out_dir/run.log."""
    from pd_mg_pin_corrosion_tpu_torch import cli

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "run.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        solver = cli.run(args + [f"output_dir={out_dir}/out"])
    g = solver.flow_graph
    print(f"[flow] {os.path.basename(out_dir)}: {g['replays']} graph "
          f"replays, {g['eager']} eager iterations, {g['captures']} captures")
    print_gmres(os.path.basename(out_dir), solver)
    return solver, np.atleast_1d(np.genfromtxt(
        f"{out_dir}/out/diagnostics.csv", delimiter=",", names=True))


@contextlib.contextmanager
def recording(module, name, calls):
    """module.<name> wrapped for the block: each call appends (args,
    result, seconds to the device's end, the kernels' launches in it)."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    real = getattr(module, name)

    def wrapped(*a, **k):
        n0 = kernels.launch_counts()
        t0 = time.time()
        r = real(*a, **k)
        torch.cuda.synchronize()
        calls.append((a, r, time.time() - t0,
                      {n: c - n0[n] for n, c in kernels.launch_counts().items()}))
        return r
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def compare_rows(tag, what, g, c, loss_atol=0.0, gates=None):
    """Fail unless the diagnostics rows g (CUDA) and c (CPU) have the same
    solid_nodes and every other column within 1e-4 relative, or within
    its own limit in ``gates`` (the mass loss may instead differ by
    loss_atol)."""
    gates = {col: (gates or {}).get(col, 1e-4)
             for col in ("time_s", "pin_mass_loss_pct", "v_max",
                         "C_max_fluid")}
    same_solid = (len(g) == len(c)
                  and np.array_equal(g["solid_nodes"], c["solid_nodes"]))
    diffs, loss_abs = {}, float("inf")
    if same_solid:
        for col in ("time_s", "pin_mass_loss_pct", "v_max", "C_max_fluid"):
            rel = (np.abs(g[col] - c[col])
                   / np.maximum(np.abs(c[col]), 1e-300))
            diffs[col] = float(rel.max())
        loss_abs = float(np.abs(g["pin_mass_loss_pct"]
                                - c["pin_mass_loss_pct"]).max())
    shown = (f"{gates['v_max']:g}" if len(set(gates.values())) == 1
             else json.dumps(gates))
    print(f"[{tag}] {what}: {len(g)} rows; solid_nodes equal: {same_solid}; "
          f"max rel diff by column {json.dumps(diffs)} (limit {shown}); "
          f"max abs diff of the loss {loss_abs:.3e} % (limit "
          f"{loss_atol:.3e} %)")
    loss_ok = (diffs.get("pin_mass_loss_pct", 1.0)
               <= gates["pin_mass_loss_pct"] or loss_abs <= loss_atol)
    if (not same_solid or not loss_ok or any(
            v > gates[k] for k, v in diffs.items()
            if k != "pin_mass_loss_pct")):
        fail(f"{what}: CUDA vs CPU disagree")


def run_cuda_and_cpu(tmp, tag, name, args, loss_atol=0.0, gates=None):
    """run_cli on CUDA and on the CPU; compare_rows of the two (``gates``:
    a limit by column instead of 1e-4). Returns the CUDA run's solver and
    rows and the kernels' launches in that run."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.time()
    solver, g = run_cli(os.path.join(tmp, f"{name}_cuda"),
                        args + ["--device", "cuda"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # the flow's graph route on the card but for gs_parity's host sweeps
    # and float64 (its NS step is the plain twin, solvers.FlowRunner)
    if (not solver.flow_graph["replays"] and "gs_parity=1" not in args
            and "precision=f64" not in args):
        fail(f"{name}: the CUDA run's flow replayed no CUDA graph")
    # an implicit run (the configuration's use_implicit, or an override)
    implicit = solver.explicit_steps == 0
    if not solver.gmres_graph["replays"] and implicit:
        fail(f"{name}: the CUDA run's Arnoldi steps replayed no CUDA graph")
    # gs_parity's host sweeps run each step's head and tail directly, its
    # solve as a graph
    if (not solver.step_graph["replays"] and implicit
            and "gs_parity=1" not in args):
        fail(f"{name}: the CUDA run's implicit steps ran in no CUDA graph")
    t1 = time.time()
    _, c = run_cli(os.path.join(tmp, f"{name}_cpu"), args + ["--device",
                                                            "cpu"])
    compare_rows(tag, f"{name} (cuda {t1 - t0:.2f} s, cpu "
                 f"{time.time() - t1:.2f} s)", g, c, loss_atol, gates=gates)
    return solver, g, counts


def phase_main(tmp):
    """Phase 5; returns the launch counts of the 2D main path's run."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.time()
    solver, rows = run_cli(os.path.join(tmp, "fine"),
                           [FINE, *MAIN_CAPS, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    st = solver.final_state
    flow_rate = solver.flow_iters / max(solver.flow_seconds, 1e-9)
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps, 1)
    print(f"[main] params_fine_calibration.cfg {' '.join(MAIN_CAPS)}: "
          f"{solver.cycles} cycles, steps per cycle {solver.cycle_steps}, "
          f"{solver.flow_solve_count} flow solves, {solver.flow_iters} flow "
          f"iterations in {solver.flow_seconds:.3f} s, "
          f"{solver.total_dissolved} dissolved, wall {wall:.2f} s")
    print(f"[main] flow iterations/s {flow_rate:.1f}; "
          f"ms per implicit step {step_ms:.3f} "
          f"({solver.total_implicit_steps} steps in {solver.implicit_seconds:.3f} s)")
    print(f"[main] launches {json.dumps(counts)}")
    last = rows[-1]
    print(f"[main] last row: t={last['time_s']:.1f} s loss={last['pin_mass_loss_pct']:.6e} % "
          f"solid={int(last['solid_nodes'])} v_max={last['v_max']:.6e} "
          f"C_max_fluid={last['C_max_fluid']:.6e}")

    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            solver.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            solver.step_graph["replays"] > 0,
        "a complete cycle (flow solve, assemble, >= 5 steps, phase change)":
            solver.flow_solve_count >= 1 and len(solver.cycle_steps) >= 1
            and solver.cycle_steps[0] >= 5,
        "finite diagnostics": all(np.isfinite(rows[c]).all()
                                  for c in rows.dtype.names),
        "pin_mass_loss_pct does not decrease":
            bool(np.all(np.diff(rows["pin_mass_loss_pct"]) >= 0.0)),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "every kernel of the 2D path launched":
            all(counts[k] > 0 for k in PATH_2D),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
    }
    for what, ok in checks.items():
        print(f"[main] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("main path checks")
    return counts


def phase_main3d(tmp):
    """Phase 7; returns (the launch counts of the 3D main path's run,
    None): params_3d.cfg runs the fused coupling cycles, whose flow solves
    run inside their program, so warm3d makes its own cold solve."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.checkpoint import load_checkpoint

    from pd_mg_pin_corrosion_tpu_torch import coupling

    out_dir = os.path.join(tmp, "flagship")
    # per operator assembled: whether it kept a dense W, and the peak
    # device memory right after its assembly
    assembled = []
    real_assemble = coupling.assemble

    def assemble(*a, **k):
        op = real_assemble(*a, **k)
        torch.cuda.synchronize()
        assembled.append((op.W is not None, torch.cuda.max_memory_allocated()))
        return op
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    coupling.assemble = assemble
    try:
        t0 = time.time()
        solver, rows = run_cli(out_dir, [FLAGSHIP, *MAIN3D_CAPS, "--device",
                                         "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        coupling.assemble = real_assemble
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dense_w = any(d for d, _ in assembled)
    at_assembly = max((m for _, m in assembled), default=0)
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("Grid:", "Flow:", "Implicit cycle",
                                       "WARNING", "Checkpoint", "[Timer]",
                                       "=== Fused chunk")):
                print(f"[main3d] log: {line.rstrip()}")
    st = solver.final_state
    print(f"[main3d] params_3d.cfg {' '.join(MAIN3D_CAPS)}: {solver.cycles} "
          f"cycles, steps per cycle {solver.cycle_steps}, flow solves "
          f"{solver.flow_results}, {solver.flow_iters} flow iterations and "
          f"{solver.total_implicit_steps} implicit steps in fused launches "
          f"of {solver.fused_seconds:.3f} s, wall {wall:.2f} s; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[main3d] {len(assembled)} operator(s) assembled, "
          f"{'one holding' if dense_w else 'none holding'} a dense W; peak "
          f"device memory {peak / 2**30:.2f} GiB, set by "
          f"{'assembly' if peak == at_assembly else 'the steps'} (peak right "
          f"after the last assembly {at_assembly / 2**30:.2f} GiB)")
    print(f"[main3d] launches {json.dumps(counts)}")
    t, cyc = solver.step_graph, solver.cycle_graph
    print(f"[main3d] coupled_fused_cycles = 8: {cyc['launches']} graph "
          f"launches of the fused cycles in {solver.fused_seconds:.3f} s, "
          f"{cyc['host_reads']} host reads, {cyc['captures']} captures, "
          f"{cyc['micro_ops']} micro-ops, {cyc['flow_iters']} flow "
          f"iterations in graphs; inside them {t['steps']} steps, "
          f"{t['host_reads']} step reads, {t['chunks']} chunks")

    ck, t_ck, _ = load_checkpoint(f"{out_dir}/out/checkpoint.npz", st)
    same_ckpt = (t_ck == float(rows["time_s"][-1]) and all(
        torch.equal(a, b) for a, b in zip(ck.tensors(), st.tensors())))
    banked = np.atleast_1d(np.genfromtxt(BANKED, delimiter=",", names=True))
    banked = banked[:len(rows)]
    diffs = {}
    if len(banked) == len(rows):
        ratio = {c: rows[c] / banked[c]
                 for c in ("pin_mass_loss_pct", "v_max", "C_max_fluid")}
        diffs = {c: float(np.abs(r - 1.0).max()) for c, r in ratio.items()}
    print(f"[main3d] vs docs/runs/3d_1M/diagnostics.csv, first {len(rows)} "
          f"rows: max rel diff {json.dumps(diffs)} (gates "
          f"{json.dumps(BANKED_GATES)})")
    last = rows[-1]
    print(f"[main3d] last row: t={last['time_s']:.1f} s loss="
          f"{last['pin_mass_loss_pct']:.6e} % solid={int(last['solid_nodes'])} "
          f"v_max={last['v_max']:.6e} C_max_fluid={last['C_max_fluid']:.6e}")
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            solver.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            solver.step_graph["replays"] > 0,
        "the cycles ran as fused launches, one graph launch and one read "
        "each, no read inside (no chunk, step, GMRES or gate read)":
            cyc["launches"] > 0 and cyc["host_reads"] == cyc["launches"]
            and cyc["eager_launches"] == 0 and t["host_reads"] == 0
            and t["chunks"] == 0 and solver.gmres_graph["host_reads"] == 0
            and t["steps"] == solver.total_implicit_steps
            and cyc["cycles"] == solver.cycles,
        "the initial flow solve converged":
            bool(solver.flow_results) and bool(solver.flow_results[0][2]),
        "it stopped where the banked run's did (6,500 iterations, eps "
        "4.735e-6)": bool(solver.flow_results)
            and solver.flow_results[0][0] == 6500
            and f"{solver.flow_results[0][1]:.3e}" == "4.735e-06",
        "20 rows, all finite": len(rows) == 20 and all(
            np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "every kernel of the fused 3D path launched":
            all(counts[k] > 0 for k in PATH_CYCLES),
        "no operator kept a dense W": bool(assembled) and not dense_w,
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
        "the checkpoint reloads equal to final_state": same_ckpt,
        "solid_nodes 31,600 on every row":
            bool(np.all(rows["solid_nodes"] == 31600)),
        "time_s equal to the banked run's": len(banked) == len(rows)
            and np.allclose(rows["time_s"], banked["time_s"], rtol=1e-9),
        "the banked-run gates": bool(diffs) and all(
            diffs[c] <= g for c, g in BANKED_GATES.items()),
    }
    for what, ok in checks.items():
        print(f"[main3d] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("3D main path checks")
    return counts, None


def _listing(out):
    """{name: sha256} of a run's CSV, VTI and PVD files."""
    import hashlib
    return {n: hashlib.sha256(open(os.path.join(out, n), "rb").read()
                              ).hexdigest()
            for n in sorted(os.listdir(out))
            if n.endswith((".csv", ".vti", ".pvd"))}


def phase_cycles3d(tmp, pkg):
    """Phase 8: the flagship's fused coupling cycles at full size
    (CYCLES3D_T_FINAL). The kit is built once; the configuration as
    shipped runs on the fused route (``coupling.CycleRunner``: up to 8
    cycles a launch, one CUDA graph launch and one read each) and with
    coupled_fused_cycles = 0 on the host loop, both with
    PD_TPU_PHASE_TIMERS=1. Checks: the CSVs, VTI and PVD files byte for
    byte, the steps a cycle, the flow solves and the final state equal;
    the rows against docs/runs/3d_1M within BANKED_GATES with solid_nodes
    exact and time_s within CYCLES3D_TIME_GATE, the bank's solid counts
    CYCLES3D_SOLIDS reached; one
    read a launch and none inside (no step, GMRES or gate read); every
    kernel of PATH_CYCLES launched in the fused run. Then, from the
    initial state on the same kit: one flow segment of the program (2,000
    iterations: a launch with a flow budget of one segment) against
    solve_steady's 2,000 iterations (the FlowRunner graph between host
    checks), the same rho and vel bits, ms an iteration each; the
    operator's assembly on the device into the runner's buffers
    (``assemble_into``: pack3d from the state) against the host loop's
    (``assemble``: pack3d with one sizing read, then the copy into the
    buffers). Returns the fused run's launch counts."""
    import copy

    from pd_mg_pin_corrosion_tpu_torch import cli, coupling, kernels, solvers
    from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres as gm
    from pd_mg_pin_corrosion_tpu_torch.ops.ard_implicit import assemble_into

    cfg = pkg.Config.load(FLAGSHIP)
    cfg.apply_overrides([f"T_final={CYCLES3D_T_FINAL}"])
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        grid, kit, state = cli.build(cfg, torch.device("cuda"))
    print(f"[cycles3d] params_3d.cfg T_final={CYCLES3D_T_FINAL:g}: kit "
          f"built once in {time.time() - t0:.2f} s; coupled_fused_cycles "
          f"{cfg.coupled_fused_cycles}, coupled_launch_steps "
          f"{cfg.coupled_launch_steps}, coupled_launch_flow_iters "
          f"{cfg.coupled_launch_flow_iters}")
    runs = {}
    was = os.environ.get("PD_TPU_PHASE_TIMERS")
    os.environ["PD_TPU_PHASE_TIMERS"] = "1"
    try:
        for tag, fused in (("fused", cfg.coupled_fused_cycles), ("host", 0)):
            c = copy.copy(cfg)
            c.coupled_fused_cycles = fused
            out = c.output_dir = os.path.join(tmp, f"cycles3d_{tag}")
            os.makedirs(out, exist_ok=True)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            with open(os.path.join(out, "run.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                solver = coupling.CoupledSolver()
                solver.run(grid, state, kit, c)
            torch.cuda.synchronize()
            runs[tag] = (solver, time.time() - t1, kernels.launch_counts(),
                         out)
            if tag == "fused":
                fs_capture_ms = coupling.cycle_runner_for(kit).run.capture_ms
    finally:
        if was is None:
            del os.environ["PD_TPU_PHASE_TIMERS"]
        else:
            os.environ["PD_TPU_PHASE_TIMERS"] = was
    (fs, f_wall, counts, f_out), (hs, h_wall, h_counts, h_out) = (
        runs["fused"], runs["host"])
    for tag, (solver, wall, _, out) in runs.items():
        for line in log_lines(out, "[launch]", "=== Fused chunk",
                              "Flow:", "Phase change", "WARNING"):
            print(f"[cycles3d] {tag} log: {line}")
        print(f"[cycles3d] {tag}: wall {wall:.3f} s; {solver.cycles} cycles, "
              f"steps per cycle {solver.cycle_steps}, flow solves "
              f"{solver.flow_results}, {solver.flow_iters} flow iterations; "
              f"[flow] {json.dumps(solver.flow_graph)}")
        print_gmres(f"cycles3d_{tag}", solver)
    g = fs.cycle_graph
    host_reads = (hs.step_graph["host_reads"] + hs.flow_graph["eager"])
    print(f"[cycles3d] fused: {g['launches']} graph launches, "
          f"{g['host_reads']} host reads, {g['captures']} captures, "
          f"{g['cycles']} cycles, {g['micro_ops']} micro-ops, "
          f"{g['flow_iters']} flow iterations in graphs, "
          f"{g['pack_overflows']} pack overflows, kernel nodes "
          f"{g['captured_kernels']} captured / {g['replayed_kernels']} "
          f"replayed, the runner's captures {fs_capture_ms:.1f} ms in all; "
          f"host loop: {hs.step_graph['chunks']} step chunks "
          f"and {hs.flow_graph['eager']} eager flow iterations (check "
          f"iterations, each a read), {host_reads} reads in all; wall "
          f"fused {f_wall:.3f} s / host loop {h_wall:.3f} s "
          f"({100.0 * (f_wall / h_wall - 1.0):+.2f} %)")
    print(f"[cycles3d] launches fused {json.dumps(counts)}")
    print(f"[cycles3d] launches host loop {json.dumps(h_counts)}")
    f_files, h_files = _listing(os.path.join(f_out)), _listing(h_out)
    f_rows = np.atleast_1d(np.genfromtxt(f"{f_out}/diagnostics.csv",
                                         delimiter=",", names=True))
    banked = np.atleast_1d(np.genfromtxt(BANKED, delimiter=",", names=True))
    banked = banked[:len(f_rows)]
    diffs = {}
    if len(banked) == len(f_rows):
        diffs = {c: float(np.abs(f_rows[c] / banked[c] - 1.0).max())
                 for c in BANKED_GATES}
    t_rel = solid_off = None
    if len(banked) == len(f_rows):
        t_rel = float(np.abs(f_rows["time_s"] / banked["time_s"] - 1.0).max())
        solid_off = [(float(a), int(b), int(c)) for a, b, c in zip(
            f_rows["time_s"], f_rows["solid_nodes"], banked["solid_nodes"])
            if b != c]
    print(f"[cycles3d] {len(f_rows)} rows vs docs/runs/3d_1M: max rel diff "
          f"{json.dumps(diffs)} (gates {json.dumps(BANKED_GATES)}); time_s "
          f"max rel diff {t_rel}; rows whose solid_nodes differ (t, ours, "
          f"bank's) {solid_off}")
    same_state = all(torch.equal(a, b) for a, b in zip(
        fs.final_state.tensors(), hs.final_state.tensors()))

    # one flow segment of the program against solve_steady, from the
    # initial state (the fused run's recorded graph serves it)
    cy = coupling.cycle_runner_for(kit)
    cy.prepare(state, kit, cfg.coupled_fused_cycles, cy.run.lay.cap,
               bool(cfg.implicit_extrapolate_x0))
    params = {**dict.fromkeys(cl.PARAMS, 0.0),
              **dict(T_FINAL=cfg.T_final, MAX_CYCLES=8, MAX_INNER=200,
                     FLOW_CAP=2000, FLOW_CAP_INIT=cfg.flow_max_iters,
                     STEP_CAP=200,
                     FLOW_ITER_CAP=1, OUT_EVERY=200, FLOW_STRIDE=2 ** 30,
                     CYCLE_CAP=8, NREC=cy.lay.nrec, NEED_FLOW=1)}
    chunk = dict(t0=0.0, T_final=cfg.T_final, total0=0, steps_left=200,
                 cap=200, batch=cfg.dissolution_batch, diag_every=1,
                 out_every=200)
    # launches from the initial state until one records no program (the
    # host loop's larger operator may have grown the runner's buffers,
    # which drops their graphs); the last is timed
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    for _ in range(3):
        cy.prepare(state, kit, cfg.coupled_fused_cycles, cy.run.lay.cap,
                   bool(cfg.implicit_extrapolate_x0))
        captures = gm.CYCLE_COUNTS["captures"]
        a.record()
        y, _ = cy.launch(kit, params, chunk)
        b.record()
        b.synchronize()
        if gm.CYCLE_COUNTS["captures"] == captures:
            break
    recorded = gm.CYCLE_COUNTS["captures"] - captures
    seg_ms = a.elapsed_time(b)
    seg_iters = int(y[cl.SC["FLOW_ITERS"]])
    prog = cy.state()
    a.record()
    flow, iters, *_ = solvers.solve_steady(state, kit, max_iters=seg_iters)
    b.record()
    b.synchronize()
    host_ms = a.elapsed_time(b)
    same_flow = (torch.equal(prog.rho, flow.rho)
                 and torch.equal(prog.vel, flow.vel))
    print(f"[cycles3d] one flow segment in the program: {seg_iters} "
          f"iterations in {seg_ms:.1f} ms ({seg_ms / max(seg_iters, 1):.4f} "
          f"ms an iteration, the launch's BEGINs and read included, "
          f"{recorded} recordings in it); solve_steady "
          f"(FlowRunner): {iters - 1} iterations in {host_ms:.1f} ms "
          f"({host_ms / max(iters - 1, 1):.4f} ms an iteration); rho and "
          f"vel bit-equal: {same_flow}")
    # the operator's assembly, device route against the host loop's
    st = cy.state()
    vol = coupling.volume_loss_fraction(st, kit)
    dev_ms, host_s = [], []
    for _ in range(3):
        a.record()
        assemble_into(cy.run.op, st, kit, vol, cy.status)
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b))
        t1 = time.time()
        cy.run.load(coupling.assemble(st, kit, vol))
        torch.cuda.synchronize()
        host_s.append(time.time() - t1)
    print(f"[cycles3d] assembly a cycle: on the device into the runner's "
          f"buffers (assemble_into: pack3d from the state) "
          f"{statistics.median(dev_ms):.2f} ms (CUDA events, eager "
          f"launches); host loop (assemble: pack3d with one sizing read, "
          f"then the copy into the buffers) "
          f"{1e3 * statistics.median(host_s):.2f} ms (host clock); median "
          f"of 3; the host loop's runs measured "
          f"{1e3 * hs.assemble_seconds / max(hs.cycles, 1):.2f} ms a cycle")

    solids = set(int(v) for v in f_rows["solid_nodes"])
    checks = {
        "the fused route ran: graph launches, one host read each, no "
        "direct run": g["launches"] > 0 and g["host_reads"] == g["launches"]
        and g["eager_launches"] == 0 and g["captures"] >= 1,
        "no read inside a launch (no step, GMRES or gate read)":
            fs.step_graph["host_reads"] == 0
            and fs.gmres_graph["host_reads"] == 0
            and fs.step_graph["chunks"] == 0,
        "the flow, the Arnoldi steps and the steps ran in graphs":
            fs.flow_graph["replays"] > 0 == fs.flow_graph["eager"]
            and fs.gmres_graph["replays"] > 0 == fs.gmres_graph["eager"]
            and fs.step_graph["replays"] > 0 == fs.step_graph["eager"],
        "up to 8 cycles a launch": g["cycles"] == fs.cycles
        and g["launches"] >= 1,
        "the host loop took no fused launch": hs.cycle_graph["launches"] == 0
        and hs.cycle_graph["eager_launches"] == 0,
        "CSV, VTI and PVD files byte for byte": f_files == h_files
        and any(n.endswith(".vti") for n in f_files),
        "steps per cycle and flow solves equal":
            fs.cycle_steps == hs.cycle_steps
            and fs.flow_results == hs.flow_results
            and fs.flow_solve_count == hs.flow_solve_count,
        "final state equal": same_state,
        "the bank's first two phase changes":
            solids == set(CYCLES3D_SOLIDS),
        "rows finite": all(np.isfinite(f_rows[c]).all()
                           for c in f_rows.dtype.names),
        "solid_nodes equal to the bank's, time_s within one unit of its "
        "7th printed digit": len(banked) == len(f_rows) and not solid_off
            and t_rel <= CYCLES3D_TIME_GATE,
        "the banked-run gates": bool(diffs) and all(
            diffs[c] <= lim for c, lim in BANKED_GATES.items()),
        "no GMRES non-convergence warning": fs.gmres_warnings == 0,
        "every kernel of the fused path launched":
            all(counts[k] > 0 for k in PATH_CYCLES),
        "the flow segment in the program equals solve_steady's":
            same_flow and seg_iters == iters - 1 == 2000 and recorded == 0,
    }
    for what, ok in checks.items():
        print(f"[cycles3d] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("cycles3d checks")
    return counts


def fluid_l2(a, b, fluid):
    """Relative L2 of a against b over the FLUID nodes, in float64."""
    m = fluid.reshape(fluid.shape + (1,) * (a.dim() - fluid.dim()))
    d = torch.where(m, a.double() - b.double(), 0.0)
    return float(torch.sqrt((d * d).sum() / torch.where(
        m, b.double() ** 2, 0.0).sum()))


WARM_LINE = re.compile(r"Warm start: coarse \((\d+)x dx, (\d+) nodes\) solve "
                       r"(\d+) iters, eps=(\S+), converged=(True|False)")


def phase_warm3d(tmp, cold):
    """Phase 9: the warm-started flagship; ``cold`` is main3d's initial
    flow solve (state, iterations, seconds) or None. Returns the launch
    counts of the run."""
    import pd_mg_pin_corrosion_tpu_torch as pkg
    from pd_mg_pin_corrosion_tpu_torch import coupling, kernels, solvers

    if cold is None:
        # the cold initial solve of the same configuration
        cfg = pkg.Config.load(FLAGSHIP)
        cfg.apply_overrides(MAIN3D_CAPS)
        grid = pkg.build_grid(cfg)
        kit = pkg.build_kit(grid, cfg, device="cuda")
        st = pkg.initialize_state(grid, cfg, grains=pkg.grains.generate(
            grid, cfg), device="cuda")
        t0 = time.time()
        flow, iters, *_ = solvers.solve_steady(st, kit)
        torch.cuda.synchronize()
        cold = (flow, iters, time.time() - t0)
        del kit, st
    cold_flow, cold_iters, cold_s = cold
    out_dir = os.path.join(tmp, "warm3d")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    warm, solves = [], []
    t0 = time.time()
    with recording(coupling, "coarse_warm_start", warm), \
            recording(coupling, "solve_steady", solves):
        solver, rows = run_cli(out_dir, [FLAGSHIP, *WARM3D_CAPS, "--device",
                                         "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "run.log")) as f:
        log = f.read()
    for line in log.splitlines():
        if any(k in line for k in ("Warm start", "Flow:", "Implicit cycle",
                                   "WARNING", "[Timer]")):
            print(f"[warm3d] log: {line.rstrip()}")
    m = WARM_LINE.search(log)
    if m is None or not warm or not solves:
        fail("warm3d: the run printed no warm-start line")
    ratio, c_nodes, c_iters, c_eps, c_conv = m.groups()
    (_, _, warm_s, warm_launches) = warm[0]
    (_, (flow, iters, eps, conv, _), fine_s, fine_launches) = solves[0]
    fluid = cold_flow.node_type == pkg.FLUID
    l2_vel = fluid_l2(flow.vel, cold_flow.vel, fluid)
    l2_rho = fluid_l2(flow.rho, cold_flow.rho, fluid)
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps, 1)
    print(f"[warm3d] params_3d.cfg {' '.join(WARM3D_CAPS)}: coarse grid "
          f"({ratio}x dx) {c_nodes} nodes, {c_iters} iterations, eps "
          f"{c_eps}, converged={c_conv}, {warm_s:.3f} s with the sampling "
          f"onto the fine grid; fine grid {iters} iterations, eps "
          f"{eps:.3e}, converged={conv}, {fine_s:.3f} s; cold {cold_iters} "
          f"iterations, {cold_s:.3f} s")
    print(f"[warm3d] initial flow phase {warm_s + fine_s:.3f} s warm vs "
          f"{cold_s:.3f} s cold (host clock, one run each); "
          f"ns3d launches: {warm_launches['ns3d']} on the coarse grid, "
          f"{fine_launches['ns3d']} on the fine grid, {counts['ns3d']} in "
          f"the run")
    print(f"[warm3d] FLUID-node relative L2 against the cold solve: vel "
          f"{l2_vel:.3e}, rho {l2_rho:.3e} (vel gate {WARM_L2_GATE:g})")
    print(f"[warm3d] ms per implicit step {step_ms:.3f} "
          f"({solver.total_implicit_steps} steps in "
          f"{solver.implicit_seconds:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB; wall {wall:.2f} s")
    print(f"[warm3d] launches {json.dumps(counts)}")
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            solver.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            solver.step_graph["replays"] > 0,
        "the coarse solve converged": c_conv == "True",
        "the fine solve converged": bool(conv),
        "fewer fine iterations than the cold solve's": iters < cold_iters,
        f"vel within {WARM_L2_GATE:g} of the cold solve": l2_vel <= WARM_L2_GATE,
        "ns3d launched on both grids": warm_launches["ns3d"] > 0
            and fine_launches["ns3d"] > 0,
        "every kernel of the 3D path launched":
            all(counts[k] > 0 for k in PATH_3D),
        "20 rows, all finite": len(rows) == 20 and all(
            np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "the solver kept the coarse iterations apart":
            solver.coarse_iters == int(c_iters)
            and solver.flow_results[0][0] == iters,
    }
    for what, ok in checks.items():
        print(f"[warm3d] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("warm3d checks")
    return counts


def phase_explicit3d(tmp):
    """Phase 9: 3D explicit transport; returns the launch counts of the
    full-size run."""
    from pd_mg_pin_corrosion_tpu_torch import coupling, kernels

    out_dir = os.path.join(tmp, "explicit3d")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    chunks = []
    t0 = time.time()
    with recording(coupling, "explicit_chunk", chunks):
        solver, rows = run_cli(out_dir, [FLAGSHIP, *EXPLICIT3D_CAPS,
                                         "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("Warm start", "Flow:", "Corrosion dt",
                                       "Phase change", "WARNING", "[Timer]")):
                print(f"[explicit3d] log: {line.rstrip()}")
    st = solver.final_state
    steps = solver.explicit_steps
    chunk_ms = 1e3 * sum(c[2] for c in chunks) / max(steps, 1)
    print(f"[explicit3d] params_3d.cfg {' '.join(EXPLICIT3D_CAPS)}: "
          f"{solver.cycles} cycle(s), {steps} explicit steps in "
          f"{len(chunks)} chunk(s), {chunk_ms:.4f} ms per step (BCs and "
          f"transport, host clock to the device's end), "
          f"{1e3 * solver.explicit_seconds / max(steps, 1):.4f} ms with the "
          f"VTI and the diagnostics row; flow solves {solver.flow_results}; "
          f"peak device memory {peak / 2**30:.2f} GiB; wall {wall:.2f} s")
    print(f"[explicit3d] launches {json.dumps(counts)}")
    last = rows[-1]
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "at least 100 explicit steps in one chunk":
            steps >= 100 and len(chunks) == 1
            and solver.total_implicit_steps == 0,
        "no kernel of the 2D step launched": counts["ard2d"] == 0,
        "the flow ran on ns3d": counts["ns3d"] > 0,
        "a row at T_final, all finite":
            float(last["time_s"]) >= EXPLICIT3D_T_FINAL * (1 - 1e-6) and all(
                np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
    }
    for what, ok in checks.items():
        print(f"[explicit3d] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("explicit3d checks")

    # a window of explicit steps on the run's final state, timed and
    # profiled (scripts/profile_torch_3d.py's window)
    prof = load_script(PROFILE)
    (_, kit, dt, vol, _), *_ = chunks[0]
    n = EXPLICIT3D_PROFILE_STEPS
    with open(os.path.join(out_dir, "profile.txt"), "w") as out:
        prof.window("explicit3d", lambda: coupling.explicit_chunk(
            st, kit, dt, vol, n), n, out)
    del kit, chunks, st, solver

    # the small grid, CUDA against the CPU path: the mass loss over its 99
    # initially solid nodes keeps only the last bits of the f32 sum
    n0 = 99
    run_cuda_and_cpu(tmp, "explicit3d", "small3d_explicit",
                     [FLAGSHIP, *SMALL_EXPLICIT_CAPS],
                     4 * 100.0 * float(np.spacing(np.float32(n0))) / n0)
    return counts


def phase_subcell3d(tmp):
    """Phase 10: the sub-cell 3D wall mirror."""
    import pd_mg_pin_corrosion_tpu_torch as pkg

    run_cuda_and_cpu(tmp, "subcell3d", "small3d_subcell",
                     [FLAGSHIP, *SMALL_SUBCELL_CAPS])
    cfg = pkg.Config.load(FLAGSHIP)
    cfg.apply_overrides(["wall_mirror_subcell=1"])
    grid = pkg.build_grid(cfg)
    t0 = time.time()
    kit = pkg.build_kit(grid, cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    xs = kit.shape[1] * kit.shape[2]
    dst, w = kit.mirror_sub_dst, kit.mirror_sub_w
    cols, first = np.unique((dst % xs).cpu().numpy(), return_index=True)
    terms = (w[:, torch.as_tensor(first, device=w.device)] > 0).sum(0)
    weighted = int((terms > 1).sum())
    sums = w.double().sum(0)
    print(f"[subcell3d] params_3d.cfg wall_mirror_subcell=1 at full size: "
          f"kit built in {build_s:.2f} s; {cols.size} primary columns, "
          f"{weighted} of them with more than one weight; {dst.numel()} "
          f"wall nodes mirrored bilinearly, weights summing to "
          f"{float(sums.min()):.6f}-{float(sums.max()):.6f}")
    if not (cols.size > 0 and weighted > 0.5 * cols.size
            and float((sums - 1.0).abs().max()) < 1e-3):
        fail("subcell3d: the flagship's sub-cell mirror terms")


def phase_ladder():
    """Phase 4: scripts/exp_ns3d_chunked_torch.py's ladder on the flagship
    grid; returns its launch counts."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    script = load_script(LADDER)
    torch.cuda.empty_cache()
    kit, state, dt = script.build(4.0e-6)
    kernels.reset_launch_counts()
    t0 = time.time()
    base, times, errs = script.ladder(kit, state, dt,
                                      log=lambda s: print(f"[ladder] {s}"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"[ladder] {len(times)} of {len(script.LADDER)} rungs within the "
          f"gate and timed in {time.time() - t0:.2f} s; production ns3d "
          f"{base:.4f} ms; launches {json.dumps(counts)}")
    checks = {
        "every rung within the gate (rel 1e-4) and timed":
            len(times) == len(errs) == len(script.LADDER),
        "every kernel of the ladder launched":
            all(counts[k] > 0 for k in PATH_LADDER),
    }
    for what, ok in checks.items():
        print(f"[ladder] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("ladder checks")
    return counts


def phase_explicit(tmp):
    """Phase 6: the 2D explicit-transport path; returns its launch
    counts."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.coupling import (explicit_chunk,
                                                        volume_loss_fraction)
    from pd_mg_pin_corrosion_tpu_torch.ops import ard as ard_ops

    out_dir = os.path.join(tmp, "explicit")
    kernels.reset_launch_counts()
    t0 = time.time()
    solver, rows = run_cli(out_dir, [FINE, *EXPLICIT_CAPS, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("Flow:", "Corrosion dt", "Phase change",
                                       "WARNING", "[Timer]")):
                print(f"[explicit] log: {line.rstrip()}")
    st = solver.final_state
    steps = solver.explicit_steps
    step_ms = 1e3 * solver.explicit_seconds / max(steps, 1)
    print(f"[explicit] params_fine_calibration.cfg {' '.join(EXPLICIT_CAPS)}: "
          f"{solver.cycles} cycles, {steps} explicit steps in "
          f"{solver.explicit_seconds:.3f} s ({step_ms:.4f} ms per step, VTI "
          f"and diagnostics rows included), {solver.flow_solve_count} flow "
          f"solves {solver.flow_results}, {solver.total_dissolved} dissolved, "
          f"wall {wall:.2f} s")
    print(f"[explicit] launches {json.dumps(counts)}")
    last = rows[-1]
    print(f"[explicit] last row: t={last['time_s']:.6e} s loss="
          f"{last['pin_mass_loss_pct']:.6e} % solid={int(last['solid_nodes'])} "
          f"v_max={last['v_max']:.6e} C_max_fluid={last['C_max_fluid']:.6e}")
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "at least one whole cycle of explicit steps":
            steps >= 1000 and solver.total_implicit_steps == 0,
        "ard2d launched once per explicit step": counts["ard2d"] == steps,
        "every kernel of the explicit path launched":
            all(counts[k] > 0 for k in PATH_EXPLICIT),
        "a row per chunk of output_every_corr steps, all finite":
            len(rows) == math.ceil(steps / EXPLICIT_EVERY) and all(
                np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "the last row at T_final":
            float(last["time_s"]) >= EXPLICIT_T_FINAL * (1 - 1e-6),
        "pin_mass_loss_pct does not decrease":
            bool(np.all(np.diff(rows["pin_mass_loss_pct"]) >= 0.0)),
        "all state tensors on cuda": all(t.is_cuda for t in st.tensors()),
    }
    for what, ok in checks.items():
        print(f"[explicit] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("explicit path checks")

    # a window of explicit steps on the run's final state, timed and
    # profiled (scripts/profile_torch_3d.py's window)
    prof = load_script(PROFILE)
    import pd_mg_pin_corrosion_tpu_torch as pkg
    cfg = pkg.Config.load(FINE)
    cfg.apply_overrides(EXPLICIT_CAPS)
    kit = pkg.build_kit(pkg.build_grid(cfg), cfg, device="cuda")
    dt = float(ard_ops.compute_dt(st, kit))
    vol = volume_loss_fraction(st, kit)
    n = EXPLICIT_PROFILE_STEPS
    explicit_chunk(st, kit, dt, vol, n)
    with open(os.path.join(out_dir, "profile.txt"), "w") as out:
        prof.window("explicit", lambda: explicit_chunk(st, kit, dt, vol, n),
                    n, out, show=("ard2d",))
    return counts


def rank0_slab(kit, st, ranks):
    """(kit, state, own nodes) of rank 0 of ``ranks`` on the padded grid:
    the kit ``shard_kit`` gives it, without its slab (so the single-rank ops
    run at the slab's shapes), the state's rows it holds after a halo
    exchange (OUTSIDE / 0 below the domain), and its own node count."""
    import dataclasses

    from pd_mg_pin_corrosion_tpu_torch.fields import State
    from pd_mg_pin_corrosion_tpu_torch.grid import (FICTITIOUS, FLUID, INLET,
                                                    OUTLET, OUTSIDE, SOLID_MG)
    from pd_mg_pin_corrosion_tpu_torch.parallel.sharding import (Mesh,
                                                                 shard_kit)

    sk = shard_kit(kit, Mesh(rank=0, size=ranks, group=None, backend="gloo",
                             device=kit.device))
    h, rows = sk.slab.h, sk.slab.rows

    def cut(name, t):
        fill = OUTSIDE if name == "node_type" else 0
        return torch.cat([torch.full((h,) + tuple(t.shape[1:]), fill,
                                     dtype=t.dtype, device=t.device),
                          t[:rows + h]])
    ext = State(**{k: cut(k, v) for k, v in vars(st).items()})
    return (dataclasses.replace(sk, slab=None), ext,
            rows * math.prod(kit.shape[1:]))


def seeded_state(pkg, cfg, grid, grains, device="cuda"):
    """The state of ``grid`` (uniform or block AMR) with FLUID and
    FICTITIOUS rho and vel perturbed and C seeded (SOLID near 1, FLUID up
    to 0.92: some FLUID nodes reach C_sat and salt-block their SOLID
    neighbours)."""
    return perturbed(pkg, cfg, pkg.initialize_state(grid, cfg, grains=grains,
                                                    device=device))


def perturbed(pkg, cfg, st):
    """seeded_state's perturbation of the state ``st``."""
    device = st.rho.device
    rng = np.random.default_rng(SEED)
    moving = (st.node_type == pkg.FLUID) | (st.node_type == pkg.FICTITIOUS)
    st.rho = torch.where(moving, st.rho + seeded(rng, st.rho.shape, 0.01),
                         st.rho)
    st.vel = torch.where(moving[..., None], st.vel + seeded(
        rng, st.vel.shape, 0.02 * cfg.U_in), st.vel)
    solid = st.node_type == pkg.SOLID_MG
    u = torch.tensor(rng.random(st.C.shape), dtype=torch.float32,
                     device=device)
    st.C = torch.where(solid, 1.0 - 0.2 * u, torch.where(moving, 0.92 * u,
                                                         0.0))
    return st


def kernels2d_at(pkg, kit, sb, tag, record, results, other, op,
                 ard=True):
    """ns2d, matvec2d (on the operator ``op``) and, with ``ard``, ard2d on
    the state ``sb`` of one 2D grid ``kit`` against their twins, with times,
    in-situ times (behind ``other``'s add), bounds and library calls as in
    phase ``kernels``; rows named ``name@tag`` in ``results``."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import ard as ard_ops
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    log = f"[{tag.split('_')[0]}]"
    tag = "@" + tag
    clock = torch.cuda.clock_rate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = math.prod(kit.shape)
    fluid = sb.node_type == pkg.FLUID
    solid = sb.node_type == pkg.SOLID_MG
    nt_p = kit.pad(sb.node_type, pkg.OUTSIDE)
    print(f"{log} {tag[1:]} {kit.shape} = {n} nodes, S={kit.S}: "
          f"{int(fluid.sum())} FLUID, {int(solid.sum())} SOLID, "
          f"{int((sb.node_type == pkg.FICTITIOUS).sum())} FICTITIOUS")

    # ns2d (bytes and flops as in phase kernels)
    p = ns.tait_pressure(sb.rho, kit)
    args = (sb.rho, sb.vel, p, sb.node_type, ns.compute_dt(sb, kit), kit)
    (r, v), (rp, vp) = kernels.ns2d(*args), kernels.ns2d_plain(*args)
    same = torch.equal(r, rp) and torch.equal(v, vp)
    err = max(float((r - rp).abs().max()), float((v - vp).abs().max()))
    act = bond_counts(kit, fluid, {"nt": nt_p},
                      {"act": lambda nb: nb["nt"] != pkg.OUTSIDE})["act"]
    diag = torch.tensor([ex != 0 and ey != 0 for ex, ey in kit.evec],
                        device="cuda")
    flops = float((act * torch.where(diag, 52.0, 37.0)).sum()
                  + 26 * fluid.sum())
    record("ns2d" + tag, err, same, lambda: kernels.ns2d(*args),
           lambda: kernels.ns2d_plain(*args), "bit-equal", 29 * n, flops)
    apart = apart_ms(lambda: kernels.ns2d(*args),
                     lambda: torch.add(other, other, out=other))
    results["ns2d" + tag]["apart_ms"] = apart
    issue_ms = 1e3 * flops / (128 * sms * 1e6 * clock)
    print(f"{log} ns2d{tag} in situ {apart:.4f} ms; unfused issue floor "
          f"{issue_ms:.4f} ms; bound share in situ "
          f"{100 * results['ns2d' + tag]['bound_ms'] / apart:.1f} %")

    # matvec2d on the operator
    n_unk = int(op.unknown.sum())
    x = torch.tensor(np.random.default_rng(SEED).random(kit.shape),
                     dtype=torch.float32, device="cuda")
    mv = (x, op.W, op.diag, op.unknown, kit)
    y, yp = kernels.matvec2d(*mv), kernels.matvec2d_plain(*mv)
    inside = bond_counts(kit, op.unknown, {"one": kit.pad(
        torch.ones_like(x), 0.0)}, {"in": lambda nb: nb["one"] != 0})["in"]
    A = csr_of(op.W, op.diag, op.unknown, kit)
    xf = x.reshape(-1)
    record("matvec2d" + tag, float((y - yp).abs().max()),
           torch.equal(y, yp), lambda: (kernels.matvec2d(*mv),),
           lambda: kernels.matvec2d_plain(*mv), "bit-equal",
           n_unk * kit.S * 4 + 13 * n, float(2 * inside.sum() + n_unk),
           library=lambda: torch.mv(A, xf).view(kit.shape))
    results["matvec2d" + tag]["apart_ms"] = apart_ms(
        lambda: kernels.matvec2d(*mv),
        lambda: torch.add(other, other, out=other))
    print(f"{log} matvec2d{tag} in situ "
          f"{results['matvec2d' + tag]['apart_ms']:.4f} ms; W "
          f"{tuple(op.W.shape)}")
    del A
    if not ard:
        return

    # ard2d (bytes and flops as in phase kernels)
    salt = ard_ops.compute_salt_blocked(sb, kit)
    Ds = ard_ops.solid_diffusivity(sb.is_gb, sb.is_precip, kit.cfg,
                                   ard_ops.micro_d_factor(
                                       kit.cfg, 0.05, kit.dtype, "cuda"))
    ard = (sb.C, sb.vel, ns.vel_magnitude(sb.vel), sb.node_type, Ds, salt,
           float(ard_ops.compute_dt(sb, kit)), kit)
    cn, cp = kernels.ard2d(*ard), kernels.ard2d_plain(*ard)
    jf = (pkg.FLUID, pkg.INLET, pkg.OUTLET, pkg.FICTITIOUS)
    counts = bond_counts(
        kit, fluid | solid,
        {"nt": nt_p, "salt": kit.pad(salt, False)},
        {"ll": lambda nb: fluid & sum(nb["nt"] == t for t in jf).bool(),
         "fs_open": lambda nb: fluid & (nb["nt"] == pkg.SOLID_MG)
         & ~nb["salt"],
         "fs_blocked": lambda nb: fluid & nb["salt"],
         "sf": lambda nb: solid & sum(nb["nt"] == t for t in jf).bool()})
    flops = float(17 * counts["ll"].sum() + 10 * counts["fs_open"].sum()
                  + 6 * counts["fs_blocked"].sum()
                  + 6 * counts["sf"].sum() + 4 * (fluid | solid).sum()
                  + 4 * (solid & ~salt).sum())
    print(f"{log} ard2d{tag}: {int(salt.sum())} of {int(solid.sum())} "
          f"SOLID nodes salt-blocked")
    record("ard2d" + tag, float((cn - cp).abs().max()),
           torch.equal(cn, cp), lambda: (kernels.ard2d(*ard),),
           lambda: kernels.ard2d_plain(*ard), "bit-equal", 26 * n, flops)
    results["ard2d" + tag]["apart_ms"] = apart_ms(
        lambda: kernels.ard2d(*ard),
        lambda: torch.add(other, other, out=other))
    print(f"{log} ard2d{tag} in situ "
          f"{results['ard2d' + tag]['apart_ms']:.4f} ms")


def record_basis_at(record, tag, n):
    """basis_dots (26 rows and the k = 1 self-dot) and basis_axpy on
    GMRES's pitched (26, n) basis, rows named ``name@tag``."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    rng = np.random.default_rng(SEED)
    V = kernels.pitched_basis(26, n, torch.float32, "cuda")
    V.copy_(seeded(rng, (26, n)))
    w = seeded(rng, (n,))
    c = seeded(rng, (26,), dtype=torch.float64)
    print(f"[{tag.split('_')[0]}] basis: 26 rows of {n} floats, "
          f"{V.stride(0)} apart")
    record_basis_dots(record, f"basis_dots@{tag}", V, w)
    record_basis_dots(record, f"basis_dots@{tag}_k1", w[None], w)
    record_basis_axpy(record, f"basis_axpy@{tag}", c, V, w)


def amr_kernels(pkg):
    """amr part 1: ns2d, matvec2d and ard2d on each block of
    params_amr.cfg (views of the flat state), basis_dots / basis_axpy on
    GMRES's (26, 39,920) basis, each against its twin as in phase
    ``kernels``; returns {name@shape: JSON row fields}."""
    from pd_mg_pin_corrosion_tpu_torch import amr_blocks as ab

    cfg = pkg.Config.load(AMR_CFG)
    grid = ab.build_amr_block_grid(cfg)
    bkit = ab.build_bkit(grid, cfg, device="cuda")
    st = seeded_state(pkg, cfg, grid, ab.generate_grains_b(grid, cfg))
    FLOW_KITS["amr"] = (bkit, dataclasses.replace(st))
    results = {}
    record = recorder("amr", results)
    other = torch.empty_like(st.vel)
    for block, sb in zip(("fine", "coarse"), ab._split_state(bkit, st)):
        kit = getattr(bkit, block)
        kernels2d_at(pkg, kit, sb, f"amr_{block}", record, results, other,
                     ab._block_operator(sb, kit, 0.05))
    record_basis_at(record, "amr", grid.N_total)
    return results


def phase_amr(tmp, pkg):
    """Phase amr: the kernels at the block shapes, CUDA against the CPU on
    the full-size configuration (implicit and explicit), and the
    warm-started run on the card. Returns ({name@shape: JSON row
    fields}, launches of the warm-started run, launches of the explicit
    run)."""
    from pd_mg_pin_corrosion_tpu_torch import coupling, solvers

    measured = amr_kernels(pkg)

    # part 2: full size, CUDA against the CPU
    solver, rows, imp_counts = run_cuda_and_cpu(
        tmp, "amr", "amr_implicit", [AMR_CFG, *AMR_CAPS])
    print(f"[amr] implicit capped: {solver.cycles} cycles, steps "
          f"{solver.cycle_steps}, flow solves {solver.flow_results}, "
          f"{solver.total_dissolved} dissolved; launches "
          f"{json.dumps(imp_counts)}")
    ex, ex_rows, ex_counts = run_cuda_and_cpu(
        tmp, "amr", "amr_explicit", [AMR_CFG, *AMR_EXPLICIT_CAPS])
    steps = ex.explicit_steps
    print(f"[amr] explicit: {steps} steps in {ex.explicit_seconds:.3f} s "
          f"({1e3 * ex.explicit_seconds / max(steps, 1):.4f} ms a step, "
          f"VTU and rows included); launches {json.dumps(ex_counts)}")

    # part 3: the warm-started run on the card
    out_dir = os.path.join(tmp, "amr_warm")
    coarse, fine = [], []
    from pd_mg_pin_corrosion_tpu_torch import kernels
    kernels.reset_launch_counts()
    t0 = time.time()
    with recording(solvers, "solve_steady", coarse), \
            recording(coupling, "solve_steady", fine):
        warm, warm_rows = run_cli(out_dir, [AMR_CFG, *AMR_WARM_CAPS,
                                            "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("AMR(blocks)", "Warm start", "Flow:",
                                       "WARNING", "[Timer]")):
                print(f"[amr] log: {line.rstrip()}")
    (_, (_, c_iters, c_eps, c_conv, _), c_s, c_launch) = coarse[0]
    (_, (_, f_iters, f_eps, f_conv, _), f_s, f_launch) = fine[0]
    resolves = [(r[1][1], r[2]) for r in fine[1:]]
    re_iters = sum(min(i, 200_000) for i, _ in resolves)
    re_s = sum(s for _, s in resolves)
    step_ms = 1e3 * warm.implicit_seconds / max(warm.total_implicit_steps, 1)
    print(f"[amr] warm start: coarse {c_iters} iterations (eps {c_eps:.3e}, "
          f"converged {c_conv}) in {c_s:.3f} s = "
          f"{1e3 * c_s / max(c_iters, 1):.4f} ms an iteration, ns2d "
          f"{c_launch['ns2d']}; fine {f_iters} iterations (eps {f_eps:.3e}, "
          f"converged {f_conv}) in {f_s:.3f} s = "
          f"{1e3 * f_s / max(f_iters, 1):.4f} ms an iteration, ns2d "
          f"{f_launch['ns2d']} (two blocks); JAX package's record "
          f"{AMR_WARM_ITERS[0]} / {AMR_WARM_ITERS[1]}")
    print(f"[amr] warm run to {AMR_WARM_CAPS[-1]}: {warm.cycles} cycles, "
          f"{len(resolves)} re-solves of {re_iters} iterations in "
          f"{re_s:.3f} s, {warm.total_implicit_steps} implicit steps at "
          f"{step_ms:.3f} ms a step ({warm.implicit_seconds:.3f} s), "
          f"{warm.total_dissolved} dissolved, wall {wall:.2f} s")
    banked = np.atleast_1d(np.genfromtxt(AMR_BANKED, delimiter=",",
                                         names=True))
    k = min(len(warm_rows), len(banked))
    same_t = np.allclose(warm_rows["time_s"][:k], banked["time_s"][:k],
                         rtol=1e-6)
    diffs = {c: float((np.abs(warm_rows[c][:k] - banked[c][:k])
                       / np.abs(banked[c][:k])).max())
             for c in ("pin_mass_loss_pct", "v_max", "C_max_fluid")}
    print(f"[amr] the warm run's {k} rows against the banked cold run's "
          f"first {k} (docs/runs/amr; not a gate: the banked flow started "
          f"cold): same times {same_t}, max rel diff {json.dumps(diffs)}")
    print(f"[amr] launches {json.dumps(counts)}")
    checks = {
        "the flow replayed its CUDA graph": warm.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            warm.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            warm.step_graph["replays"] > 0,
        "coarse iterations within 10 % of 49,800":
            abs(c_iters - AMR_WARM_ITERS[0]) <= AMR_WARM_GATE * AMR_WARM_ITERS[0],
        "fine iterations within 10 % of 9,300":
            abs(f_iters - AMR_WARM_ITERS[1]) <= AMR_WARM_GATE * AMR_WARM_ITERS[1],
        "both solves converged": bool(c_conv) and bool(f_conv),
        "every kernel of the AMR path launched":
            all(counts[k] > 0 for k in PATH_AMR),
        "every kernel of the AMR explicit path launched":
            all(ex_counts[k] > 0 for k in PATH_AMR_EXPLICIT),
        "ard2d twice per explicit step (a launch a block)":
            ex_counts["ard2d"] == 2 * steps and steps >= 200,
        "finite rows, loss not decreasing": all(
            np.isfinite(warm_rows[c]).all() for c in warm_rows.dtype.names)
            and bool(np.all(np.diff(warm_rows["pin_mass_loss_pct"]) >= 0.0)),
        "no GMRES non-convergence warning": warm.gmres_warnings == 0
            and solver.gmres_warnings == 0,
        "all state tensors on cuda": all(
            t.is_cuda for t in warm.final_state.tensors()),
    }
    for what, ok in checks.items():
        print(f"[amr] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("amr checks")
    return measured, counts, ex_counts


def phase_amrg(tmp):
    """Phase amrg: the gather AMR backend on params_amr.cfg at full size.
    Part 1: basis_dots (26 rows and k = 1) and basis_axpy on GMRES's
    (26, 38,976) basis against their twins. Part 2: the capped implicit
    and explicit runs and parity.cfg with implicit_extrapolate_x0 = 1, on
    CUDA against the CPU. Part 3: the gather run on the card (part 2's
    CUDA implicit run, whose launches are the phase's) against the block
    run on the card at AMR_CAPS. Returns ({name@amrg: JSON row fields},
    launches of the gather run)."""
    results = {}
    record_basis_at(recorder("amrg", results), "amrg", 38_976)

    # part 2: full size, CUDA against the CPU
    solver, rows, counts = run_cuda_and_cpu(
        tmp, "amrg", "amrg_implicit", [AMR_CFG, *GATHER, *AMR_CAPS],
        AMRG_LOSS_ATOL)
    with open(os.path.join(tmp, "amrg_implicit_cuda", "run.log")) as f:
        log = f.read().splitlines()
    for line in log:
        if any(k in line for k in ("AMR:", "Flow:", "Implicit cycle",
                                   "WARNING", "[Timer]")):
            print(f"[amrg] log: {line.rstrip()}")
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps,
                                                  1)
    print(f"[amrg] implicit capped: {solver.cycles} cycles, steps "
          f"{solver.cycle_steps}, flow solves {solver.flow_results}, "
          f"{solver.flow_iters} flow iterations in {solver.flow_seconds:.3f} "
          f"s ({1e3 * solver.flow_seconds / max(solver.flow_iters, 1):.4f} ms "
          f"an iteration), {solver.total_implicit_steps} implicit steps at "
          f"{step_ms:.3f} ms; launches {json.dumps(counts)}")
    ex, _, ex_counts = run_cuda_and_cpu(
        tmp, "amrg", "amrg_explicit", [AMR_CFG, *GATHER, *AMR_EXPLICIT_CAPS],
        AMRG_LOSS_ATOL)
    steps = ex.explicit_steps
    print(f"[amrg] explicit: {steps} steps in {ex.explicit_seconds:.3f} s "
          f"({1e3 * ex.explicit_seconds / max(steps, 1):.4f} ms a step, VTU "
          f"and rows included); launches {json.dumps(ex_counts)}")
    x0, _, _ = run_cuda_and_cpu(
        tmp, "amrg", "parity_extrapolate_x0",
        [PARITY, *PARITY_CAPS, "implicit_extrapolate_x0=1"])

    # part 3: the block run on the card; the gather run is part 2's
    block, block_rows = run_cli(os.path.join(tmp, "amrg_block"),
                                [AMR_CFG, *AMR_CAPS, "--device", "cuda"])
    same = (len(rows) == len(block_rows)
            and np.array_equal(rows["solid_nodes"], block_rows["solid_nodes"])
            and np.array_equal(rows["time_s"], block_rows["time_s"]))
    diffs = {c: float(np.abs(rows[c] / block_rows[c] - 1.0).max())
             for c in BANKED_GATES} if same else {}
    print(f"[amrg] gather against block, both on the card at AMR_CAPS: "
          f"{len(rows)} rows; solid_nodes and time_s equal: {same}; max rel "
          f"diff {json.dumps(diffs)} (gates {json.dumps(BANKED_GATES)})")
    last = rows[-1]
    print(f"[amrg] last gather row: t={last['time_s']:.1f} s loss="
          f"{last['pin_mass_loss_pct']:.6e} % solid={int(last['solid_nodes'])}"
          f" v_max={last['v_max']:.6e} C_max_fluid={last['C_max_fluid']:.6e}")
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            solver.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            solver.step_graph["replays"] > 0,
        "the run printed the JAX package's AMR line": AMRG_LINE in log,
        "both path kernels launched": all(counts[k] > 0 for k in PATH_AMRG),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0
            and x0.gmres_warnings == 0 and block.gmres_warnings == 0,
        "all state tensors on cuda": all(
            t.is_cuda for t in solver.final_state.tensors()),
        "the explicit run took its steps": steps >= 200,
        "gather within BANKED_GATES of block": bool(diffs) and all(
            diffs[c] <= g for c, g in BANKED_GATES.items()),
    }
    for what, ok in checks.items():
        print(f"[amrg] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail("amrg checks")
    return results, counts


def phase_amr3d(tmp):
    """Phase amr3d: the 7,655-node 3D block grid, CUDA against the CPU, in
    float32; returns the launch counts of the CUDA run."""
    solver, rows, counts = run_cuda_and_cpu(
        tmp, "amr3d", "amr3d", [FLAGSHIP, *AMR3D_CAPS])
    print(f"[amr3d] {solver.cycles} cycles, steps {solver.cycle_steps}, "
          f"{solver.flow_solve_count} flow solves, {solver.total_dissolved} "
          f"dissolved, {len(rows)} rows; launches {json.dumps(counts)}")
    ok = all(counts[k] > 0 for k in PATH_AMR3D)
    print(f"[amr3d] check every kernel of the 3D AMR path launched: "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("amr3d checks")
    return counts


def calib_point(tmp, tag, label, run, bank, path):
    """One ladder point, ``run(outdir)`` (its script's run_one on the card
    to CALIB_T_FINAL), its console in tmp/<tag>/run.log; holds the rows
    against the first rows of the banked run (solid_nodes and time_s
    exact, the rest within BANKED_GATES). Returns the run's launch
    counts."""
    from pd_mg_pin_corrosion_tpu_torch import kernels

    out_dir = os.path.join(tmp, tag)
    os.makedirs(out_dir, exist_ok=True)
    kernels.reset_launch_counts()
    t0 = time.time()
    with open(os.path.join(out_dir, "run.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        rows, solver = run(os.path.join(out_dir, label))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            if any(k in line for k in ("===", "Grid:", "Flow:",
                                       "Implicit cycle", "WARNING",
                                       "[Timer]")):
                print(f"[calib] {tag} log: {line.rstrip()}")
    ref = np.loadtxt(bank, delimiter=",", skiprows=1)[:len(rows)]
    same = len(ref) == len(rows)
    diffs = {}
    if same:
        for col, name in ((2, "pin_mass_loss_pct"), (4, "v_max"),
                          (5, "C_max_fluid")):
            diffs[name] = float(np.abs(rows[:, col] / ref[:, col] - 1).max())
    step_ms = 1e3 * solver.implicit_seconds / max(solver.total_implicit_steps, 1)
    rate = solver.flow_iters / max(solver.flow_seconds, 1e-9)
    print(f"[flow] {tag}: {json.dumps(solver.flow_graph)}")
    print_gmres(tag, solver)
    print(f"[calib] {tag} {label}: {len(rows)} rows, flow solves "
          f"{solver.flow_results} at {rate:.1f} iterations/s, "
          f"{solver.total_implicit_steps} implicit steps at {step_ms:.3f} ms, "
          f"wall {wall:.2f} s; launches {json.dumps(counts)}")
    print(f"[calib] {tag} vs {os.path.relpath(bank, ROOT)}, first {len(rows)} "
          f"rows: max rel diff {json.dumps(diffs)} (gates "
          f"{json.dumps(BANKED_GATES)})")
    checks = {
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the Arnoldi steps ran in CUDA graphs":
            solver.gmres_graph["replays"] > 0,
        "the implicit steps ran in CUDA graphs":
            solver.step_graph["replays"] > 0,
        "the initial flow solve converged": bool(solver.flow_results)
            and bool(solver.flow_results[0][2]),
        "20 rows, all finite": len(rows) == 20 and bool(
            np.isfinite(rows).all()),
        "solid_nodes and time_s equal to the banked run's": same
            and np.array_equal(rows[:, 3], ref[:, 3])
            and np.allclose(rows[:, 0], ref[:, 0], rtol=1e-9),
        "the banked-run gates": bool(diffs) and all(
            diffs[c] <= g for c, g in BANKED_GATES.items()),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
        "every kernel of the path launched":
            all(counts[k] > 0 for k in path),
        "all state tensors on cuda": all(
            t.is_cuda for t in solver.final_state.tensors()),
    }
    for what, ok in checks.items():
        print(f"[calib] {tag} check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail(f"calib {tag} checks")
    return counts


def phase_calib(tmp, pkg):
    """Phase calib: the path kernels at the calibration grids' shapes
    against their twins, then a capped ladder point of each calibration
    script on the card against its banked run. Returns ({name@shape: JSON
    row fields}, launches of the 3D run, launches of the 2D run)."""
    from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai

    measured = phase_kernels3d(pkg, CALIB3D_CFG, "@calib3d", "calib3d")
    torch.cuda.empty_cache()
    cfg = pkg.Config.load(CALIB2D_CFG)
    cfg.apply_overrides([f"D_grain={CALIB2D_POINT[1]}",
                         f"D_gb={CALIB2D_POINT[2]}"])
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = seeded_state(pkg, cfg, grid, pkg.grains.generate(grid, cfg))
    record = recorder("calib2d", measured)
    kernels2d_at(pkg, kit, st, "calib2d", record, measured,
                 torch.empty_like(st.vel), ai.assemble(st, kit), ard=False)
    record_basis_at(record, "calib2d", grid.N_total)
    del kit, st
    drv = load_script(CALIB3D)
    label, dx, dg, dgb, gbw, gsm, accel = CALIB3D_POINT
    counts3d = calib_point(
        tmp, "calib3d", label, lambda out: drv.run_one(
            label, dx, dg, dgb, gbw, out, gsm=gsm, accel=accel,
            t_final=CALIB_T_FINAL, device="cuda", draw="banked"),
        os.path.join(ROOT, "docs", "runs", "calib_3d", label,
                     "diagnostics.csv"), PATH_3D)
    drv2 = load_script(CALIB2D)
    label2, dg2, dgb2, dl2, al2 = CALIB2D_POINT
    counts2d = calib_point(
        tmp, "calib2d", label2, lambda out: drv2.run_one(
            label2, dg2, dgb2, dl2, out, accel_l=al2, t_final=CALIB_T_FINAL,
            device="cuda"),
        os.path.join(ROOT, "docs", "runs", "calib_2d", label2,
                     "diagnostics.csv"), PATH_2D)
    return measured, counts3d, counts2d


def phase_shard(tmp, pkg):
    """Phase shard: the flagship split over SHARD_RANKS ranks on this card.
    The path kernels at a rank's shapes against their twins (``name@shard``
    rows); one rank's reference on the padded grid; the ranks'
    (``parallel.launch.spawn`` of ``parallel.checks.coupled``): the capped
    flow solve bit for bit, the coupled cycle's rows, the checkpoint and a
    one-rank resume of it. Returns ({name@shard: JSON row fields}, the
    ranks' summed launches in the coupled run, each rank's)."""
    import shutil

    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.checkpoint import load_checkpoint
    from pd_mg_pin_corrosion_tpu_torch.coupling import CoupledSolver
    from pd_mg_pin_corrosion_tpu_torch.grid import pad_grid_axial
    from pd_mg_pin_corrosion_tpu_torch.parallel import checks
    from pd_mg_pin_corrosion_tpu_torch.parallel.launch import spawn
    from pd_mg_pin_corrosion_tpu_torch.solvers import solve_steady

    measured = phase_kernels3d(pkg, (), "@shard", "shard", slab=SHARD_RANKS)
    torch.cuda.empty_cache()

    def cfg_for(out, *extra):
        cfg = pkg.Config.load(FLAGSHIP)
        cfg.apply_overrides(SHARD_CAPS + [f"output_dir={out}", *extra])
        return cfg

    t0 = time.time()
    cfg = cfg_for(os.path.join(tmp, "shard_one"))
    grid = pad_grid_axial(pkg.build_grid(cfg), SHARD_RANKS)
    g = pkg.grains.generate(grid, cfg)
    print(f"[shard] params_3d.cfg padded to {grid.shape} = {grid.N_total} "
          f"nodes ({SHARD_RANKS} slabs of {grid.shape[0] // SHARD_RANKS} "
          f"rows), grid and grains in {time.time() - t0:.2f} s")

    # one rank on the same padded grid: the capped flow solve, then the run
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st0 = pkg.initialize_state(grid, cfg, grains=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    flow1, it1, eps1, _, _ = solve_steady(st0, kit,
                                          max_iters=SHARD_FLOW_ITERS)
    torch.cuda.synchronize()
    flow1_s = time.time() - t0
    flow1 = [t.cpu().numpy() for t in (flow1.rho, flow1.vel, flow1.pressure)]
    kernels.reset_launch_counts()
    one = CoupledSolver()
    t0 = time.time()
    with open(os.path.join(tmp, "shard_one.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        final1 = one.run(grid, st0, kit, cfg)
    torch.cuda.synchronize()
    one_wall = time.time() - t0
    counts1 = kernels.launch_counts()
    rows1 = checks.rows(f"{cfg.output_dir}/diagnostics.csv")
    del kit, st0

    # the ranks
    mesh_dir = os.path.join(tmp, "shard_mesh")
    t0 = time.time()
    with open(os.path.join(tmp, "shard_mesh.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        out = spawn(checks.coupled, SHARD_RANKS, "gloo", "cuda", grid,
                    cfg_for(mesh_dir), g, SHARD_FLOW_ITERS)
    spawn_s = time.time() - t0
    rows_m = checks.rows(f"{mesh_dir}/diagnostics.csv")
    r0 = out[0]
    flow_same = all(np.array_equal(a, b) for a, b in zip(r0["flow"], flow1))
    per_rank = [r["launches"] for r in out]
    summed = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    flow_ms = [1e3 * r["flow_seconds"] / SHARD_FLOW_ITERS for r in out]
    step_ms = [1e3 * r["implicit_seconds"] / max(r["total_implicit_steps"], 1)
               for r in out]
    one_flow_ms = 1e3 * flow1_s / SHARD_FLOW_ITERS
    one_step_ms = 1e3 * one.implicit_seconds / max(one.total_implicit_steps, 1)
    print(f"[shard] spawn of {SHARD_RANKS} ranks and their whole drive "
          f"{spawn_s:.2f} s; rank 0's coupled run {r0['wall']:.2f} s, one "
          f"rank's {one_wall:.2f} s")
    print(f"[shard] capped flow solve ({SHARD_FLOW_ITERS} iterations): ms "
          f"per iteration {json.dumps([round(v, 4) for v in flow_ms])} "
          f"(ranks) against one rank's {one_flow_ms:.4f}; flow state equal "
          f"to one rank's bit for bit: {flow_same}; eps {r0['flow_result'][1]:.6e}"
          f" (one rank {eps1:.6e})")
    print(f"[shard] implicit steps: ms per step "
          f"{json.dumps([round(v, 3) for v in step_ms])} (ranks) against one "
          f"rank's {one_step_ms:.3f}; assemble {1e3 * r0['assemble_seconds']:.2f}"
          f" ms (one rank {1e3 * one.assemble_seconds:.2f})")
    print(f"[shard] flow launches per rank "
          f"{json.dumps([r['flow_launches'] for r in out])}")
    # the mesh's traffic (parallel.sharding.TRAFFIC): the capped solve's
    # a flow iteration, and the coupled run's less its flow iterations at
    # that rate, a step
    for r in out:
        f, c = r["flow_traffic"], r["traffic"]
        steps = max(r["total_implicit_steps"], 1)
        flow_share = r["flow_iters"] / SHARD_FLOW_ITERS
        per_step = {k: (c[k] - flow_share * f[k]) / steps for k in c}
        print(f"[shard] rank {r['rank']} traffic: a flow iteration "
              f"{f['exchanges'] / SHARD_FLOW_ITERS:.2f} halo exchanges, "
              f"{f['bytes'] / SHARD_FLOW_ITERS / 1e3:.1f} kB sent, "
              f"{1e3 * f['seconds'] / SHARD_FLOW_ITERS:.4f} ms of host time "
              f"in them (staging and the wait for the neighbour included), "
              f"{f['all_reduces'] / SHARD_FLOW_ITERS:.2f} all-reduces; an "
              f"implicit step {per_step['exchanges']:.1f} exchanges, "
              f"{per_step['bytes'] / 1e6:.2f} MB sent, "
              f"{1e3 * per_step['seconds']:.2f} ms of host time in them, "
              f"{per_step['all_reduces']:.1f} all-reduces "
              f"({r['launches']['basis_dots'] / steps:.1f} basis_dots "
              f"launches, each summed by one)")
    print(f"[shard] coupled-run launches per rank {json.dumps(per_rank)}; one "
          f"rank {json.dumps(counts1)}")
    n0 = int((grid.node_type == pkg.SOLID_MG).sum())
    loss_atol = 4 * 100.0 * float(np.spacing(np.float32(n0))) / n0
    compare_rows("shard", f"{SHARD_RANKS} ranks against one rank", rows_m,
                 rows1, loss_atol)

    # the checkpoint is the single rank's file: it loads whole, equal to
    # the ranks' gathered final state, and one rank resumes it
    ck_path = f"{mesh_dir}/checkpoint.npz"
    ck, t_ck, _ = load_checkpoint(ck_path, final1)
    ck_same = all(np.array_equal(getattr(ck, k).cpu().numpy(), v)
                  for k, v in r0["final"].items())
    res_dir = os.path.join(tmp, "shard_resume")
    shutil.copytree(mesh_dir, res_dir)
    rcfg = cfg_for(res_dir, f"resume_from={res_dir}/checkpoint.npz",
                   f"T_final={SHARD_RESUME_T_FINAL}")
    kit = pkg.build_kit(grid, rcfg, device="cuda")
    st = pkg.initialize_state(grid, rcfg, grains=g, device="cuda")
    with open(os.path.join(tmp, "shard_resume.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        resumed = CoupledSolver()
        resumed.run(grid, st, kit, rcfg)
    rows_r = checks.rows(f"{res_dir}/diagnostics.csv")
    del kit, st
    print(f"[shard] checkpoint at t={t_ck:.1f} s equal to the ranks' final "
          f"state: {ck_same}; one rank resumed it to "
          f"{rows_r['time_s'][-1]:.1f} s: {len(rows_r)} rows")
    checks_ = {
        "the flow state equals one rank's bit for bit": flow_same,
        "the flow solve ran its iterations on every rank": all(
            r["flow_result"][0] == it1 for r in out),
        f"every kernel of the 3D path launched on each of the "
        f"{SHARD_RANKS} ranks": all(c[k] > 0 for c in per_rank
                                    for k in PATH_3D),
        "ns3d launched once per flow iteration on each rank": all(
            r["flow_launches"]["ns3d"] == SHARD_FLOW_ITERS for r in out),
        "five rows, all finite": len(rows_m) == 5 and all(
            np.isfinite(rows_m[c]).all() for c in rows_m.dtype.names),
        "no GMRES non-convergence warning": all(
            r["gmres_warnings"] == 0 for r in out),
        "the checkpoint loads equal to the ranks' final state": ck_same,
        "the resumed run kept the ranks' rows and added two": len(rows_r)
            == len(rows_m) + 2 and np.array_equal(rows_r[:len(rows_m)],
                                                   rows_m) and all(
            np.isfinite(rows_r[c]).all() for c in rows_r.dtype.names),
    }
    for what, ok in checks_.items():
        print(f"[shard] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks_.values()):
        fail("shard checks")
    return measured, summed, per_rank


def phase_parity(tmp):
    """Phase 11: parity.cfg with the kernels on CUDA vs the plain twins on
    the CPU, implicit, explicit and gs_parity, in float32. Every column
    within 1e-4 relative; in the explicit run the mass loss, 100 (1 - sum C
    / n0) over the n0 = 180 initially solid nodes, may instead differ by
    LOSS_ATOL: after its 151 steps it is ~1e-2 % and keeps only the last
    bits of the float32 sum, which CUDA and the CPU take in different
    orders. Then the whole gs_parity run in float64 on CUDA against the
    C++ reference binary's diagnostics.csv, byte for byte and within
    tests/test_parity.py's gates."""
    for tag, caps, loss_atol in (
            ("implicit", PARITY_CAPS, 0.0),
            ("explicit", PARITY_EXPLICIT_CAPS, LOSS_ATOL),
            ("gs", PARITY_CAPS + ["gs_parity=1"], 0.0),
            ("fused", PARITY_FUSED_CAPS, 0.0)):
        solver, _, counts = run_cuda_and_cpu(
            tmp, "parity", f"parity_{tag}", [PARITY, *caps], loss_atol)
        if tag == "fused":
            g = solver.cycle_graph
            print(f"[parity] fused cycles on CUDA: {g['launches']} graph "
                  f"launches, {g['host_reads']} host reads, {g['cycles']} "
                  f"cycles, cycle_qr launched {counts['cycle_qr']} times")
            if not (g["launches"] > 0 and g["host_reads"] == g["launches"]
                    and g["cycles"] > 1 and counts["cycle_qr"] > 0):
                fail("parity.cfg's fused cycles did not run as graph "
                     "launches with one read each")

    t0 = time.time()
    solver, ours = run_cli(os.path.join(tmp, "parity_gs_f64"),
                           [PARITY, *PARITY_GS_CAPS, "--device", "cuda"])
    wall = time.time() - t0
    ref = np.atleast_1d(np.genfromtxt(GOLDEN, delimiter=",", names=True))
    with open(GOLDEN) as f, open(os.path.join(
            tmp, "parity_gs_f64", "out", "diagnostics.csv")) as g:
        identical = f.read() == g.read()
    ok = len(ours) == len(ref) and np.array_equal(ours["solid_nodes"],
                                                  ref["solid_nodes"])
    diffs = {}
    if ok:
        diffs = {c: float((np.abs(ours[c] - ref[c]) / np.abs(ref[c])).max())
                 for c in ("time_s", "pin_mass_loss_pct", "v_max",
                           "C_max_fluid")}
    gates = {"time_s": 1e-9, "pin_mass_loss_pct": 1e-6, "v_max": 1e-6,
             "C_max_fluid": 1e-6}
    print(f"[parity] gs_parity f64 on CUDA vs the C++ reference binary "
          f"(tests/golden/parity_diagnostics_ref.csv): {len(ours)} rows, "
          f"{sum(r[0] for r in solver.flow_results)} flow iterations in "
          f"{solver.flow_seconds:.2f} s, wall {wall:.2f} s; solid_nodes "
          f"equal: {ok}; max rel diff {json.dumps(diffs)} (gates "
          f"{json.dumps(gates)}); byte-identical: {identical}")
    if not ok or not identical or any(diffs[c] > g
                                      for c, g in gates.items()):
        fail("parity.cfg gs_parity f64 on CUDA vs the reference binary")


def log_lines(out_dir, *starts):
    """The lines of out_dir/run.log that start with one of ``starts``
    (stripped), and the phase breakdown's lines."""
    found, phases = [], False
    with open(os.path.join(out_dir, "run.log")) as f:
        for line in f:
            ln = line.strip()
            if ln.startswith("[Timer] phase breakdown"):
                phases = True
            elif phases and not line.startswith("    "):
                phases = False
            if phases or ln.startswith(starts):
                found.append(ln)
    return found


def config_path(name):
    return os.path.join(CONFIG_DIR, f"{name}.cfg")


def config_checks(tag, checks):
    for what, ok in checks.items():
        print(f"[configs] {tag} check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        fail(f"configs {tag} checks")


def solid_ulps(cfg_name, caps, ulps=4):
    """``ulps`` units in the last place of a float32 sum of n0 values near
    1, as a mass loss in %, n0 the configuration's initially solid nodes
    (0 without a wire)."""
    from pd_mg_pin_corrosion_tpu_torch import build_grid
    from pd_mg_pin_corrosion_tpu_torch.config import Config

    cfg = Config.load(config_path(cfg_name))
    cfg.apply_overrides(caps)
    n0 = build_grid(cfg).type_counts()["SOLID_MG"]
    return ulps * 100.0 * float(np.spacing(np.float32(n0))) / max(n0, 1)


def config_capped(tmp, name, cfg_name, caps):
    """One configuration capped, CUDA against the CPU (run_cuda_and_cpu),
    and the checks of its path. Returns the CUDA run's launches."""
    three_d = cfg_name == "params_3d"
    tag = name.replace("@", "_")
    solver, rows, counts = run_cuda_and_cpu(
        tmp, "configs", tag, [config_path(cfg_name), *caps],
        solid_ulps(cfg_name, caps), gates=BANKED_GATES if three_d else None)
    explicit = solver.explicit_steps > 0
    path = (PATH_3D if three_d else ("ns2d", "ard2d") if explicit
            else PATH_2D)
    lines = log_lines(os.path.join(tmp, f"{tag}_cuda"),
                      "Initial solid nodes:", "Poiseuille validation",
                      "Corrosion dt", "WARNING")
    print(f"[configs] {name} capped ({' '.join(caps)}): {solver.cycles} "
          f"cycles, steps per cycle {solver.cycle_steps}, "
          f"{solver.explicit_steps} explicit steps, {solver.flow_solve_count} "
          f"flow solves, {solver.flow_iters} flow iterations, "
          f"{solver.total_dissolved} dissolved; {' | '.join(lines)}; "
          f"launches {json.dumps(counts)}")
    checks = {
        "finite rows": len(rows) > 0 and all(
            np.isfinite(rows[c]).all() for c in rows.dtype.names),
        "every kernel of the path launched":
            all(counts[k] > 0 for k in path),
        "all state tensors on cuda": all(
            t.is_cuda for t in solver.final_state.tensors()),
    }
    if cfg_name == "params_poiseuille":
        checks["no wire: one explicit step, 100 % loss of 0 solid nodes"] = (
            "Initial solid nodes: 0" in lines and solver.explicit_steps == 1
            and list(rows["pin_mass_loss_pct"]) == [100.0])
    if cfg_name == "params_transport_viz":
        checks["a phase change and a flow re-solve inside the cap"] = (
            solver.total_dissolved > 0 and solver.flow_solve_count == 2)
    if cfg_name == "params_fine":
        checks["8,200 initial solid nodes"] = (
            "Initial solid nodes: 8200" in lines)
    if three_d:
        checks["500 initial solid nodes, four cycles"] = (
            "Initial solid nodes: 500" in lines and solver.cycles == 4)
    config_checks(name, checks)
    return counts


def config_whole(tmp, name):
    """One configuration whole on the card (PD_TPU_PHASE_TIMERS=1) to its
    own T_final; prints its wall, simulated hours per wall hour, cycles,
    steps, flow iterations, phase breakdown, final row and docs/PARITY.md's
    record beside it, and checks the run. Returns its launches."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.config import Config

    cfg = Config.load(config_path(name))
    out_dir = os.path.join(tmp, f"{name}_whole")
    kernels.reset_launch_counts()
    os.environ["PD_TPU_PHASE_TIMERS"] = "1"
    try:
        t0 = time.time()
        solver, rows = run_cli(out_dir, [config_path(name), "--device",
                                         "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        del os.environ["PD_TPU_PHASE_TIMERS"]
    counts = kernels.launch_counts()
    lines = log_lines(out_dir, "Initial solid nodes:", "Poiseuille validation",
                      "Corrosion dt", "WARNING", "=== All solid",
                      "[Timer] total_simulation")
    last = rows[-1]
    explicit = solver.explicit_steps > 0
    steps = solver.explicit_steps if explicit else solver.total_implicit_steps
    print(f"[configs] {name} whole: wall {wall:.3f} s, t={last['time_s']:.6e}"
          f" s, {last['time_s'] / wall:.2f} simulated h per wall h, "
          f"{solver.cycles} cycles, {steps} {'explicit' if explicit else 'implicit'}"
          f" steps, {solver.flow_solve_count} flow solves, "
          f"{solver.flow_iters} flow iterations ({json.dumps(solver.flow_graph)}), "
          f"{solver.total_dissolved} dissolved, "
          f"{solver.gmres_warnings} GMRES warnings; launches "
          f"{json.dumps(counts)}")
    for ln in lines:
        print(f"[configs] {name} whole log: {ln}")
    print(f"[configs] {name} whole final row: t={last['time_s']:.6e} s "
          f"loss={last['pin_mass_loss_pct']:.6e} % "
          f"solid={int(last['solid_nodes'])} v_max={last['v_max']:.6e} "
          f"C_max_fluid={last['C_max_fluid']:.6e}")
    if name in RECORDS:
        rec = dict(zip(("time_s", "pin_mass_loss_pct", "solid_nodes",
                        "v_max"), RECORDS[name]))
        diffs = {c: float(abs(last[c] - r) / abs(r))
                 for c, r in rec.items() if r is not None}
        print(f"[configs] {name} whole vs docs/PARITY.md's record "
              f"{json.dumps(rec)}: rel diff {json.dumps(diffs)} (1 % is "
              f"compare_banked.py's limit; a record, not a gate)")
    path = (("ns2d", "ard2d") if explicit else PATH_2D)
    checks = {
        "reached T_final (or dissolved every solid node)":
            last["time_s"] >= cfg.T_final
            or any(ln.startswith("=== All solid") for ln in lines),
        "finite rows": all(np.isfinite(rows[c]).all()
                           for c in rows.dtype.names),
        "the flow replayed its CUDA graph": solver.flow_graph["replays"] > 0,
        "the implicit steps replayed CUDA graphs": explicit or (
            solver.gmres_graph["replays"] > 0
            and solver.step_graph["replays"] > 0),
        "every kernel of the path launched":
            all(counts[k] > 0 for k in path),
        "no GMRES non-convergence warning": solver.gmres_warnings == 0,
    }
    if name == "params_poiseuille":
        # tests/test_flow.py's gates on the steady Poiseuille flow
        err = float(next(ln for ln in lines if ln.startswith(
            "Poiseuille validation")).split("= ")[1])
        peak = 1.5 * cfg.U_in
        print(f"[configs] params_poiseuille whole: flow {solver.flow_results}"
              f", L2 rel error {err:.3e} (gate 0.05), v_max "
              f"{last['v_max']:.6e} against 1.5 U_in = {peak:.6e}: "
              f"{abs(last['v_max'] - peak) / peak:.3e} (gate 0.1)")
        checks["the flow converged"] = bool(solver.flow_results[0][2])
        checks["Poiseuille L2 relative error < 5 %"] = err < 0.05
        checks["v_max within 10 % of 1.5 U_in"] = (
            abs(last["v_max"] - peak) / peak < 0.1)
    config_checks(f"{name} whole", checks)
    return counts


def phase_configs(tmp):
    """Phase configs: CONFIGS_CAPS capped, CUDA against the CPU, then
    CONFIGS_WHOLE whole on the card. Returns {run: launches}."""
    launches = {}
    for name, (cfg_name, caps) in CONFIGS_CAPS.items():
        launches[name] = config_capped(tmp, name, cfg_name, caps)
    for name in CONFIGS_F64:
        cfg_name, caps = CONFIGS_CAPS[name]
        run_cuda_and_cpu(tmp, "configs", f"{name}_f64",
                         [config_path(cfg_name), *caps, "precision=f64"],
                         gates=GATES_F64)
    for name in CONFIGS_WHOLE:
        launches[f"{name}_whole"] = config_whole(tmp, name)
    return launches


def flow_case(pkg, name):
    """(kit, seeded state) of a FLOW_CASES flow: the one an earlier phase
    left in FLOW_KITS, or built here (``cli.build``, then
    ``perturbed``)."""
    from pd_mg_pin_corrosion_tpu_torch import cli

    if name in FLOW_KITS:
        return FLOW_KITS.pop(name)
    path, overrides, _ = FLOW_CASES[name]
    cfg = pkg.Config.load(path)
    cfg.apply_overrides(list(overrides))
    with contextlib.redirect_stdout(io.StringIO()):
        _, kit, st = cli.build(cfg, torch.device("cuda"))
    return kit, perturbed(pkg, cfg, st)


def busy_window(fn, units):
    """(device busy ms, device ops, host launch records) per unit in a
    torch.profiler window of fn() (``units`` units); busy None when the
    window holds no device record."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
             for e in ev)
    return ((us * 1e-3 / units if ev else None), len(ev) / units,
            launch_records(prof) / units)


def phase_flowgraph(pkg):
    """Phase flowgraph: each FLOW_CASES flow, FLOWGRAPH_ITERS iterations
    capped, from one seeded state on the eager route (``eager=True``) and
    on the graph route: rho, vel and C bit for bit, the same (iters, eps,
    conv, div) and launch counts, replays > 0 on the graph route. Then, on
    the solve's final state, windows of FLOWGRAPH_WINDOW iterations between
    checks by each route (eager, graph, graph, eager): ms per iteration by
    the host clock; then one profiler window of each route: host launch
    records per iteration (``launch_records``; one replay stands for the
    eager route's), device busy share and ops per iteration; the
    capture's ms and the graph pool's bytes."""
    from pd_mg_pin_corrosion_tpu_torch import kernels, solvers

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    ok = True
    for name, (*_, nodes) in FLOW_CASES.items():
        kit, st = flow_case(pkg, name)
        run = solvers.runner_for(kit)
        out = {}
        for eager in (True, False):
            kernels.reset_launch_counts()
            solvers.reset_flow_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            r = solvers.solve_steady(st, kit, max_iters=FLOWGRAPH_ITERS,
                                     eager=eager)
            torch.cuda.synchronize()
            f = solvers.FLOW_COUNTS
            out[eager] = (r, time.time() - t0, f["replays"], f["eager"],
                          kernels.launch_counts())
        (e, e_s, e_rep, e_eag, e_n), (g, g_s, g_rep, g_eag, g_n) = (
            out[True], out[False])
        same = all(torch.equal(bits(getattr(e[0], f)), bits(getattr(g[0], f)))
                   for f in ("rho", "vel", "C"))
        checks = {
            "rho, vel and C bit for bit": same,
            "the same (iters, eps, conv, div)": repr(e[1:]) == repr(g[1:]),
            "the same launch counts": e_n == g_n,
            "the graph route replayed, the eager one did not":
                g_rep > 0 and e_rep == 0 and run.graph_route,
            "every iteration ran": e_rep + e_eag == g_rep + g_eag
                == min(e[1], FLOWGRAPH_ITERS),
        }
        print(f"[flowgraph] {name} ({nodes:,} nodes, {kit.dtype}): "
              f"{FLOWGRAPH_ITERS} iterations capped -> (iters, eps, conv, "
              f"div) {e[1:]} eager / {g[1:]} graphed; eager route {e_eag} "
              f"eager iterations, {e_s:.3f} s; graph route {g_rep} replays "
              f"+ {g_eag} eager, {g_s:.3f} s (the capture included); "
              f"capture {run.capture_ms:.1f} ms, graph pool "
              f"{run.pool_bytes} B; a replay stands for launches "
              f"{json.dumps(run.launches)}")

        # windows between checks, on this solve's final state
        run.load(g[0], kit)
        n = FLOWGRAPH_WINDOW
        walls = {True: [], False: []}
        for graphed in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(n):
                run.step(kit, graphed)
            torch.cuda.synchronize()
            walls[graphed].append(1e3 * (time.time() - t0) / n)
        busy = {g: busy_window(lambda g=g: [run.step(kit, g)
                                            for _ in range(n)], n)
                for g in (False, True)}
        for graphed in (False, True):
            ms = statistics.median(walls[graphed])
            b, ops, rec = busy[graphed]
            share = "not measured" if b is None else f"{100 * b / ms:.1f} %"
            print(f"[flowgraph] {name} {'graph' if graphed else 'eager'} "
                  f"route: {ms:.4f} ms an iteration (windows "
                  f"{', '.join(f'{w:.4f}' for w in walls[graphed])}), "
                  f"{rec:.2f} host records an iteration"
                  f"{f' standing for {busy[False][2]:.2f}' if graphed else ''}"
                  f", device busy "
                  f"{'not measured' if b is None else f'{b:.4f} ms'} "
                  f"({share}), {ops:.1f} device ops an iteration")
        checks["a replay is one host record"] = busy[True][2] == 1
        for what, good in checks.items():
            print(f"[flowgraph] {name} check {what}: "
                  f"{'ok' if good else 'FAILED'}")
        ok = ok and all(checks.values())
        FLOW_KITS[name] = (kit, st)     # for gmresgraph
        FLOWED[name] = g[0]
        del kit, st, run, out, e, g
        torch.cuda.empty_cache()
    if not ok:
        fail("flowgraph checks")


def route_counts():
    """Copies of the GMRES and step counters and the launch counts."""
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    return (dict(gmres.GMRES_COUNTS), dict(gmres.STEP_COUNTS),
            kernels.launch_counts())


def reset_route_counts():
    from pd_mg_pin_corrosion_tpu_torch import kernels
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    kernels.reset_launch_counts()
    gmres.reset_gmres_counts()
    gmres.reset_step_counts()


def state_bits(st):
    """Every field of a State as integers (floats by their bits)."""
    out = []
    for t in st.tensors():
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype == torch.float64:
            t = t.view(torch.int64)
        out.append(t)
    return out


def same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_bits(a),
                                                 state_bits(b)))


def program_stats(run, keys):
    """(kernel nodes, ms of the captures, MiB of the graph pool) of a
    runner's programs ``keys``."""
    nodes = {str(k): run.graphs[k].nodes for k in keys
             if k in run.graphs}
    return nodes, run.capture_ms, run.pool_bytes / 2**20


def phase_gmresgraph(pkg):
    """Phase gmresgraph: GMRES's solve as one CUDA graph with conditional
    nodes (``gmres.implicit_step``'s ``("solve",)`` program: the restart
    cycles as a WHILE, the Arnoldi steps as nested IFs, the cycle ends as
    a SWITCH, the refinement passes as IFs, every decision gmres_qr's) on
    each FLOW_CASES grid, from its seeded state after FLOWGRAPH_ITERS flow
    iterations (flowgraph's solve, or one here) and the operator assembled
    on it: GMRESGRAPH_STEPS solves at the adaptive dt, each from the last
    one's answer, on the eager route (``eager=True``: each gate a host
    read) and on the graph route, which must agree bit for bit in C and in
    every residual, in Arnoldi steps, cycles and launch counts, with
    launches on the graph route only, one capture, and one host read a
    solve; then the operator of the phase-changed state after those
    solves, two a route, the same checks, the graph reused (recaptured
    only when a packed store outgrew its buffers). Then windows of
    GMRESGRAPH_WINDOW solves by route (graph, eager, graph): ms a solve
    by the host clock (the median window); one
    profiler window a route: host launch records and host reads a solve,
    device busy; the capture's ms, kernel nodes and graph pool."""
    from pd_mg_pin_corrosion_tpu_torch import coupling, solvers
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    def solves(state, op, kit, eager, n):
        res = []
        ops = ops_for(kit)
        for _ in range(n):
            dt = ops.compute_adaptive_dt(state, op, kit)
            state, r = gmres.implicit_step(ops.linear_system, state, op,
                                           kit, dt, eager=eager)
            res.append(r)
        return state, res

    def both_routes(state, op, kit, n):
        out = {}
        for eager in (True, False):
            reset_route_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            st_n, res = solves(state, op, kit, eager, n)
            torch.cuda.synchronize()
            out[eager] = (st_n, res, time.time() - t0, *route_counts())
        return out

    def route_checks(out, n):
        (e, e_res, _, e_g, e_s, e_n), (g, g_res, _, g_g, g_s, g_n) = (
            out[True], out[False])
        return {
            "C bit for bit": same_state(e, g),
            "the same residuals": repr(e_res) == repr(g_res),
            "the same Arnoldi steps and cycles":
                e_g["eager"] == g_g["eager"] + g_g["replays"]
                and e_g["cycles"] == g_g["cycles"],
            "the same launch counts": e_n == g_n,
            "launches on the graph route only":
                g_g["launches"] > 0 and e_g["launches"] == e_g["captures"]
                == e_g["replays"] == 0,
            "one host read a solve past the capture":
                g_s["host_reads"] == n and g_g["host_reads"] == 0,
        }

    ok = True
    for name, (*_, nodes) in FLOW_CASES.items():
        kit, st = flow_case(pkg, name)
        st = FLOWED.pop(name, None) or solvers.solve_steady(
            st, kit, max_iters=FLOWGRAPH_ITERS)[0]
        ops = ops_for(kit)
        run = gmres.runner_for(kit)
        n = GMRESGRAPH_STEPS
        op = ops.assemble(st, kit, coupling.volume_loss_fraction(st, kit))
        out = both_routes(st, op, kit, n)
        checks = {f"first operator: {k}": v
                  for k, v in route_checks(out, n).items()}
        e, e_res, e_s, e_g = out[True][:4]
        g_s, g_g = out[False][2], out[False][3]
        checks["one capture"] = run.graph_route and g_g["captures"] == 1
        print(f"[gmresgraph] {name} ({nodes:,} nodes, {kit.dtype}): {n} "
              f"solves from the seeded state after {FLOWGRAPH_ITERS} flow "
              f"iterations; eager route {e_g}, {e_s:.3f} s; graph route "
              f"{g_g}, {g_s:.3f} s (its capture included); residuals "
              f"{e_res}")
        st2, n_dis = ops.apply_phase_change(e, kit)
        op2 = ops.assemble(st2, kit, coupling.volume_loss_fraction(st2,
                                                                     kit))
        growths = run.growths
        out2 = both_routes(st2, op2, kit, 2)
        checks.update({f"second operator: {k}": v
                       for k, v in route_checks(out2, 2).items()})
        g2 = out2[False][3]
        checks["the second operator reused the graph"] = (
            g2["captures"] == g2["recaptures"] == 1 if run.growths > growths
            else g2["captures"] == 0)
        print(f"[gmresgraph] {name} second operator ({int(n_dis)} nodes "
              f"dissolved): eager {out2[True][3]}, graph {g2}; buffers "
              f"grown {run.growths - growths}")
        w = GMRESGRAPH_WINDOW
        walls = {True: [], False: []}
        arnoldi = {}
        for eager in (False, True, False):
            reset_route_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            solves(e, op, kit, eager, w)
            torch.cuda.synchronize()
            walls[eager].append(1e3 * (time.time() - t0) / w)
            c = gmres.GMRES_COUNTS
            arnoldi[eager] = (c["replays"] + c["eager"]) / w
        busy = {}
        reads = {}
        for eager in (True, False):
            reset_route_counts()
            busy[eager] = busy_window(lambda eager=eager: solves(
                e, op, kit, eager, w), w)
            reads[eager] = (gmres.GMRES_COUNTS["host_reads"]
                            + gmres.STEP_COUNTS["host_reads"]) / w
        for eager in (True, False):
            ms = statistics.median(walls[eager])
            b, dev_ops, rec = busy[eager]
            share = "not measured" if b is None else f"{100 * b / ms:.1f} %"
            print(f"[gmresgraph] {name} {'eager' if eager else 'graph'} "
                  f"route: {ms:.4f} ms a solve (windows "
                  f"{', '.join(f'{x:.4f}' for x in walls[eager])}), "
                  f"{arnoldi[eager]:.2f} Arnoldi steps a solve, {rec:.1f} "
                  f"host records and {reads[eager]:.2f} host reads a solve "
                  f"(the adaptive dt's launches included), device busy "
                  f"{'not measured' if b is None else f'{b:.4f} ms'} "
                  f"({share}), {dev_ops:.1f} device ops a solve")
        checks["the graph route takes fewer host records"] = (
            busy[False][2] < busy[True][2])
        knodes, cap_ms, pool = program_stats(run, [("solve",)])
        print(f"[gmresgraph] {name}: solve graph kernel nodes {knodes}, "
              f"captures {cap_ms:.1f} ms in all, graph pool {pool:.1f} MiB")
        for what, good in checks.items():
            print(f"[gmresgraph] {name} check {what}: "
                  f"{'ok' if good else 'FAILED'}")
        ok = ok and all(checks.values())
        FLOW_KITS[name] = (kit, st)     # for stepgraph
        FLOWED[name] = st
        del kit, st, run, out, out2, e, op, op2, st2
        torch.cuda.empty_cache()
    if not ok:
        fail("gmresgraph checks")


def phase_stepgraph(pkg):
    """Phase stepgraph: the implicit step loop as one CUDA graph with
    conditional nodes (``coupling.StepRunner.steps``: a WHILE over the
    steps around the head with the adaptive dt and the BCs, GMRES with its
    refinement, and the tail with the smoothing, the diagnostics and
    gmres_qr's exits) on each FLOW_CASES grid from the same states as
    gmresgraph: STEPGRAPH_STEPS steps of one cycle with the extrapolated
    start, one step and one read at a time (``step``) and as one chunk
    (``steps``), on the eager route and on the graph route, which must
    agree bit for bit in every field, in each step's dt, n_below,
    residual and diagnostics and in the chunk's time and max residual, in
    Arnoldi steps, cycles, steps and launch counts, with launches on the
    graph route only and one host read a step (a chunk) past the
    captures. Then, from the state after those steps with the start C,
    windows of STEPGRAPH_WINDOW steps by route (graph, chunk, eager,
    graph, chunk): ms an implicit step (the median window); one profiler
    window for single graphed steps and one for a chunk: host launch
    records (at most STEPGRAPH_RECORDS a graphed step) and host reads an
    implicit step, the device busy share; the step graphs' kernel nodes,
    capture ms and the runner's graph pool."""
    from pd_mg_pin_corrosion_tpu_torch import coupling, solvers
    from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
    from pd_mg_pin_corrosion_tpu_torch.ops import gmres

    def one_route(stepper, st, op, kit, eager, n):
        reset_route_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        stepper.begin(st, op, kit, st.C)
        rows = [stepper.step(kit, eager) for _ in range(n)]
        a = stepper.result(st)
        stepper.begin(st, op, kit, st.C)
        vals = stepper.steps(kit, n, eager)
        b = stepper.result(st)
        torch.cuda.synchronize()
        chunk = tuple(stepper.run.sc(vals, k) for k in ("T", "KK", "MAXRES"))
        return (a, rows, b, chunk, time.time() - t0, *route_counts())

    ok = True
    for name, (*_, nodes) in FLOW_CASES.items():
        kit, st = flow_case(pkg, name)
        st = FLOWED.pop(name, None) or solvers.solve_steady(
            st, kit, max_iters=FLOWGRAPH_ITERS)[0]
        ops = ops_for(kit)
        stepper = coupling.step_runner_for(kit)
        run = stepper.run
        op = ops.assemble(st, kit, coupling.volume_loss_fraction(st, kit))
        cap_ms0 = run.capture_ms
        n = STEPGRAPH_STEPS
        out = {eager: one_route(stepper, st, op, kit, eager, n)
               for eager in (True, False)}
        (e, e_rows, e_b, e_chunk, e_s, e_g, e_t, e_n) = out[True]
        (g, g_rows, g_b, g_chunk, g_s, g_g, g_t, g_n) = out[False]
        t_sum = 0.0
        for dt, *_ in e_rows:
            t_sum += dt
        checks = {
            "every field bit for bit": same_state(e, g)
                and same_state(e_b, g_b),
            "the chunk equals the steps one at a time": same_state(e, e_b)
                and e_chunk == (t_sum, float(n), e_chunk[2]),
            "the same dt, n_below, residuals and diagnostics":
                repr(e_rows) == repr(g_rows),
            "the same chunk time and max residual":
                repr(e_chunk) == repr(g_chunk),
            "the same Arnoldi steps, cycles and steps":
                e_g["eager"] == g_g["eager"] + g_g["replays"]
                and e_g["cycles"] == g_g["cycles"]
                and e_t["steps"] == g_t["steps"] == 2 * n,
            "the same launch counts": e_n == g_n,
            "launches on the graph route only":
                stepper.graph_route and g_t["launches"] > 0
                and g_g["replays"] > 0
                and e_t["launches"] == e_t["captures"] == e_g["replays"] == 0,
            "one host read a step, and one a chunk, past the captures":
                g_t["host_reads"] == n + 1 and g_g["host_reads"] == 0,
        }
        print(f"[stepgraph] {name} ({nodes:,} nodes, {kit.dtype}): {n} "
              f"implicit steps one at a time and as a chunk, extrapolated "
              f"start, from the seeded state after {FLOWGRAPH_ITERS} flow "
              f"iterations; eager route Arnoldi {e_g}, steps {e_t}, "
              f"{e_s:.3f} s; graph route Arnoldi {g_g}, steps {g_t}, "
              f"{g_s:.3f} s (captures included); (dt, n_below, residual, "
              f"diagnostics) {g_rows}; chunk (t, steps, max residual) "
              f"{g_chunk}")

        w = STEPGRAPH_WINDOW
        stepper.begin(e, op, kit)
        stepper.steps(kit, w)              # captures the start C's loop
        walls = {"eager": [], "graph": [], "chunk": []}
        arnoldi = {}
        for route in ("graph", "chunk", "eager", "graph", "chunk"):
            reset_route_counts()
            stepper.begin(e, op, kit)
            torch.cuda.synchronize()
            t0 = time.time()
            if route == "chunk":
                stepper.steps(kit, w)
            else:
                for _ in range(w):
                    stepper.step(kit, route == "eager")
            torch.cuda.synchronize()
            walls[route].append(1e3 * (time.time() - t0) / w)
            c = gmres.GMRES_COUNTS
            arnoldi[route] = (c["replays"] + c["eager"]) / w

        def window(route):
            stepper.begin(e, op, kit)
            torch.cuda.synchronize()
            reset_route_counts()
            if route == "chunk":
                b = busy_window(lambda: stepper.steps(kit, w), w)
            else:
                b = busy_window(lambda: [stepper.step(kit, route == "eager")
                                         for _ in range(w)], w)
            return (*b, (gmres.GMRES_COUNTS["host_reads"]
                         + gmres.STEP_COUNTS["host_reads"]) / w)

        busy = {route: window(route) for route in ("graph", "chunk")}
        busy["eager"] = (None, float("nan"), float("nan"), float("nan"))
        for route in walls:
            ms = statistics.median(walls[route])
            b, dev_ops, rec, reads = busy[route]
            share = "not measured" if b is None else f"{100 * b / ms:.1f} %"
            print(f"[stepgraph] {name} {route} route: {ms:.4f} ms an "
                  f"implicit step (windows "
                  f"{', '.join(f'{x:.4f}' for x in walls[route])}), "
                  f"{arnoldi[route]:.2f} Arnoldi steps an implicit step, "
                  f"{rec:.2f} host records and {reads:.2f} host reads an "
                  f"implicit step, device busy "
                  f"{'not measured' if b is None else f'{b:.4f} ms'} "
                  f"({share}), {dev_ops:.1f} device ops an implicit step")
        checks[f"a graphed step takes at most {STEPGRAPH_RECORDS} host "
               f"records and one host read"] = (
            busy["graph"][2] <= STEPGRAPH_RECORDS
            and busy["graph"][3] == 1.0)
        checks["a chunk takes one host read"] = busy["chunk"][3] == 1.0 / w
        knodes, cap_ms, pool = program_stats(
            run, [("step", True), ("step", False)])
        print(f"[stepgraph] {name}: step graphs' kernel nodes {knodes}, "
              f"captures here {cap_ms - cap_ms0:.1f} ms, graph pool "
              f"{pool:.1f} MiB (the runner's); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for what, good in checks.items():
            print(f"[stepgraph] {name} check {what}: "
                  f"{'ok' if good else 'FAILED'}")
        ok = ok and all(checks.values())
        del kit, st, run, stepper, out, e, g, e_b, g_b, op
        torch.cuda.empty_cache()
    if not ok:
        fail("stepgraph checks")


def kernel_label(line):
    """The kernel's name and template arguments (integers, bools and the
    f32 / f64 / bf16 types) from the mangled name in a ptxas line: the
    length-prefixed name after its namespace's, if it has one."""
    types = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}
    m = re.search(r"_Z(N?)(\d+)", line)
    if m is None:
        return line.strip()
    at, size = m.end(), int(m.group(2))
    if m.group(1):                  # a nested name: skip the namespace
        at += size
        n = re.match(r"\d+", line[at:])
        if n is None:
            return line.strip()
        at, size = at + n.end(), int(n.group())
    name = line[at:at + size]
    targs = re.match(r"I((?:L[bi]\d+E|13__nv_bfloat16|[fd])+)E",
                     line[at + size:])
    args = re.findall(r"L[bi](\d+)E|(13__nv_bfloat16|[fd])",
                      targs.group(1) if targs else "")
    return " ".join([name] + [v or types[t] for v, t in args])


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    phases = sys.argv[1:] or list(PHASES)
    if set(phases) - set(PHASES):
        fail(f"unknown phase(s) {sorted(set(phases) - set(PHASES))}; "
             f"phases are {', '.join(PHASES)}")
    sys.path.insert(0, ROOT)
    try:
        import pd_mg_pin_corrosion_tpu_torch as pkg
        from pd_mg_pin_corrosion_tpu_torch import grains  # noqa: F401
        from pd_mg_pin_corrosion_tpu_torch.kernels import KERNELS, build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if any(m == "jax" or m.startswith("pd_mg_pin_corrosion_tpu.")
           or m == "pd_mg_pin_corrosion_tpu" for m in sys.modules):
        fail("JAX or the JAX package was imported")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}")
    lib = build.load()
    print(f"[device] kernels {'built' if lib.built else 'loaded'} in "
          f"{lib.seconds:.2f} s: {lib.path}")
    entry = ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            entry = kernel_label(line)
        elif "registers" in line or "spill" in line:
            print(f"[ptxas] {entry}: {line.strip()}")

    measured, counts = {}, {}
    cold = shard_ranks = None

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        print(f"[device] phase {name}: {time.time() - t0:.1f} s")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ("kernels", lambda: measured.update(phase_kernels(pkg))),
                ("kernels3d", lambda: measured.update(phase_kernels3d(pkg))),
                ("ladder", phase_ladder),
                ("main", lambda: phase_main(tmp)),
                ("explicit", lambda: phase_explicit(tmp)),
                ("main3d", lambda: phase_main3d(tmp)),
                ("cycles3d", lambda: phase_cycles3d(tmp, pkg)),
                ("warm3d", lambda: phase_warm3d(tmp, cold)),
                ("explicit3d", lambda: phase_explicit3d(tmp)),
                ("subcell3d", lambda: phase_subcell3d(tmp)),
                ("amr", lambda: phase_amr(tmp, pkg)),
                ("amrg", lambda: phase_amrg(tmp)),
                ("amr3d", lambda: phase_amr3d(tmp)),
                ("calib", lambda: phase_calib(tmp, pkg)),
                ("parity", lambda: phase_parity(tmp)),
                ("shard", lambda: phase_shard(tmp, pkg)),
                ("flowgraph", lambda: phase_flowgraph(pkg)),
                ("gmresgraph", lambda: phase_gmresgraph(pkg)),
                ("stepgraph", lambda: phase_stepgraph(pkg)),
                ("configs", lambda: phase_configs(tmp))):
            if name not in phases:
                continue
            out = timed(name, run)
            if name == "main3d":
                counts[name], cold = out
            elif name == "amr":
                amr_measured, counts["amr"], counts["amr_explicit"] = out
                measured.update(amr_measured)
            elif name == "amrg":
                amrg_measured, counts["amrg"] = out
                measured.update(amrg_measured)
            elif name == "calib":
                calib_measured, counts["calib3d"], counts["calib2d"] = out
                measured.update(calib_measured)
            elif name == "shard":
                shard_measured, counts["shard"], shard_ranks = out
                measured.update(shard_measured)
            elif out is not None:
                counts[name] = out

    # each kernel's launches on the main path that runs it at the shape it
    # was timed at: the 2D one for the basis kernels, the 3D one (main3d,
    # else warm3d) for ns3d
    owner = {**{k: ("ladder",) for k in PATH_LADDER},
             **{k: ("main3d", "warm3d") for k in PATH_3D},
             **{k: ("cycles3d", "main3d") for k in ("cycle_qr", "pack3d")},
             **{k: ("main",) for k in PATH_2D},
             **{k: ("explicit",) for k in PATH_EXPLICIT}}
    # and at other shapes (name@shape), on the run at that shape: the
    # block-AMR runs (the warm-started one, the explicit one for ard2d),
    # the calibration points (calib3d, calib2d)
    rows = []
    for k in KERNELS:
        for name in sorted(m for m in measured
                           if m.split("@")[0] == k.name):
            if "@" in name:
                run = name.split("@")[1].split("_")[0]
                if run == "amr" and k.name == "ard2d":
                    run = "amr_explicit"
            else:
                run = next((p for p in owner[k.name] if p in counts), None)
            row = {"name": name, "route": "cuda", "source": k.source,
                   "replaces": k.replaces,
                   "launches": counts.get(run, {}).get(k.name),
                   **measured[name]}
            if run == "shard":
                # launches: both ranks' together; each rank's beside them
                row["launches_per_rank"] = [c[k.name] for c in shard_ranks]
            rows.append(row)
    print(f"[device] chip_smoke total {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
