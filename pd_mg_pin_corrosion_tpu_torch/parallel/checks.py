"""Rank functions for ``launch.spawn``: drive the sharded path and return
what a check compares, gathered on rank 0 as numpy arrays.

Each takes the rank's ``Mesh`` first. The global grid (and grains, or
the state's arrays) come from the caller, so every rank starts from the
same arrays; each rank builds the global kit and state on its device and
keeps its slab (``shard_kit``, ``shard_state``). ``batch`` runs several in
one spawn. Used by the CPU tests and ``chip_smoke.py``; the module
imports no JAX.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..fields import initialize_state, state_from_numpy
from ..kit import build_kit
from .sharding import (TRAFFIC, all_reduce, gather_rows, gather_state,
                       reset_traffic, shard_kit, shard_state)
from .shard_kernels import halo_pair


def batch(mesh, jobs):
    """[fn(mesh, *args) for (fn, args) in jobs]: several checks, one spawn."""
    return [fn(mesh, *args) for fn, args in jobs]


def kernel_launches(mesh) -> dict:
    """This rank's kernel launch counts (``kernels.launch_counts``)."""
    from .. import kernels
    return kernels.launch_counts()


def _setup(mesh, grid, cfg, grains=None, arrays=None):
    """(kit, state, sharded kit, sharded state) of the global grid: the
    initial state, or the one of ``arrays`` (State fields by name)."""
    kit = build_kit(grid, cfg, device=mesh.device)
    if arrays is None:
        state = initialize_state(grid, cfg, grains=grains, dtype=kit.dtype,
                                 device=mesh.device)
    else:
        state = state_from_numpy(arrays, dtype=kit.dtype, device=mesh.device)
    return kit, state, shard_kit(kit, mesh), shard_state(state, mesh)


def _numpy(tensors, mesh):
    """The tensors' rows from every rank as numpy arrays on rank 0."""
    whole = gather_rows(list(tensors), mesh)
    return None if whole is None else [t.cpu().numpy() for t in whole]


def halo_ends(mesh, grid, cfg) -> bool:
    """Whether ``halo_pair`` of rho gives zeros beyond the domain's ends and
    the neighbours' edge rows elsewhere, on every rank."""
    kit, state, sk, ss = _setup(mesh, grid, cfg)
    h, slab = sk.slab.h, sk.slab
    lo, hi = halo_pair(ss.rho, h, mesh)
    a, b = slab.row0 - h, slab.row0 + slab.rows
    want_lo = (torch.zeros_like(lo) if mesh.rank == 0
               else state.rho[a:slab.row0])
    want_hi = (torch.zeros_like(hi) if mesh.rank == mesh.size - 1
               else state.rho[b:b + h])
    ok = torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    return bool(all_reduce(sk, torch.tensor(float(ok)), "min"))


def ns_steps(mesh, grid, cfg, dt, wall=False, arrays=None):
    """(rho, vel) after one NS step (with ``wall``: wall BC, NS step, wall
    BC, as JAX tests/test_sharding.py's 3D step) on the mesh."""
    from ..dispatch import ops_for

    _, _, sk, ss = _setup(mesh, grid, cfg, arrays=arrays)
    ops = ops_for(sk)
    if wall:
        ss = ops.apply_wall_bc(ss, sk)
    ss = ops.ns_step(ss, sk, dt)
    if wall:
        ss = ops.apply_wall_bc(ss, sk)
    return _numpy((ss.rho, ss.vel), mesh)


def transport(mesh, grid, cfg, dt_explicit, dt_implicit, arrays=None):
    """(C after ard_step, C after assemble + implicit_step, the residual)
    on the mesh, as JAX test_sharded_ard_and_implicit."""
    from ..dispatch import ops_for
    from ..ops.gmres import implicit_step

    _, _, sk, ss = _setup(mesh, grid, cfg, arrays=arrays)
    ops = ops_for(sk)
    C_ard = ops.ard_step(ss, sk, dt_explicit).C
    op = ops.assemble(ss, sk)
    sol, res = implicit_step(ops.linear_system, ss, op, sk, dt_implicit)
    out = _numpy((C_ard, sol.C), mesh)
    return None if out is None else out + [res]


def matvecs(mesh, grid, cfg, arrays=None):
    """M x on the mesh for x = C + 0.3 v_pois: the operator's own weights
    and, in 3D, its bf16 copy and the packed f32 weights (packed on each
    rank's extended slab, as the card does)."""
    from ..kernels import pack_stencil
    from ..ops import ard_implicit as ai
    from .sharding import own_rows

    kit, state, sk, ss = _setup(mesh, grid, cfg, arrays=arrays)
    op = ai.assemble(ss, sk)
    x = ss.C + 0.3 * own_rows(sk, sk.v_pois)
    ys = [ai.matvec_M(op, sk, x)]
    if kit.dim == 3:
        ys.append(ai.matvec_M(op, sk, x, op.W16))
        if op.ext.packed is None:
            op.ext.packed = pack_stencil(op.ext.W, op.ext.unknown, sk)
            op.packed = op.ext.packed
        ys.append(ai.matvec_M(op, sk, x))
    return _numpy(ys, mesh)


def coupled(mesh, grid, cfg, grains=None, flow_iters=None):
    """A CoupledSolver run on the mesh (``cfg.output_dir``, written by rank
    0). With ``flow_iters``, first a solve_steady capped there, timed, its
    state gathered (the flow check's). Returns a dict on every rank: the
    solver's totals, times and the rank's launch counts; on rank 0 also
    the gathered final state and flow state (None elsewhere)."""
    from .. import kernels
    from ..coupling import CoupledSolver
    from ..solvers import solve_steady

    cfg = copy.deepcopy(cfg)
    _, _, sk, ss = _setup(mesh, grid, cfg, grains)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    out = {"rank": mesh.rank}
    if flow_iters:
        sync()
        kernels.reset_launch_counts()
        reset_traffic()
        t0 = time.time()
        st, it, eps, conv, div = solve_steady(ss, sk, max_iters=flow_iters)
        sync()
        out["flow_seconds"] = time.time() - t0
        out["flow_launches"] = kernels.launch_counts()
        out["flow_traffic"] = dict(TRAFFIC)
        out["flow_result"] = (it, eps, conv, div)
        out["flow"] = _numpy((st.rho, st.vel, st.pressure), mesh)
    sync()
    kernels.reset_launch_counts()
    reset_traffic()
    t0 = time.time()
    solver = CoupledSolver()
    final = solver.run(grid, ss, sk, cfg)
    sync()
    out["wall"] = time.time() - t0
    out["launches"] = kernels.launch_counts()
    out["traffic"] = dict(TRAFFIC)
    whole = gather_state(final, mesh)
    out.update(
        total_dissolved=solver.total_dissolved,
        total_implicit_steps=solver.total_implicit_steps,
        flow_solve_count=solver.flow_solve_count,
        flow_results=solver.flow_results, flow_iters=solver.flow_iters,
        flow_seconds_run=solver.flow_seconds,
        implicit_seconds=solver.implicit_seconds,
        assemble_seconds=solver.assemble_seconds,
        gmres_warnings=solver.gmres_warnings,
        final=None if whole is None else {
            k: v.cpu().numpy() for k, v in vars(whole).items()})
    return out


def rows(path) -> np.ndarray:
    """A diagnostics.csv as a structured array."""
    return np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True))
