"""Steady-state flow solve: a host loop of eager check iterations and
replays of a captured CUDA graph of one flow iteration.

Port of ``solve_steady`` / ``_solve_steady_segment`` /
``_channel_flow_corrections`` / ``coarse_warm_start`` /
``poiseuille_l2_error`` of ``pd_mg_pin_corrosion_tpu/solvers.py``, keeping
the reference's cadence exactly (src/pd_ns.cpp:182-372): checks on the
first 10 iterations and every 100th, convergence only for iter > 100, the
velocity-blowup guard at 100x U_in, dt refresh every 200 iterations, and an
early exit that keeps the pre-step (BC-applied) buffers.

The JAX package runs the loop on the device (``_solve_steady_segment``, a
``lax.while_loop`` with its checks under ``lax.cond``). Here a
``FlowRunner`` per kit holds the state in static buffers and runs one
iteration in place (``FlowRunner.body``: the BCs, ``ns_step``, the wall BC,
the channel-flow corrections when on, the fictitious refresh, then the
outputs copied back into the buffers). A check iteration runs eagerly and
reads its six numbers in one transfer; the iterations between checks
(11-99, 101-199, ...) are replays of ``body`` captured once per kit into a
CUDA graph, or direct calls of ``body`` on the eager route: on the CPU, on
a kit with gs_parity tables (their sweeps copy to the host every call), on
a mesh's slab (halos staged through the host), or when the caller asks for
it (``eager=True``, for comparison). A replay launches what the capture
recorded, in the same order, so both routes give the same bits. The JAX
package's 2000-iteration segments existed for the TPU runtime's execution
deadline and do not change results, so there are none here.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import fields, replace

import numpy as np
import torch

from .dispatch import is_structured, ops_for
from .fields import DeviceUnavailable, State
from .grid import FLUID
from .kernels import add_launch_counts, launch_counts, no_collection
from .kit import Kit
from .ops.ns import vel_magnitude
from .parallel.sharding import all_reduce

# flow iterations of every solve in this process: graph replays, iterations
# run eagerly (check iterations, the capture's warm-up iteration, every
# iteration of the eager route) and graph captures
FLOW_COUNTS = {"replays": 0, "eager": 0, "captures": 0}


def reset_flow_counts() -> None:
    FLOW_COUNTS.update(replays=0, eager=0, captures=0)


def _channel_flow_corrections(state: State, kit: Kit) -> State:
    """Poiseuille-validation-only corrections (pd_ns.cpp:209-270): zero
    transverse velocity and cross-sectionally averaged density on FLUID
    (averaged over all non-axial array axes: per row in 2D, per z-plane in
    3D)."""
    fluid = state.node_type == FLUID
    vel = state.vel.clone()
    for d in range(kit.dim):
        if d != kit.axial_comp:
            vel[..., d] = torch.where(fluid, 0.0, state.vel[..., d])
    fl = fluid.to(kit.dtype)
    rest = tuple(range(1, kit.dim))
    rho_sum = (state.rho * fl).sum(dim=rest, keepdim=True)
    cnt = fl.sum(dim=rest, keepdim=True)
    rho_avg = torch.where(cnt > 0, rho_sum / torch.clamp(cnt, min=1.0), 0.0)
    rho = torch.where(fluid & (cnt > 0), rho_avg, state.rho)
    return replace(state, vel=vel, rho=rho)


def _pre_bcs(st: State, kit, ops) -> State:
    st = ops.apply_inlet_bc(st, kit)
    st = ops.apply_outlet_bc(st, kit)
    st = ops.apply_wall_bc(st, kit)
    return ops.apply_solid_surface_bc(st, kit)


def check_values(st_bc: State, st_new: State, kit) -> torch.Tensor:
    """(eps, v_max, rho_min, rho_max, eps < flow_conv_tol, diverged) of a
    check iteration (pd_ns.cpp:273-322) as one tensor of the run dtype on
    the device, no host read. Under a mesh the sums of eps and the
    extremes are reduced over the ranks first (the extremes exactly; eps
    rounds as the ranks' order of sums does)."""
    cfg = kit.cfg
    fluid = st_bc.node_type == FLUID
    f2 = fluid[..., None]
    dv = st_new.vel - st_bc.vel
    num = torch.where(f2, dv * dv, 0.0).sum()
    den = torch.where(f2, st_bc.vel * st_bc.vel, 0.0).sum()
    num, den = all_reduce(kit, (num, den))
    eps = torch.where(den > 1e-30,
                      torch.sqrt(num / torch.clamp(den, min=1e-300)),
                      torch.sqrt(num))
    v_max = torch.where(fluid, vel_magnitude(st_new.vel), 0.0).max()
    has_nan = (torch.where(f2, torch.isnan(st_new.vel), False).any()
               | torch.where(fluid, torch.isnan(st_new.rho), False).any())
    rho_fl = torch.where(fluid, st_new.rho, cfg.rho_f)
    v_max, has_nan, rho_max = all_reduce(
        kit, (v_max, has_nan, rho_fl.max()), "max")
    rho_min = all_reduce(kit, rho_fl.min(), "min")
    return torch.stack([eps, v_max, rho_min, rho_max,
                        (eps < cfg.flow_conv_tol).to(eps.dtype),
                        (has_nan | (v_max > 100.0 * cfg.U_in)).to(eps.dtype)])


def _check(st_bc: State, st_new: State, kit):
    """``check_values`` read in ONE transfer: (eps, v_max, rho_min,
    rho_max, converged-if-past-100, diverged) as Python numbers."""
    e, vm, rmin, rmax, conv, div = check_values(st_bc, st_new, kit).tolist()
    return e, vm, rmin, rmax, bool(conv), bool(div)


def parity_tables(kit) -> bool:
    """gs_parity tables on the kit or on one of its blocks."""
    return any(getattr(k, "gs", None) is not None
               for k in (kit, getattr(kit, "fine", None),
                         getattr(kit, "coarse", None)))


class FlowRunner:
    """One kit's flow iteration, in place on static buffers.

    ``state`` holds every State tensor of the solve under way and ``dt`` the
    flow time step (0-d), both allocated once and refreshed in place, so a
    captured graph reads and writes the same addresses on every replay.
    The kit's own tensors never change after ``build_*``, so the graph
    reads them directly. ``graph_route``: on the card, in float32, no
    gs_parity tables, no mesh slab (a float64 NS step is the plain twin,
    whose gather of the FLUID rows reads their count back from the device,
    which no capture can hold). ``launches`` are the kernel launches one
    replay stands for, added to the wrappers' counters at each replay;
    ``capture_ms`` and ``pool_bytes`` are the capture's wall time (its
    warm-up iteration included) and the growth of the reserved device
    memory across it (the graph's private pool). The kit is passed to
    every call: the runner holds no reference to it (``runner_for`` keys
    runners weakly on their kit).
    """

    def __init__(self, kit):
        self.ops = ops_for(kit)
        self.corrections = bool(kit.cfg.channel_flow_corrections
                                and is_structured(kit))
        self.graph_route = (kit.device.type == "cuda"
                            and kit.dtype == torch.float32
                            and not parity_tables(kit)
                            and getattr(kit, "slab", None) is None)
        self.state: State | None = None
        self.dt: torch.Tensor | None = None
        self.written: set = set()   # fields the iteration replaces
        self.graph = None
        self.launches: dict = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0

    def load(self, state: State, kit) -> None:
        """Copy ``state`` into the static buffers and refresh dt from it."""
        if self.state is None:
            self.state = State(*(torch.empty_like(
                t, memory_format=torch.contiguous_format)
                for t in state.tensors()))
        for buf, t in zip(self.state.tensors(), state.tensors()):
            buf.copy_(t)
        dt = self.ops.compute_dt_ns(self.state, kit)
        if self.dt is None:
            self.dt = torch.empty_like(dt)
        self.dt.copy_(dt)

    def result(self, state: State, kit) -> State:
        """The solve's state: fresh copies of the fields the iteration
        replaces, ``state``'s own tensors for the rest, the pressure from
        rho."""
        out = {f.name: (getattr(self.state, f.name).clone()
                        if f.name in self.written else getattr(state, f.name))
               for f in fields(State)}
        out["pressure"] = self.ops.tait_pressure(out["rho"], kit)
        return State(**out)

    def store(self, st: State) -> None:
        """Copy the fields of ``st`` that are not the buffers into them."""
        for f in fields(State):
            buf, t = getattr(self.state, f.name), getattr(st, f.name)
            if t is not buf:
                buf.copy_(t)
                self.written.add(f.name)

    def advance(self, kit):
        """(pre-step state with the BCs applied, the stepped state) from
        the buffers; the buffers are left as they were."""
        ops = self.ops
        st_bc = _pre_bcs(self.state, kit, ops)
        st_new = ops.ns_step(st_bc, kit, self.dt)
        # wall BC on the new buffers (pd_ns.cpp:205)
        st_new = ops.apply_wall_bc(st_new, kit)
        if self.corrections:
            st_new = _channel_flow_corrections(st_new, kit)
        return st_bc, st_new

    def body(self, kit) -> None:
        """One iteration that does not break, in place: what the graph
        captures. It refreshes the AMR fictitious nodes
        (pd_ns.cpp:325-328; nothing on a uniform grid)."""
        self.store(self.ops.update_fictitious(self.advance(kit)[1], kit))

    def step(self, kit, graphed: bool) -> None:
        """One iteration between checks: a replay of the graph (captured
        at the first one, whose warm-up runs this iteration), or ``body``
        called directly."""
        if graphed and self.graph is not None:
            self.graph.replay()
            add_launch_counts(self.launches)
            FLOW_COUNTS["replays"] += 1
            return
        if graphed:
            self.capture(kit)
        else:
            self.body(kit)
        FLOW_COUNTS["eager"] += 1

    def capture(self, kit) -> None:
        """Run ``body`` once on a side stream (the warm-up: this
        iteration), then capture it on that stream into ``graph``. Raises
        DeviceUnavailable without a card and whatever the capture raises:
        there is no fallback."""
        if not torch.cuda.is_available() or kit.device.type != "cuda":
            raise DeviceUnavailable(
                f"a CUDA graph of the flow iteration needs a card; the kit "
                f"is on {kit.device}")
        t0 = time.perf_counter()
        side = torch.cuda.Stream(kit.device)
        side.wait_stream(torch.cuda.current_stream(kit.device))
        with torch.cuda.stream(side):
            self.body(kit)
        torch.cuda.current_stream(kit.device).wait_stream(side)
        with no_collection():
            torch.cuda.synchronize(kit.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(kit.device)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side):
                    self.body(kit)
            finally:
                # the capture launched nothing: take its counts back
                after = launch_counts()
                launched = {k: n - before[k] for k, n in after.items()
                            if n != before[k]}
                add_launch_counts({k: -n for k, n in launched.items()})
        torch.cuda.synchronize(kit.device)
        self.launches = launched
        self.pool_bytes = torch.cuda.memory_reserved(kit.device) - reserved
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.graph = graph
        FLOW_COUNTS["captures"] += 1


# {kit: FlowRunner}
_runners: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def runner_for(kit) -> FlowRunner:
    """The kit's FlowRunner, made at its first solve (its buffers and
    graph live as long as the kit)."""
    run = _runners.get(kit)
    if run is None:
        run = _runners[kit] = FlowRunner(kit)
    return run


def solve_steady(state: State, kit, verbose: bool = False,
                 max_iters: int | None = None, eager: bool = False):
    """Run the flow solver to steady state, on a uniform grid's Kit, a
    block-AMR BKit or a gather-backend UKit (``dispatch.ops_for``), through
    the kit's ``FlowRunner``: the iterations between checks replay its
    CUDA graph on the graph route, or call its body directly with
    ``eager`` and off that route. Both give the same bits.

    Returns (state, iters, eps, converged, diverged) with Python scalars.
    ``iters`` is the reference's loop variable at exit (the iteration that
    broke, or flow_max_iters + 1 on exhaustion). ``verbose`` prints the
    reference's per-iteration telemetry line (pd_ns.cpp:304-306) at the
    same cadence (first 10 iterations and every output_every_flow). Every
    iteration that does not break refreshes the AMR fictitious nodes
    (pd_ns.cpp:325-328; nothing on a uniform grid). FLOW_COUNTS counts
    the iterations by route.
    """
    cfg = kit.cfg
    run = runner_for(kit)
    graphed = run.graph_route and not eager
    cap = cfg.flow_max_iters if max_iters is None else max_iters
    verbose = verbose or bool(os.environ.get("PD_TPU_VERBOSE_FLOW"))
    run.load(state, kit)
    it, eps, conv, div = 1, 1.0, False, False
    while it <= cap:
        if not (it <= 10 or it % 100 == 0):
            run.step(kit, graphed)
            it += 1
            continue
        st_bc, st_new = run.advance(kit)
        eps, v_max, rmin, rmax, eps_ok, div = _check(st_bc, st_new, kit)
        conv = eps_ok and it > 100
        FLOW_COUNTS["eager"] += 1
        if verbose and (it <= 10 or it % cfg.output_every_flow == 0):
            print(f"  Flow iter {it}: eps={eps:.3e}  v_max={v_max:.4e}  "
                  f"rho=[{rmin:.2f},{rmax:.2f}]  dt={float(run.dt):.3e}")
        if conv or div:
            # the reference breaks before swapping buffers
            run.store(st_bc)
            break
        run.store(run.ops.update_fictitious(st_new, kit))
        if it % 200 == 0:
            # dt refresh (pd_ns.cpp:331-333); 200 is a multiple of 100, so
            # it falls on a check iteration
            run.dt.copy_(run.ops.compute_dt_ns(run.state, kit))
        it += 1

    return run.result(state, kit), it, eps, conv, div


def coarse_warm_start(state: State, grid, kit, cfg):
    """Coarse-grid warm start for the INITIAL steady flow solve
    (cfg.flow_warm_start = coarsening ratio; JAX ``solvers.py:207-271``),
    on a uniform grid or a block-AMR one.

    Solves steady flow on the uniform coarse twin of the same geometry (cfg
    with dx * ratio and no AMR, on the kit's device and dtype), then samples
    its (rho, vel) trilinearly at the node positions (``grid.pos``:
    [..., dim] on a uniform grid, [N, dim] flat on a block-AMR one), in
    float64 on the host
    (``scipy.ndimage.map_coordinates``, order 1, mode "nearest", as the
    reference does), and writes them onto FLUID nodes only, with the
    pressure recomputed. The fine solve's convergence gate is unchanged.

    Returns (state, coarse_iters); (state, 0) unchanged when the coarse
    grid has no SOLID_MG node or the coarse solve diverged.
    """
    import copy

    from scipy.ndimage import map_coordinates

    from .fields import initialize_state
    from .grid import SOLID_MG, build_grid
    from .kit import build_kit

    ratio = int(cfg.flow_warm_start)
    ccfg = copy.copy(cfg)
    ccfg.dx = cfg.dx * ratio
    ccfg.use_amr = 0
    ccfg.flow_warm_start = 0
    ccfg.compute_derived()

    cgrid = build_grid(ccfg)
    # degenerate coarse geometry (e.g. the wire thinner than dx_coarse)
    if not (cgrid.node_type == SOLID_MG).any():
        print("  Warm start skipped: no solid nodes at coarse spacing")
        return state, 0
    ckit = build_kit(cgrid, ccfg, dtype=kit.dtype, device=kit.device)
    cstate = initialize_state(cgrid, ccfg, grains=None, dtype=kit.dtype,
                              device=kit.device)

    cstate, it, eps, conv, div = solve_steady(cstate, ckit)
    if div:
        print("  Warm start skipped: coarse solve diverged")
        return state, 0
    print(f"  Warm start: coarse ({ratio}x dx, {cgrid.N_total} nodes) solve "
          f"{it} iters, eps={eps:.3e}, converged={conv}")

    # trilinear sample of the coarse fields at the fine node positions
    # (host, one-time). Coarse index space: i_d = (pos_d - origin_d) / dx_c;
    # the array layout is [z,] y, x, so the components go in reverse order
    coords = [(grid.pos[..., d] - cgrid.origin[d]) / ccfg.dx
              for d in range(grid.dim)][::-1]

    def interp(a):
        return map_coordinates(a.cpu().numpy().astype(np.float64), coords,
                               order=1, mode="nearest")

    rho_i = interp(cstate.rho)
    vel_i = np.stack([interp(cstate.vel[..., d]) for d in range(grid.dim)],
                     axis=-1)

    def to_run(a):
        return torch.as_tensor(a).to(device=kit.device, dtype=kit.dtype)

    fluid = state.node_type == FLUID
    rho = torch.where(fluid, to_run(rho_i), state.rho)
    vel = torch.where(fluid[..., None], to_run(vel_i), state.vel)
    return replace(state, rho=rho, vel=vel,
                   pressure=ops_for(kit).tait_pressure(rho, kit)), it


def poiseuille_l2_error(state: State, grid, cfg) -> float:
    """Poiseuille validation at the upstream station (pd_ns.cpp:341-368).

    2D only, matching the reference. Returns the relative L2 error, or NaN
    when no sample nodes exist.
    """
    y_check = -cfg.L_upstream / 2.0
    nt = state.node_type.cpu().numpy()
    vel = state.vel.cpu().numpy()
    py = grid.pos[..., 1]
    px = grid.pos[..., 0]

    sel = (nt == FLUID) & (np.abs(py - y_check) <= 0.6 * cfg.dx)
    r_norm = px / cfg.R_tube
    sel &= np.abs(r_norm) <= 1.0
    if not sel.any():
        return float("nan")
    v_ana = 1.5 * cfg.U_in * (1.0 - r_norm[sel] ** 2)
    v_num = vel[..., 1][sel]
    err = np.sqrt(np.sum((v_num - v_ana) ** 2) / np.maximum(np.sum(v_ana**2), 1e-30))
    return float(err)
