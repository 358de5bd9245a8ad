"""GMRES over static buffers (``ops.gmres.GmresRunner``): the restart
cycles, each decision taken by gmres_qr (its plain twin here) and each
gate read on the host, as the card's graph takes them with conditional
nodes.

Within the port, bit for bit: ``gmres`` through a runner against the
host-driven loop it replaced (kept below as the reference, with the old
host form of 1 / h) on small systems: restart boundaries, an exit at
j = 0, a happy breakdown, the NaN-residual path, a start x0, and two
solves through one runner; ``implicit_step`` of each backend through its
kit's runner against the old step over that loop (kept below too), on
parity.cfg in f32 and f64, the 8,303-node 3D grid in f32 with the card's
packed operator built on the CPU (``matvec3d_packed_plain`` walks it, so
the packed buffers' copy-in is exercised), and the block and gather grids
of tests/test_torch_flow_graph.py in f32 (the refinement correction solves
reuse the runner). Two operators through one cached runner, the second
after a phase change with a longer packed store that outgrows the
buffers, against fresh runners. The device form of 1 / h against the host
form. Against the JAX package's ``gmres`` and ``implicit_step`` on
parity.cfg f64, the gates of tests/test_torch_implicit.py.
"""

import dataclasses
import functools
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_amr_blocks import COUPLED
from test_torch_flow_graph import KITS, SMALL_3D, _bits

from pd_mg_pin_corrosion_tpu.ops import ard_implicit as j_ai
from pd_mg_pin_corrosion_tpu.ops.gmres import gmres as j_gmres
from pd_mg_pin_corrosion_tpu_torch import (Config, amr_blocks, cli,
                                           state_from_numpy, unstructured)
from pd_mg_pin_corrosion_tpu_torch.dispatch import is_block, ops_for
from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable
from pd_mg_pin_corrosion_tpu_torch.grid import FLUID, SOLID_MG
from pd_mg_pin_corrosion_tpu_torch.kernels import (basis as basis_mod,
                                                   basis_axpy,
                                                   basis_axpy_plain,
                                                   basis_dots,
                                                   basis_dots_plain,
                                                   pack_stencil,
                                                   pitched_basis)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as t_ai
from pd_mg_pin_corrosion_tpu_torch.ops import gmres as t_gmres
from pd_mg_pin_corrosion_tpu_torch.ops.gmres import implicit_step

torch.set_num_threads(2)

PARITY = KITS["parity_f64"][0]
# (configuration file, overrides) of each kit the implicit steps run on
CONFIGS = {
    "parity_f32": (PARITY, ["precision=f32"]),
    "parity_f64": (PARITY, ["precision=f64"]),
    "grid3d_f32": (os.devnull, [*SMALL_3D, "precision=f32"]),
    "blocks_f32": (os.devnull, [*COUPLED, "precision=f32"]),
    "gather_f32": (os.devnull, [*COUPLED, "amr_backend=gather",
                                "precision=f32"]),
}


# ---------------------------------------------------------------------------
# the host-driven loop the runner replaced, and the steps over it
# ---------------------------------------------------------------------------

def reference_gmres(A, b, x0, *, tol, restart, maxiter, M=None,
                    flat_kernels=False, counts=None):
    """The port's GMRES before its Arnoldi step ran over static buffers:
    a basis per call, the Hessenberg column read with ``.cpu()``, 1 / h on
    the host and multiplied in as a Python float. ``counts`` gathers its
    Arnoldi steps and cycles."""
    counts = {"steps": 0, "cycles": 0} if counts is None else counts
    if M is None:
        M = lambda v: v  # noqa: E731
    dots = basis_dots if flat_kernels else basis_dots_plain
    axpy = basis_axpy if flat_kernels else basis_axpy_plain
    shape = b.shape
    m = restart
    n_cycles = max(1, -(-maxiter // restart))
    N = b.numel()

    def snorm_t(v):
        return torch.sqrt(dots(v[None], v)[0])

    def fnorm(v):
        return float(snorm_t(v.reshape(-1)))

    b_norm = fnorm(b)
    safe_b = max(b_norm, 1e-300)
    V = pitched_basis(m + 1, N, b.dtype, b.device)

    def arnoldi_cycle(x):
        counts["cycles"] += 1
        r = (b - A(x)).reshape(-1)
        beta = fnorm(r)
        inv_beta = 1.0 / max(beta, 1e-300) if beta > 1e-30 else 0.0
        V[0] = r * inv_beta
        R = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.ones(m)
        sn = np.zeros(m)
        j = 0
        done = beta / safe_b < tol
        while j < m and not done:
            counts["steps"] += 1
            w = A(M(V[j].view(shape))).reshape(-1)
            Vj = V[:j + 1]
            c1 = dots(Vj, w)
            w = axpy(c1, Vj, w)
            c2 = dots(Vj, w)
            w = axpy(c2, Vj, w)
            h_last_t = snorm_t(w)
            host = torch.cat([c1 + c2, h_last_t[None]]).cpu().numpy()
            hcol = np.zeros(m + 1)
            hcol[:j + 2] = host
            h_last = host[j + 1]
            inv_h = 1.0 / max(h_last, 1e-300) if h_last > 1e-30 else 0.0
            V[j + 1] = w * inv_h
            c, s = t_gmres._givens(hcol, cs, sn, j)
            cs[j], sn[j] = c, s
            g_next = -s * g[j]
            g[j + 1] = g_next
            g[j] = c * g[j]
            R[:, j] = hcol
            j += 1
            done = abs(g_next) / safe_b < tol
        if j == 0:
            return x
        y = t_gmres._back_substitute(R, g, j)
        c = torch.tensor(-y, dtype=torch.float64, device=b.device)
        dx = M(axpy(c, V[:j]).view(shape))
        return x + dx

    res = fnorm(b - A(x0)) / safe_b
    x, k = x0, 0
    while k < n_cycles and res > tol:
        x_new = arnoldi_cycle(x)
        res_new = fnorm(b - A(x_new)) / safe_b
        if res_new < res:
            x = x_new
        res = res_new if math.isnan(res_new) else min(res_new, res)
        k += 1
    return x, (res, k)


def _refined(A, M, A64, b, x, res, tol, restart, flat, counts):
    """The old steps' f64 refinement: up to two correction solves."""
    b64 = b.to(torch.float64)
    b_norm = max(t_gmres.vector_norm(b64), 1e-300)
    x64 = x.to(torch.float64)
    r64 = b64 - A64(x64)
    res = t_gmres.vector_norm(r64) / b_norm
    for _ in range(2):
        if not res > tol:
            break
        tol_c = min(max(0.5 * tol / max(res, 1e-300), 1e-4), 0.5)
        e, _ = reference_gmres(A, r64.to(b.dtype), torch.zeros_like(b),
                               tol=tol_c, restart=restart,
                               maxiter=restart * 2, M=M, flat_kernels=flat,
                               counts=counts)
        x64 = x64 + e.to(torch.float64)
        r64 = b64 - A64(x64)
        res = t_gmres.vector_norm(r64) / b_norm
    return x64.to(b.dtype), res


def reference_step(state, op, kit, dt, restart=50, maxiter=200, x0=None,
                   counts=None):
    """The old implicit step of the uniform grid (``ard_implicit``) or of
    an AMR backend (``amr_blocks.idw_implicit_step``) over the old loop,
    on ``op`` itself."""
    cfg = kit.cfg
    f32 = kit.dtype == torch.float32
    tol = 1e-6 if f32 else 1e-10
    inner_tol = max(tol, 1e-4) if f32 else tol
    dt = torch.as_tensor(dt, dtype=kit.dtype, device=kit.device)
    C_old = state.C
    if hasattr(op, "fict"):
        restart = min(restart, 25) if f32 else restart
        mod = amr_blocks if is_block(kit) else unstructured
        idx = kit.fict_idx if is_block(kit) else kit.fict_nodes
        src2, w = kit.fict_src, kit.fict_w
        src = src2.reshape(-1)

        def constrain(y, x, w):
            row = x.index_select(0, idx) - (
                x.index_select(0, src).view(w.shape) * w).sum(1)
            return y.index_copy(0, idx, row.to(y.dtype))

        def A(x):
            return constrain(torch.where(
                op.unknown, x - dt * mod.matvec_M(op, kit, x), x), x, w)

        def A64(x64):
            y = torch.where(op.unknown, x64 - dt.to(torch.float64)
                            * mod._matvec_M64(op, kit, x64), x64)
            return constrain(y, x64, w.to(torch.float64))

        sweeps, W16, b = 2, None, torch.where(op.fict, 0.0, C_old)
        solved = op.unknown | op.fict
        inner = A
    else:
        if f32 and restart == 50:
            restart = 25

        def A(x, W=None):
            return torch.where(op.unknown,
                               x - dt * t_ai.matvec_M(op, kit, x, W), x)

        def A64(x64):
            return torch.where(op.unknown, x64 - dt.to(torch.float64)
                               * t_ai.matvec_M64(op, kit, x64), x64)

        sweeps, W16, b = (2 if op.W16 is None else 4), op.W16, C_old
        solved = op.unknown

        def inner(y):
            return A(y, W16) if W16 is not None else A(y)
    inv_diag = 1.0 / (1.0 - dt * op.diag)

    def jacobi(x):
        return torch.where(op.unknown, x * inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(sweeps):
            y = y + jacobi(x - inner(y))
        return y

    x0 = C_old if x0 is None else torch.where(
        op.unknown, torch.clamp(x0, 0.0, cfg.C_solid_init), C_old)
    x, (res, _) = reference_gmres(A, b, x0, tol=inner_tol, restart=restart,
                                  maxiter=maxiter, M=precond,
                                  flat_kernels=f32, counts=counts)
    if f32:
        x, res = _refined(A, precond, A64, b, x, res, tol, restart, f32,
                          counts)
    C_new = torch.where(solved, torch.clamp(x, 0.0, cfg.C_solid_init), C_old)
    return dataclasses.replace(state, C=C_new), res


# ---------------------------------------------------------------------------
# kits and states
# ---------------------------------------------------------------------------

@functools.cache
def _built(name):
    """(kit, seeded state) of a CONFIGS kit on the CPU: C developed (some
    FLUID nodes at 0.95, salt-blocking their SOLID neighbours), the
    velocity perturbed, GB and precipitate SOLID nodes drawn."""
    path, overrides = CONFIGS[name]
    cfg = Config.load(path)
    cfg.apply_overrides(overrides)
    _, kit, st = cli.build(cfg.compute_derived(), "cpu")
    return kit, _seeded(st, kit, 0)


def _seeded(st, kit, seed):
    h = {f.name: getattr(st, f.name).numpy().copy()
         for f in dataclasses.fields(st)}
    rng = np.random.default_rng(seed)
    solid, fluid = h["node_type"] == SOLID_MG, h["node_type"] == FLUID
    h["C"] = np.where(solid, 0.6 + 0.4 * rng.random(solid.shape),
                      0.05 * rng.random(solid.shape))
    h["C"][fluid & (rng.random(solid.shape) < 0.05)] = 0.95
    h["vel"] = np.where(fluid[..., None], h["vel"] + rng.normal(
        0, 0.01 * kit.cfg.U_in, h["vel"].shape), h["vel"])
    h["is_gb"] = solid & (rng.random(solid.shape) < 0.3)
    h["is_precip"] = solid & ~h["is_gb"] & (rng.random(solid.shape) < 0.2)
    return state_from_numpy(h, dtype=kit.dtype, device="cpu")


def _phase_changed(st, frac, seed):
    """The state with ``frac`` of its SOLID nodes turned FLUID (their
    solid-solid bonds become interface bonds: more nonzeros a row)."""
    rng = np.random.default_rng(seed)
    nt = st.node_type.clone()
    solid = (nt == SOLID_MG).reshape(-1).nonzero().reshape(-1)
    pick = solid[torch.as_tensor(
        rng.permutation(solid.numel())[:int(frac * solid.numel())])]
    nt.view(-1)[pick] = FLUID
    C = st.C.clone()
    C.view(-1)[pick] = 0.5
    return dataclasses.replace(st, node_type=nt, C=C)


def _operator(st, kit, packed=False):
    """The kit's operator; with ``packed`` (3D f32) the card's form built
    on the CPU: W packed, its bf16 copy packed, no dense W."""
    op = ops_for(kit).assemble(st, kit, 0.0)
    if packed:
        p = pack_stencil(op.W, op.unknown, kit)
        op = t_ai.ImplicitOperator(W=None, diag=op.diag, unknown=op.unknown,
                                   packed=p, W16=p.to(torch.bfloat16))
    return op


def _fresh(kit):
    """A new runner for ``kit`` (the cached one dropped)."""
    t_gmres._runners.pop(kit, None)
    return t_gmres.runner_for(kit)


def _same(got, ref):
    """Two (state, residual) results equal bit for bit (C, and repr of
    the residual: a NaN equals a NaN)."""
    (gs, gr), (rs, rr) = got, ref
    assert repr(gr) == repr(rr)
    assert torch.equal(_bits(gs.C), _bits(rs.C))


# (kit, dt: "adaptive" or seconds, step keywords, x0 from C: a factor)
STEPS = {
    "adaptive": ("adaptive", {}, None),
    "stiff": (60.0, {}, None),
    # GMRES(5): every solve crosses restart boundaries
    "restarts": (60.0, {"restart": 5, "maxiter": 200}, None),
    "x0": ("adaptive", {}, 1.02),
    # dt = 0: A and M are the identity; the first Arnoldi step ends it
    "identity": (0.0, {}, 0.5),
}
# the 3D grid's packed walks are slow on the CPU: two of its steps
CASES = [(k, s) for k in CONFIGS for s in STEPS
         if not (k == "grid3d_f32" and s not in ("stiff", "identity"))]


@pytest.mark.parametrize("name, step", CASES,
                         ids=[f"{k}-{s}" for k, s in CASES])
def test_step_through_the_runner_equals_the_old_step(name, step):
    """implicit_step through the kit's runner (a fresh one), bit for bit
    the old step over the host-driven loop: C, the residual, the Arnoldi
    steps and the cycles, on the eager route the CPU takes."""
    kit, st = _built(name)
    op = _operator(st, kit, packed=name == "grid3d_f32")
    dt_key, kw, x0_scale = STEPS[step]
    dt = (ops_for(kit).compute_adaptive_dt(st, op, kit)
          if dt_key == "adaptive" else dt_key)
    x0 = None if x0_scale is None else st.C * x0_scale
    run = _fresh(kit)
    assert not run.graph_route
    t_gmres.reset_gmres_counts()
    system = ops_for(kit).linear_system
    got = implicit_step(system, st, op, kit, dt, x0=x0, **kw)
    counts = dict(t_gmres.GMRES_COUNTS)
    ref_counts = {"steps": 0, "cycles": 0}
    ref = reference_step(st, op, kit, dt, x0=x0, counts=ref_counts, **kw)
    _same(got, ref)
    # the Arnoldi steps and cycles gmres_qr counted, all of them direct
    assert {k: counts[k] for k in ("replays", "eager", "launches",
                                   "captures", "recaptures", "cycles",
                                   "captured_kernels", "replayed_kernels")
            } == {"replays": 0, "eager": ref_counts["steps"], "launches": 0,
                  "captures": 0, "recaptures": 0,
                  "cycles": ref_counts["cycles"], "captured_kernels": 0,
                  "replayed_kernels": 0}
    if step == "identity" and not hasattr(op, "fict"):
        assert ref_counts["steps"] == ref_counts["cycles"]   # j = 0 exits
    if step == "restarts":
        assert ref_counts["cycles"] > 1
    if kit.dtype == torch.float32 and step == "stiff":
        # the refinement's correction solves reused the runner's basis
        assert ref_counts["cycles"] >= 2
    # the runner read the operator from its own buffers
    assert run.op is not op and run.V is not None
    # eager=True takes the same route here
    _same(implicit_step(system, st, op, kit, dt, x0=x0, eager=True, **kw),
          got)


@pytest.mark.parametrize("name", ["parity_f32", "grid3d_f32", "blocks_f32",
                                  "gather_f32"])
def test_second_operator_through_the_cached_runner(name, monkeypatch):
    """Two steps through one cached runner, the second on the operator of
    a phase-changed state (a longer packed store on the 3D grid, whose
    buffers it outgrows: no headroom here), give what fresh runners give
    and what the old step gives."""
    monkeypatch.setattr(t_gmres, "PACKED_HEADROOM", 1.0)
    kit, st = _built(name)
    packed = name == "grid3d_f32"
    st2 = _phase_changed(st, 0.3, 5)
    op1, op2 = _operator(st, kit, packed), _operator(st2, kit, packed)
    if packed:
        assert op2.packed.values.numel() > op1.packed.values.numel()
    step = functools.partial(implicit_step, ops_for(kit).linear_system)
    dt = 10.0 if packed else 60.0
    run = _fresh(kit)
    first = step(st, op1, kit, dt)
    growths = run.growths
    second = step(st2, op2, kit, dt)
    assert t_gmres.runner_for(kit) is run
    assert (run.growths > growths) == packed
    _same(first, reference_step(st, op1, kit, dt))
    _same(second, reference_step(st2, op2, kit, dt))
    _fresh(kit)
    _same(step(st2, op2, kit, dt), second)
    # the phase change reached the solve
    assert not torch.equal(first[0].C, second[0].C)


def _system(n, seed, dtype, cond=40.0):
    """(A, b, the eigenvector of A's least eigenvalue 1)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = torch.tensor(Q @ np.diag(np.linspace(1.0, cond, n)) @ Q.T,
                     dtype=dtype)
    return (A, torch.tensor(rng.normal(size=n), dtype=dtype),
            torch.tensor(Q[:, 0], dtype=dtype))


def _nan_beyond(A):
    """A whose product turns NaN once x is large: the first cycle's
    answer leaves a NaN residual."""
    def op(v):
        return A @ v + torch.where(v.abs().max() > 1.0, torch.nan, 0.0)
    return op


def _gmres_case(name, dtype):
    """(A, b, x0, gmres keywords) of a named case."""
    A, b, q = _system(64, 3, dtype)
    mv = lambda v: A @ v  # noqa: E731
    z = torch.zeros_like(b)
    if name == "restarts":
        return mv, b, z, dict(restart=6, maxiter=120, tol=1e-6)
    if name == "exit_at_j0":
        # x0 off the answer along an eigenvector of A: one step spans r
        x = torch.linalg.solve(A, b)
        return mv, b, x + 0.1 * q, dict(restart=8, maxiter=40, tol=1e-3)
    if name == "happy_breakdown":
        e = torch.zeros_like(b)
        e[5] = 1.0
        return (lambda v: 2.0 * v), e, z, dict(restart=8, maxiter=40,
                                               tol=1e-12)
    if name == "nan_residual":
        # the basis' unit vectors stay below 1, the first answer does not
        return _nan_beyond(A), 30.0 * b, z, dict(restart=4, maxiter=40,
                                                 tol=1e-8)
    if name == "x0":
        return mv, b, 0.3 * b, dict(restart=10, maxiter=100, tol=1e-6)
    raise KeyError(name)


GMRES_CASES = ["restarts", "exit_at_j0", "happy_breakdown", "nan_residual",
               "x0"]


@pytest.mark.parametrize("flat", [False, True], ids=["plain", "flat"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", GMRES_CASES)
def test_gmres_through_a_runner_equals_the_host_loop(case, dtype, flat,
                                                     monkeypatch):
    """gmres through one GmresRunner, twice (the second solve reuses its
    basis, as a refinement correction does), bit for bit the host-driven
    loop: x, the residual, the cycles and the Arnoldi steps."""
    A, b, x0, kw = _gmres_case(case, dtype)
    M = (lambda v: v * 0.9) if case == "x0" else None
    run = t_gmres.GmresRunner()
    monkeypatch.setattr(t_gmres, "GmresRunner", lambda: run)
    for _ in range(2):
        t_gmres.reset_gmres_counts()
        x, (res, k) = t_gmres.gmres(A, b, x0, M=M, flat_kernels=flat, **kw)
        counts = dict(t_gmres.GMRES_COUNTS)
        ref_counts = {"steps": 0, "cycles": 0}
        xr, (rr, kr) = reference_gmres(A, b, x0, M=M, flat_kernels=flat,
                                       counts=ref_counts, **kw)
        assert repr((res, k)) == repr((rr, kr))
        assert torch.equal(_bits(x), _bits(xr))
        assert (counts["eager"], counts["cycles"]) == (ref_counts["steps"],
                                                       ref_counts["cycles"])
    if case == "exit_at_j0":
        assert ref_counts == {"steps": 1, "cycles": 1}
    if case == "happy_breakdown":
        # h = 0 exactly: V[1] stays zero, and the step ends the solve
        assert ref_counts["steps"] == 1 and res == 0.0
        assert torch.equal(run.V[1], torch.zeros_like(run.V[1]))
    if case == "nan_residual":
        assert math.isnan(res) and k == 1
    if case == "restarts":
        assert k > 1


def test_device_inv_h_equals_the_host_form():
    """inv_norm(h), 1 / h on the device in float64, bit for bit the host's
    ``1.0 / max(h, 1e-300) if h > 1e-30 else 0.0``, and the step's f32
    product w * inv_h the same as w times the host's Python float."""
    rng = np.random.default_rng(0)
    special = [0.0, -0.0, 1e-31, 1e-30, np.nextafter(1e-30, 1.0), 1e-300,
               5e-324, 1e-10, 1.0, 3.0, 1e300, np.inf, np.nan, -1.0]
    h = np.concatenate([special, 10.0 ** rng.uniform(-40, 40, 5000),
                        rng.random(5000)])
    host = np.array([1.0 / max(v, 1e-300) if v > 1e-30 else 0.0 for v in h])
    dev = t_gmres.inv_norm(torch.tensor(h)).numpy()
    assert np.array_equal(host.view(np.int64), dev.view(np.int64))
    w = torch.tensor(rng.normal(size=257), dtype=torch.float32)
    for v in h[::97]:
        inv = 1.0 / max(v, 1e-300) if v > 1e-30 else 0.0
        a = w * inv
        b = w * t_gmres.inv_norm(torch.tensor(v)).to(torch.float32)
        assert torch.equal(_bits(a), _bits(b)), v


def test_capture_needs_a_card():
    """The graph route is the card's: recording a program with the basis
    on the CPU raises DeviceUnavailable (no solve runs on the host in its
    place), and a CPU kit's runner never takes the graph route."""
    kit, st = _built("parity_f32")
    run = t_gmres.runner_for(kit)
    assert not run.graph_route
    run.basis(4, st.C.numel(), kit.dtype, kit.device)
    fns = (lambda x: x, lambda x: x, basis_dots_plain, basis_axpy_plain)
    t_gmres.reset_gmres_counts()
    with pytest.raises(DeviceUnavailable):
        run.program(("solve",), lambda: t_gmres.cycles(run, fns),
                    graphed=True)
    assert not run.graphs and t_gmres.GMRES_COUNTS["eager"] == 0


def test_pinned_dots_scratch_is_never_freed():
    """basis_dots' scratch of a stream that graphs read keeps its address
    while it is large enough, and when a call needs more (another runner
    handed the same pooled stream) the old scratch is kept alive beside
    the new one: a graph captured before still reads it."""
    cpu, key = torch.device("cpu"), 7_654_321
    try:
        partial, ticket = basis_mod._scratch(cpu, key, 26, 8)
        basis_mod._pinned.add((cpu.index, key))
        assert basis_mod._scratch(cpu, key, 30, 8)[0] is partial
        bigger, same_ticket = basis_mod._scratch(cpu, key, 40, 8)
        assert bigger.numel() >= 40 * 8 and same_ticket is ticket
        assert any(p[0] is partial for p in basis_mod._retired)
    finally:
        basis_mod._pinned.discard((cpu.index, key))
        basis_mod._dots_scratch.pop((cpu.index, key), None)
        basis_mod._retired[:] = [p for p in basis_mod._retired
                                 if p[0] is not partial]


def test_static_operator_keeps_shared_tensors_shared():
    """The runner's copy of a packed operator shares count, slice_ptr and
    slots between the f32 and the bf16 weights, as the operator does, and
    holds them in buffers that stay put while a shorter store is loaded
    and grow (dropping the graphs) for a longer one."""
    kit, st = _built("grid3d_f32")
    op1 = _operator(st, kit, packed=True)
    op2 = _operator(_phase_changed(st, 0.3, 5), kit, packed=True)
    run = t_gmres.GmresRunner()
    s1 = run.load(op1)
    assert s1.W16.slots is s1.packed.slots and s1.W16.count is s1.packed.count
    n1 = op1.packed.values.numel()
    assert s1.packed.values.numel() == math.ceil(
        n1 * t_gmres.PACKED_HEADROOM)
    assert torch.equal(s1.packed.values[:n1], op1.packed.values)
    assert run.load(op1) is s1                 # loaded once a cycle
    run.graphs[("arnoldi", 0)] = "a graph"
    s2 = run.load(op2)
    n2 = op2.packed.values.numel()
    grew = n2 > s1.packed.values.numel()
    assert (s2.packed.values is s1.packed.values) != grew
    assert (not run.graphs) == grew and (run.growths > 0) == grew
    assert torch.equal(s2.packed.values[:n2], op2.packed.values)
    assert torch.equal(s2.W16.slots[:n2], op2.packed.slots)
    assert torch.equal(s2.diag, op2.diag) and s2.diag is s1.diag


@pytest.mark.parametrize("dt", ["adaptive", 60.0])
def test_runner_against_jax_implicit_step(dt):
    """parity.cfg f64 from the same seeded state, two steps through one
    cached runner (its dt buffer reloaded in between, the operator loaded
    once): the JAX package's implicit_step to tests/test_torch_implicit.py's
    gates."""
    from test_torch_implicit import _close, _states

    jk, js, tk, ts = _states("f64", seed=1)
    jop = j_ai.assemble(js, jk)
    top = t_ai.assemble(ts, tk)
    dts = ([float(j_ai.compute_adaptive_dt(js, jop, jk)), 60.0]
           if dt == "adaptive" else [60.0, 30.0])
    _fresh(tk)
    for d in dts:
        js2, jres = j_ai.implicit_step(js, jop, jk, d)
        ts2, tres = implicit_step(t_ai.linear_system, ts, top, tk, d)
        _close(ts2.C, js2.C, 1e-10, 1e-12)
        assert tres < 1e-10 and float(jres) < 1e-10


def test_runner_against_jax_gmres(monkeypatch):
    """f32 vectors with f64 scalars through one runner, twice: the JAX
    package's gmres to test_gmres_f32_matches_jax's gates."""
    rng = np.random.default_rng(7)
    n = 96
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A_np = (Q @ np.diag(np.linspace(1.0, 40.0, n)) @ Q.T).astype(np.float32)
    x_true = rng.normal(size=n).astype(np.float32)
    b_np = (A_np @ x_true).reshape(12, 8)
    Aj = jnp.asarray(A_np)
    x_ref, (res_ref, _) = j_gmres(
        lambda v: (Aj @ v.ravel()).reshape(v.shape), jnp.asarray(b_np),
        jnp.zeros((12, 8), jnp.float32), tol=1e-5, restart=20, maxiter=200)
    At = torch.tensor(A_np)
    run = t_gmres.GmresRunner()
    monkeypatch.setattr(t_gmres, "GmresRunner", lambda: run)
    for _ in range(2):
        x, (res, _) = t_gmres.gmres(
            lambda v: (At @ v.reshape(-1)).reshape(v.shape),
            torch.tensor(b_np), torch.zeros((12, 8)), tol=1e-5, restart=20,
            maxiter=200, flat_kernels=True)
        assert res < 1e-5 and float(res_ref) < 1e-5
        np.testing.assert_allclose(x.numpy().ravel(), x_true, rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=5e-4,
                                   atol=5e-4)
