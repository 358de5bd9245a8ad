"""Implicit (backward-Euler) bi-material PD transport — matrix-free GMRES.

Port of ``pd_mg_pin_corrosion_tpu/ops/ard_implicit.py`` (reference
src/pd_ard_implicit.cpp), 2D and 3D. M is never assembled as a matrix: its
action is a stencil application with per-slot weight fields W[s] and a
diagonal, built once per coupling cycle from the frozen velocity,
node types and salt mask (same bond physics, including the per-bond
M-matrix upwind clamp of pd_ard_implicit.cpp:254-288).

Numerics kept from the JAX package's CLI, which always enables x64:

* f64 runs solve to 1e-10 with GMRES(50) and two truncated-Neumann sweeps
  on the Jacobi-scaled system as the preconditioner;
* f32 runs solve to 1e-6 with GMRES(25), f64 Gram-Schmidt scalars, the
  inner tolerance floored at 1e-4, and up to two f64 iterative-refinement
  passes whose residual comes from an f64 slot sum;
* 2D f32 keeps two Neumann sweeps and the plain f64 slot sum;
* 3D f32 follows the JAX package's 3D kernel path
  (ard_implicit.py:274-364): four Neumann sweeps whose inner operator
  streams a bfloat16 copy of W, the outer operator in f32, and the
  refinement residual from the f64 slot sum of the f32 W
  (``kernels.slots3d_f64``). The same algorithm runs on every device. On
  the card all three sums stream the weights packed (each row's nonzero
  weights with a slot byte beside each, ``kernels.pack_stencil``), which
  gives the dense sums' bits, and the operator keeps no dense W once they
  are packed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import State
from ..grid import (FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG,
                    WALL)
from ..kernels import (PackedStencil, matvec2d, matvec2d_plain, matvec3d,
                       matvec3d_plain, pack_stencil, slots3d_f64)
from ..kit import Kit
from ..parallel.sharding import all_reduce, reducer
from .ard import compute_salt_blocked, micro_d_factor, solid_diffusivity
from .gmres import System


@dataclass
class ImplicitOperator:
    """Frozen PD transport operator M (one coupling cycle)."""

    # [S, *shape] off-diagonal stencil weights; None on the card's 3D
    # float32 operator, whose sums all read ``packed``
    W: torch.Tensor | None
    diag: torch.Tensor     # [*shape] diagonal of M
    unknown: torch.Tensor  # [*shape] bool — FLUID | SOLID rows
    # 3D float32: a bfloat16 copy of W that only the preconditioner
    # streams (half the bytes; a right preconditioner's accuracy moves the
    # convergence speed, never the converged answer): dense on the CPU,
    # packed on the card
    W16: torch.Tensor | PackedStencil | None = None
    # 3D float32 on the card: W's nonzero weights, packed for the matvec3d
    # and slots3d_f64 kernels (W16 shares its slot numbers and counts)
    packed: PackedStencil | None = None
    # under a mesh: the operator on the rank's extended slab, which the
    # matvecs read (``parallel.shard_kernels.assemble_sharded``); diag and
    # unknown above are then its own rows, W / W16 / packed its weights
    ext: "ImplicitOperator | None" = None


def assemble(state: State, kit: Kit, volume_loss_fraction=0.0) -> ImplicitOperator:
    """Build the per-slot weights of M (pd_ard_implicit.cpp:104-346).

    Velocity, node types, GB/precipitate flags and the salt-blocking mask
    are frozen for the cycle, exactly as the reference's once-per-cycle
    assemble. 3D float32 operators also get the weights the
    preconditioner streams in bfloat16 and, on the card, the packed forms
    of both (made after the dense pass has released its temporaries; the
    dense W goes before the bf16 copy is made, as nothing reads it).
    Under a mesh, the operator of the rank's own rows
    (``parallel.shard_kernels.assemble_sharded``)."""
    if kit.slab is not None:
        from ..parallel.shard_kernels import assemble_sharded
        return assemble_sharded(state, kit, volume_loss_fraction)
    return finish_operator(ImplicitOperator(
        *_dense_operator(state, kit, volume_loss_fraction)), kit)


def finish_operator(op: ImplicitOperator, kit: Kit) -> ImplicitOperator:
    """``op`` (dense weights) finished in place: 3D float32 operators also
    get the bf16 copy the preconditioner streams and, on the card, the
    packed forms of both (``op.W``, the dense W's only reference, is
    dropped once packed)."""
    if kit.dim == 3 and kit.dtype == torch.float32:
        if op.W.is_cuda:
            op.packed = pack_stencil(op.W, op.unknown, kit)
            op.W = None
            op.W16 = op.packed.to(torch.bfloat16)
        else:
            op.W16 = op.W.to(torch.bfloat16)
    return op


def _dense_operator(state: State, kit: Kit, volume_loss_fraction,
                    salt=None):
    """(W, diag, unknown) of M. The weights are formed over slot chunks,
    written into one [S, *shape] tensor, and the diagonal accumulates in
    stencil order, so the result does not depend on the chunking. ``salt``
    is the salt-blocking mask when the caller has formed it (a mesh
    exchanges its halo rows)."""
    cfg = kit.cfg
    nt = state.node_type
    i_fluid = nt == FLUID
    i_solid = nt == SOLID_MG
    unknown = i_fluid | i_solid

    salt_blocked = (compute_salt_blocked(state, kit) if salt is None
                    else salt)
    decay = micro_d_factor(cfg, volume_loss_fraction, kit.dtype, kit.device)

    vel_i = torch.where(i_fluid[..., None], state.vel, 0.0)
    D_s_i = solid_diffusivity(state.is_gb, state.is_precip, cfg, decay)
    pads = dict(nt=kit.pad(nt, OUTSIDE), gb=kit.pad(state.is_gb, False),
                precip=kit.pad(state.is_precip, False),
                blocked=kit.pad(salt_blocked, False))

    W = torch.empty((kit.S,) + kit.shape, dtype=kit.dtype, device=kit.device)
    diag = torch.zeros(kit.shape, dtype=kit.dtype, device=kit.device)
    for s0, s1 in kit.slot_chunks():
        def nb(key):
            return kit.neighbors(pads[key], s0=s0, s1=s1)

        ixi, ixi2, e, vol = kit.coefs(s0, s1)
        NT = nb("nt")
        valid = (NT != WALL) & (NT != OUTSIDE)
        V_j = vol * valid.to(kit.dtype)

        j_fluid = ((NT == FLUID) | (NT == INLET) | (NT == OUTLET)
                   | (NT == FICTITIOUS))
        j_solid = NT == SOLID_MG
        ll = i_fluid & j_fluid                  # liquid-liquid
        ss = i_solid & j_solid                  # skipped (pd_ard_implicit.cpp)
        iface = (i_fluid & j_solid) | (i_solid & j_fluid)

        D_s_j = solid_diffusivity(nb("gb"), nb("precip"), cfg, decay)
        solid_D = torch.where(i_solid, D_s_i, D_s_j)
        solid_blocked = torch.where(i_solid, salt_blocked, nb("blocked"))
        D_iface = torch.where(
            solid_blocked, 0.0,
            2.0 * cfg.D_liquid * solid_D / (cfg.D_liquid + solid_D + 1e-30))
        D_avg = torch.where(ll, cfg.D_liquid,
                            torch.where(iface, D_iface, 0.0))

        # diffusion weight (all bond types), pd_ard_implicit.cpp:274-276
        w_diff = kit.beta_lap * D_avg * ixi2 * V_j
        # advection + per-bond upwind stabilization on LL bonds
        # (pd_ard_implicit.cpp:279-288): w = (w_diff + max(0, w_adv - w_diff)) - w_adv
        v_dot_e = vel_i[..., 0] * e[0]
        for d in range(1, kit.dim):
            v_dot_e = v_dot_e + vel_i[..., d] * e[d]
        w_adv = (kit.alpha / kit.V_H) * v_dot_e * ixi * V_j
        w_stab = torch.clamp(w_adv - w_diff, min=0.0)
        w_ll = (w_diff + w_stab) - w_adv
        w = torch.where(ll, w_ll, w_diff)
        # rows: only unknowns; bonds: skip solid-solid
        w = torch.where(unknown & ~ss, w, 0.0)
        W[s0:s1] = w
        for s in range(s1 - s0):
            diag = diag - w[s]     # diag -= w per bond (symmetric)
    return W, diag, unknown


def matvec_M(op: ImplicitOperator, kit: Kit, x: torch.Tensor,
             W: torch.Tensor | PackedStencil | None = None) -> torch.Tensor:
    """y = M x over unknown rows (zero elsewhere): GMRES's hot op, the
    matvec2d / matvec3d kernel for float32 on the card. ``W`` replaces the
    operator's weights (the preconditioner passes ``op.W16``); by default
    they are the packed ones where the operator has them. Under a mesh, the
    matvec of the extended slab after a halo exchange of x."""
    if op.ext is not None:
        from ..parallel.shard_kernels import matvec_M_sharded
        return matvec_M_sharded(op, kit, x, W)
    f32 = x.dtype == torch.float32
    if W is None:
        W = op.packed if f32 and op.packed is not None else op.W
    if kit.dim == 2:
        step = matvec2d if f32 else matvec2d_plain
    else:
        step = matvec3d if f32 else matvec3d_plain
    return step(x, W, op.diag, op.unknown, kit)


def matvec_M64(op: ImplicitOperator, kit: Kit, x64: torch.Tensor) -> torch.Tensor:
    """M x in float64 over the float32 weights, the operator of the f32
    refinement residual (the f32 W times an f64 x is an f64 product: no f64
    copy of W, 1.5 GB at the flagship size). 2D: matvec2d's plain twin in
    float64; 3D: the f64 slot sum (``slots3d_f64``, the kernel on the card
    over the packed f32 weights), with diag and mask here."""
    if op.ext is not None:
        from ..parallel.shard_kernels import matvec_M64_sharded
        return matvec_M64_sharded(op, kit, x64)
    diag64 = op.diag.to(torch.float64)
    if kit.dim == 2:
        return matvec2d_plain(x64, op.W, diag64, op.unknown, kit)
    W = op.W if op.packed is None else op.packed
    y = diag64 * x64 + slots3d_f64(x64, W, kit)
    return torch.where(op.unknown, y, 0.0)


def linear_system(run, op: ImplicitOperator, kit: Kit,
                  restart: int = 50) -> System:
    """The step's system (I - dt M) x = C over the runner ``run``'s
    buffers (``op`` loaded into them, ``run.dt`` and ``run.inv_diag``):
    BC rows are identity with b = C (algebraically identical to the
    reference's RHS split), the result is clamped on the unknown rows only.
    float32 runs take GMRES(25) (shorter cycles keep the f32 Krylov basis
    well-conditioned) and the float64 refinement residual. Under a mesh
    GMRES's dots and the norms are summed over the ranks."""
    f32 = kit.dtype == torch.float32
    if f32 and restart == 50:
        restart = 25

    def A(x, W=None):
        return torch.where(op.unknown, x - run.dt * matvec_M(op, kit, x, W),
                           x)

    # truncated-Neumann (polynomial) preconditioner on the Jacobi-scaled
    # system: y_{n+1} = y_n + D^{-1}(x - A y_n). With a bf16 copy of W (3D
    # f32) it runs 4 sweeps over that copy: at the 1M-node flagship shape
    # the deeper sweep halves the Arnoldi steps and the bf16 stream halves
    # what each sweep costs (JAX ard_implicit.py:295-303); else 2 sweeps.
    sweeps = 2 if op.W16 is None else 4

    def jacobi(x):
        return torch.where(op.unknown, x * run.inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(sweeps):
            y = y + jacobi(x - A(y, op.W16))
        return y

    # Mixed-precision iterative refinement: the f32 residual floors near
    # eps32 * dt * ||M|| ~ 1e-4 at stiff dt, so the residual is formed with
    # the f64 operator and the correction solved in f32
    def A64(x64):
        return torch.where(op.unknown, x64 - run.dt.to(torch.float64)
                           * matvec_M64(op, kit, x64), x64)

    # the basis kernels take float32; float64 runs use the plain contractions
    return System(A=A, M=precond, A64=A64 if f32 else None,
                  rhs=lambda C: C, solved=lambda: op.unknown,
                  unknown=op.unknown, diag=op.diag, restart=restart,
                  flat_kernels=f32, allreduce=reducer(kit))


def compute_adaptive_dt(state: State, op: ImplicitOperator, kit: Kit) -> torch.Tensor:
    """Adaptive dt from per-solid time-to-threshold
    (pd_ard_implicit.cpp:438-489); a 0-d tensor of the run dtype. Under a
    mesh the least time-to-threshold is the minimum over the ranks."""
    cfg = kit.cfg
    MC = matvec_M(op, kit, state.C)

    solid = state.node_type == SOLID_MG
    eligible = solid & (state.C > cfg.C_thresh) & (MC < 0.0)
    rate = -MC
    t_phase = (state.C - cfg.C_thresh) / torch.clamp(rate, min=1e-30)
    t_phase = torch.where(eligible & (t_phase > 0.0) & (rate >= 1e-30),
                          t_phase, cfg.implicit_dt_max)
    min_t = torch.clamp(all_reduce(kit, t_phase.min(), "min"),
                        max=cfg.implicit_dt_max)
    dt = cfg.implicit_dt_fraction * min_t
    dt = torch.clamp(dt, max=cfg.implicit_dt_max)
    return torch.clamp(dt, min=cfg.implicit_dt_max * cfg.implicit_dt_min_frac)
