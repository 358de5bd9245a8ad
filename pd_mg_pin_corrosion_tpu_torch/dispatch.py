"""Backend dispatch: the uniform structured grid (on one rank or a slab of
a mesh), block AMR, or the gather AMR backend.

Port of ``pd_mg_pin_corrosion_tpu/dispatch.py``. Every branch exposes the
same functions over (state, kit); the solvers and the coupling loop take
them from ``ops_for(kit)``, so one loop drives every kind of grid. A kit
that carries a slab (``parallel.sharding.shard_kit``) gets the ops that
exchange halo rows and reduce over the mesh
(``parallel.shard_kernels.sharded_ops``).
"""

from __future__ import annotations

from types import SimpleNamespace


def is_structured(kit) -> bool:
    from .kit import Kit
    return isinstance(kit, Kit)


def is_block(kit) -> bool:
    """A block-AMR kit (``amr_blocks.BKit``)."""
    from .amr_blocks import BKit
    return isinstance(kit, BKit)


def _identity(state, kit):
    return state


def ops_for(kit) -> SimpleNamespace:
    from . import boundary as bc

    if getattr(kit, "slab", None) is not None:
        from .parallel.shard_kernels import sharded_ops
        return sharded_ops()

    if is_block(kit):
        from . import amr_blocks as b

        return SimpleNamespace(
            ns_step=b.ns_step,
            compute_dt_ns=b.compute_dt_ns,
            tait_pressure=b.tait_pressure,
            apply_inlet_bc=b.apply_inlet_bc,
            apply_outlet_bc=b.apply_outlet_bc,
            apply_wall_bc=b.apply_wall_bc,
            apply_wall_concentration_bc=b.apply_wall_concentration_bc,
            apply_solid_surface_bc=bc.apply_solid_surface_bc,  # elementwise
            smooth_boundary_concentration=b.smooth_boundary_concentration,
            update_fictitious=b.update_fictitious,
            ard_step=b.ard_step,
            ard_compute_dt=b.ard_compute_dt,
            apply_phase_change=b.apply_phase_change,
            assemble=b.assemble,
            linear_system=b.linear_system,
            compute_adaptive_dt=b.compute_adaptive_dt,
        )

    if not is_structured(kit):
        from . import unstructured as u

        return SimpleNamespace(
            ns_step=u.ns_step,
            compute_dt_ns=u.compute_dt_ns,
            tait_pressure=u.tait_pressure,
            apply_inlet_bc=u.apply_inlet_bc,
            apply_outlet_bc=u.apply_outlet_bc,
            apply_wall_bc=u.apply_wall_bc,
            apply_wall_concentration_bc=u.apply_wall_concentration_bc,
            apply_solid_surface_bc=u.apply_solid_surface_bc,
            smooth_boundary_concentration=u.smooth_boundary_concentration,
            update_fictitious=u.update_fictitious,
            ard_step=u.ard_step,
            ard_compute_dt=u.ard_compute_dt,
            apply_phase_change=u.apply_phase_change,
            assemble=u.assemble,
            linear_system=u.linear_system,
            compute_adaptive_dt=u.compute_adaptive_dt,
        )

    from .ops import ard, ard_implicit as ai, ns

    return SimpleNamespace(
        ns_step=ns.ns_step,
        compute_dt_ns=ns.compute_dt,
        tait_pressure=ns.tait_pressure,
        apply_inlet_bc=bc.apply_inlet_bc,
        apply_outlet_bc=bc.apply_outlet_bc,
        apply_wall_bc=bc.apply_wall_bc,
        apply_wall_concentration_bc=bc.apply_wall_concentration_bc,
        apply_solid_surface_bc=bc.apply_solid_surface_bc,
        smooth_boundary_concentration=bc.smooth_boundary_concentration,
        update_fictitious=_identity,  # no AMR coupling
        ard_step=ard.ard_step,
        ard_compute_dt=ard.compute_dt,
        apply_phase_change=ard.apply_phase_change,
        assemble=ai.assemble,
        linear_system=ai.linear_system,
        compute_adaptive_dt=ai.compute_adaptive_dt,
    )
