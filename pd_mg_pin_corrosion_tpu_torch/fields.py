"""Simulation state as a dataclass of tensors.

Port of ``pd_mg_pin_corrosion_tpu/fields.py``. Same fields, layouts and
initial values: every per-node field is a dense tensor of the grid's
spatial shape ([Ny, Nx] in 2D), velocity carries a trailing [dim] axis, and
C-order flattening reproduces the reference's node index. Functions return
new States (``dataclasses.replace``) rather than updating in place, like the
JAX package.

The constructors (``initialize_state``, ``state_from_numpy``, and
``kit.build_kit``) put their tensors on the card unless the caller passes
``device="cpu"``; without a card they raise ``DeviceUnavailable`` and never
fall back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .config import Config
from .grid import FICTITIOUS, FLUID, INLET, OUTLET, SOLID_MG, WALL, Grid


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (the constructors' default) and there is none."""


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises DeviceUnavailable for a CUDA
    device when there is no card (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"no CUDA device available for device={str(device)!r}; pass "
            f"device=\"cpu\" to build on the CPU")
    return dev


@dataclass
class State:
    rho: torch.Tensor        # [*S]
    vel: torch.Tensor        # [*S, dim]
    pressure: torch.Tensor   # [*S]
    C: torch.Tensor          # [*S]
    node_type: torch.Tensor  # [*S] uint8 — mutated by phase change
    phase: torch.Tensor      # [*S] uint8 (0=solid, 1=liquid)
    D_map: torch.Tensor      # [*S] — visualization/bookkeeping only
    grain_id: torch.Tensor   # [*S] int32
    is_gb: torch.Tensor      # [*S] bool
    is_precip: torch.Tensor  # [*S] bool

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)]


def store_into(bufs: State, st: State, written: set) -> None:
    """Copy the fields of ``st`` that are not ``bufs``' own tensors into
    them, noting their names in ``written``: a runner's static buffers,
    which its captured CUDA graphs read and write in place."""
    for f in fields(State):
        buf, t = getattr(bufs, f.name), getattr(st, f.name)
        if t is not buf:
            buf.copy_(t)
            written.add(f.name)


def copies_of(bufs: State, state: State, written: set) -> State:
    """``state`` with fresh copies of ``bufs``' ``written`` fields (the
    runner's next step overwrites its buffers) and its own tensors for the
    rest."""
    return State(**{f.name: (getattr(bufs, f.name).clone()
                             if f.name in written else getattr(state, f.name))
                    for f in fields(State)})


# torch dtype of each non-float field (the float fields take the run dtype)
_FIXED_DTYPES = {"node_type": torch.uint8, "phase": torch.uint8,
                 "grain_id": torch.int32, "is_gb": torch.bool,
                 "is_precip": torch.bool}


def poiseuille_axial(cfg: Config, pos: np.ndarray) -> np.ndarray:
    """Analytic inlet profile (reference: src/main.cpp:25-38, boundary.cpp:41-52).

    2D planar: v = 1.5 * U_in * (1 - (r/R)^2); 3D circular: 2.0 * U_in * (...).
    """
    R2 = cfg.R_tube * cfg.R_tube
    px = pos[..., 0]
    if cfg.dim == 2:
        r_ratio2 = np.minimum(px * px / R2, 1.0)
        return 1.5 * cfg.U_in * (1.0 - r_ratio2)
    py = pos[..., 1]
    r_ratio2 = np.minimum((px * px + py * py) / R2, 1.0)
    return 2.0 * cfg.U_in * (1.0 - r_ratio2)


def state_from_numpy(arrays: dict, dtype=torch.float32,
                     device="cuda") -> State:
    """State from host arrays keyed by field name — e.g. a JAX package
    State fetched with ``np.asarray`` — so both packages can start from
    identical fields. Float fields are cast to ``dtype``; on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)
    out = {}
    for f in fields(State):
        t = _FIXED_DTYPES.get(f.name, dtype)
        out[f.name] = torch.tensor(np.asarray(arrays[f.name]), dtype=t,
                                   device=device)
    return State(**out)


def initialize_state(grid: Grid, cfg: Config, grains=None,
                     dtype=torch.float32, device="cuda") -> State:
    """Per-node-type initial values (reference: src/main.cpp:9-127), on the
    card unless ``device="cpu"``."""
    device = resolve_device(device)
    nt = grid.node_type
    shape = grid.shape
    dim = grid.dim

    rho = np.zeros(shape)
    vel = np.zeros(shape + (dim,))
    C = np.zeros(shape)
    D_map = np.zeros(shape)
    phase = np.ones(shape, dtype=np.uint8)

    v_pois = poiseuille_axial(cfg, grid.pos)
    axial = dim - 1  # velocity component index of the axial direction

    if grains is not None:
        is_gb = grains.is_grain_boundary.astype(bool)
        is_precip = grains.is_precipitate.astype(bool)
        grain_id = grains.grain_id.astype(np.int32)
    else:
        is_gb = np.zeros(shape, dtype=bool)
        is_precip = np.zeros(shape, dtype=bool)
        grain_id = np.full(shape, -1, dtype=np.int32)

    fluid = nt == FLUID
    solid = nt == SOLID_MG
    wall = nt == WALL
    inlet = nt == INLET
    outlet = nt == OUTLET
    fict = nt == FICTITIOUS

    # FLUID: Poiseuille warm start for faster flow convergence (main.cpp:16-39)
    rho[fluid] = cfg.rho_f
    C[fluid] = cfg.C_liquid_init
    D_map[fluid] = cfg.D_liquid
    vel[..., axial][fluid] = v_pois[fluid]

    # SOLID_MG: fluid density for PD flow equations (main.cpp:43), C=1,
    # D_map from grain structure GB > precipitate > grain (main.cpp:48-55)
    rho[solid] = cfg.rho_f
    C[solid] = cfg.C_solid_init
    phase[solid] = 0
    D_solid = np.where(is_gb, cfg.D_gb, np.where(is_precip, cfg.D_precip, cfg.D_grain))
    D_map[solid] = D_solid[solid]

    # WALL (main.cpp:58-64)
    rho[wall] = cfg.rho_f

    # INLET: Poiseuille (main.cpp:66-90)
    rho[inlet] = cfg.rho_f
    C[inlet] = cfg.C_liquid_init
    D_map[inlet] = cfg.D_liquid
    vel[..., axial][inlet] = v_pois[inlet]

    # OUTLET (main.cpp:92-98)
    rho[outlet] = cfg.rho_f
    C[outlet] = cfg.C_liquid_init
    D_map[outlet] = cfg.D_liquid

    # OUTSIDE: rho=0 (main.cpp:100-106) — all-zero already

    # FICTITIOUS (main.cpp:108-114)
    rho[fict] = cfg.rho_f
    D_map[fict] = cfg.D_liquid

    return state_from_numpy(
        dict(rho=rho, vel=vel, pressure=np.zeros(shape), C=C, node_type=nt,
             phase=phase, D_map=D_map, grain_id=grain_id, is_gb=is_gb,
             is_precip=is_precip),
        dtype=dtype, device=device)
