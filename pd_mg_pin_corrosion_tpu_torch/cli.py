"""CLI entry point of the PyTorch/CUDA port:

    python -m pd_mg_pin_corrosion_tpu_torch [params.cfg] [key=value ...]
                                            [--device cuda|cpu]

Same argv contract, console lines and output files as the JAX package's
``cli.py``: loads the config (default config/params.cfg), applies the
``key=value`` overrides, builds grid + grains + kit + state on the device,
and runs the coupled solver. The device comes from ``--device``, else
``$PD_TORCH_DEVICE``, else ``cuda``; without a CUDA device the run stops
with an error unless ``cpu`` was asked for explicitly.

``PD_TPU_PROFILE=<dir>`` traces the whole run with ``torch.profiler`` (CPU
and, on the card, CUDA activities) and writes one Chrome trace into
``<dir>`` when the run ends, as the JAX package's hook writes its
``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from .fields import DeviceUnavailable


def parse_args(argv):
    """(cfg_path, overrides, device) from the argv contract."""
    cfg_path = "config/params.cfg"
    overrides = []
    device = os.environ.get("PD_TORCH_DEVICE", "cuda")
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "--device":
            if not args:
                raise SystemExit("--device needs a value (cuda or cpu)")
            device = args.pop(0)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif "=" in a:
            overrides.append(a)
        else:
            cfg_path = a
    return cfg_path, overrides, device


def device_of(device) -> torch.device:
    """The torch.device named ``device``; DeviceUnavailable for a CUDA
    device on a host without one (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable("no CUDA device available; pass --device cpu"
                                " (or PD_TORCH_DEVICE=cpu) to run on the CPU")
    return dev


@contextlib.contextmanager
def profiled(profile_dir, dev):
    """A torch.profiler trace of the block, written into ``profile_dir`` as
    one Chrome trace when the block ends (nothing when it is empty)."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, f"pd_torch_{os.getpid()}_"
                            f"{time.strftime('%Y%m%d_%H%M%S')}.trace.json")
        prof.export_chrome_trace(path)
        print(f"  Profile: {path}")


def run(argv=None):
    """Run one simulation; returns the CoupledSolver (its run totals and
    final_state)."""
    argv = sys.argv[1:] if argv is None else argv
    cfg_path, overrides, device = parse_args(argv)

    print("=== Peridynamic Mg-Pin Corrosion Simulation (PyTorch/CUDA port) ===")
    dev = device_of(device)
    with profiled(os.environ.get("PD_TPU_PROFILE", ""), dev):
        return _run(cfg_path, overrides, dev)


def _run(cfg_path, overrides, dev):
    from .config import Config
    cfg = Config.load(cfg_path)
    if overrides:
        cfg.apply_overrides(overrides)
    print(f"  Dimension: {cfg.dim}D\n")
    cfg.print()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host")
    print(f"  Device: {dev} ({name})")

    t0 = time.time()
    grid, kit, state = build(cfg, dev)
    print(f"  [Timer] initialization: {time.time() - t0:.3f} s")

    from .coupling import CoupledSolver
    solver = CoupledSolver()
    solver.run(grid, state, kit, cfg)
    return solver


def build(cfg, dev):
    """(grid, kit, initial state) of a loaded Config on ``dev``: the grid
    (uniform; for ``use_amr = 1`` block AMR, or the gather backend's
    unstructured grid with ``amr_backend = gather``), the grains, the kit
    and the state, with the CLI's console lines."""
    blocks = cfg.use_amr and cfg.amr_backend == "structured"
    print("Building grid...")
    if blocks:
        from . import amr_blocks
        grid = amr_blocks.build_amr_block_grid(cfg)
    elif cfg.use_amr:
        from .amr import build_amr_grid
        grid = build_amr_grid(cfg)
    else:
        from .grid import build_grid
        grid = build_grid(cfg)
        counts = grid.type_counts()
        print(f"Grid: Nx={grid.Nx} Ny={grid.Ny} Nz={grid.Nz}  "
              f"N_total={grid.N_total}")
        print("Node types: " + " ".join(f"{k}={v}" for k, v in counts.items()))

    print("Generating grain structure...")
    if blocks:
        grains = amr_blocks.generate_grains_b(grid, cfg)
    else:
        from . import grains as grains_mod
        grains = grains_mod.generate(grid, cfg)

    print("Initializing fields...")
    from .fields import initialize_state
    if blocks:
        kit = amr_blocks.build_bkit(grid, cfg, device=dev)
    elif cfg.use_amr:
        from .unstructured import build_ukit
        kit = build_ukit(grid, cfg, device=dev)
    else:
        from .kit import build_kit
        kit = build_kit(grid, cfg, device=dev)
    state = initialize_state(grid, cfg, grains=grains, dtype=kit.dtype,
                             device=dev)
    return grid, kit, state


def main(argv=None) -> int:
    try:
        run(argv)
    except DeviceUnavailable as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
