"""What the PyTorch/CUDA port's calibration scripts share
(scripts/calibrate_3d_torch.py, scripts/calibrate_2d_torch.py): the
Reimers anchors, the switches, the run of a Config through the port's
``cli.build`` and ``CoupledSolver``, and the REPORT.md rows, which are
those of scripts/calibrate_3d.py and scripts/calibrate_2d.py to the
character.

Switches of both scripts (verification and placement only; the ladder
syntax is the JAX scripts'):

* ``--out BASE`` (default ``output/calib_<dim>_torch``): where each label's
  run and REPORT.md go. Never under docs/runs/, which holds the JAX
  package's banked calibration runs.
* ``--device cuda|cpu`` (default ``$PD_TORCH_DEVICE``, else ``cuda``):
  without a CUDA device the run stops unless ``cpu`` was asked for.
* ``--grain-draw=banked``: the grain generator's two-division uniform_int
  of the runs banked before the draw was made bit-exact with libstdc++
  (``replay_banked_amr.two_division_uniform_int``), for the run only.

numpy only when imported; the port is imported by ``run_config``. The
scripts put the repository root on ``sys.path``.
"""

import contextlib
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = os.path.join(ROOT, "docs", "runs")

# 4.23 h (config/params_calibration.cfg:59) and 22.86 % loss
# (params_calibration.cfg:28-31); ~50 % at 9 h (README.md:9)
T_ANCHOR1, LOSS_ANCHOR1 = 15228.0, 22.86
T_ANCHOR2, LOSS_ANCHOR2 = 32400.0, 50.0
GRAIN_DRAWS = ("current", "banked")


def parse_switches(argv, default_out):
    """(positional args, --key=value args, out, device, grain_draw) from
    argv: ``--out`` and ``--device`` take their value as ``--x=v`` or as
    the next argument; other ``--`` arguments are handed back."""
    out = default_out
    device = os.environ.get("PD_TORCH_DEVICE", "cuda")
    draw = "current"
    args, other = [], []
    rest = list(argv)
    while rest:
        a = rest.pop(0)
        key, eq, value = a.partition("=")
        if key in ("--out", "--device"):
            if not eq:
                if not rest:
                    raise SystemExit(f"{key} needs a value")
                value = rest.pop(0)
            if key == "--out":
                out = value
            else:
                device = value
        elif key == "--grain-draw":
            if value not in GRAIN_DRAWS:
                raise SystemExit(f"--grain-draw is one of {GRAIN_DRAWS}")
            draw = value
        elif a.startswith("--"):
            other.append(a)
        else:
            args.append(a)
    return args, other, checked_out(out), device, draw


def checked_out(base):
    """``base``, unless it lies under docs/runs/ (SystemExit)."""
    banks = os.path.realpath(BANKS)
    where = os.path.realpath(base)
    if os.path.commonpath([banks, where]) == banks:
        raise SystemExit(f"--out {base}: the torch scripts never write under "
                         f"docs/runs/ (the JAX package's banked runs)")
    return base


@contextlib.contextmanager
def grain_draw(name):
    """The grain generator's uniform_int for the block: the current one, or
    the two-division draw of the banked runs."""
    from pd_mg_pin_corrosion_tpu_torch import grains

    if name == "current":
        yield
        return
    from replay_banked_amr import two_division_uniform_int

    stream = grains._MT19937Stream
    current = stream.uniform_int
    stream.uniform_int = two_division_uniform_int
    try:
        yield
    finally:
        stream.uniform_int = current


def run_config(cfg, device, draw, banner):
    """A loaded Config (``compute_derived`` done) through the port's
    ``cli.build`` (grid, grains drawn with ``draw``, kit and state on
    ``device``) and ``CoupledSolver().run``, printing the kernels'
    launches in the run. ``banner`` is printed with the node count as
    ``{N}``. Returns (the diagnostics rows as a 2D array, the
    CoupledSolver)."""
    from pd_mg_pin_corrosion_tpu_torch import cli, kernels
    from pd_mg_pin_corrosion_tpu_torch.coupling import CoupledSolver

    dev = cli.device_of(device)
    with grain_draw(draw):
        grid, kit, state = cli.build(cfg, dev)
    print(banner.format(N=grid.N_total), flush=True)
    solver = CoupledSolver()
    kernels.reset_launch_counts()
    solver.run(grid, state, kit, cfg)
    print(f"  Kernel launches: {kernels.launch_counts()}", flush=True)
    rows = np.atleast_2d(np.loadtxt(f"{cfg.output_dir}/diagnostics.csv",
                                    delimiter=",", skiprows=1))
    return rows, solver


def loss_at(rows, t):
    """pin_mass_loss_pct at time t, linear between the rows."""
    return float(np.interp(t, rows[:, 0], rows[:, 2]))


def result_3d(label, dg, dgb, gbw, rows):
    return (label, dg, dgb, gbw, loss_at(rows, T_ANCHOR1), rows[-1, 2],
            rows[-1, 0])


def header_3d(dx):
    return [
        "# 3D calibration sweep vs Reimers anchors",
        "",
        f"Geometry: params_3d.cfg at dx={dx:g}; anchor "
        f"{LOSS_ANCHOR1} % at t={T_ANCHOR1:.0f} s (4.23 h).",
        "",
        "| label | D_grain | D_gb | gb_w | loss @4.23h | final loss | t_end |",
        "|---|---|---|---|---|---|---|",
    ]


def line_3d(r):
    return (f"| {r[0]} | {r[1]:g} | {r[2]:g} | {r[3]} | "
            f"{r[4]:.2f} % | {r[5]:.2f} % | {r[6]:.0f} s |")


def result_2d(label, dg, dgb, dl, al, rows):
    return (label, dg, dgb, f"{dl}/{al}", loss_at(rows, T_ANCHOR1),
            loss_at(rows, T_ANCHOR2), rows[-1, 0])


def header_2d():
    return [
        "# 2D two-anchor calibration (reference-native knobs)",
        "",
        f"Geometry: params_implicit_test.cfg (2D r-z, dx=5e-6). Anchors: "
        f"{LOSS_ANCHOR1} % at 4.23 h, ~{LOSS_ANCHOR2:.0f} % at 9 h "
        "(Reimers et al. 2023).",
        "",
        "| label | D_grain | D_gb | decay_l | loss @4.23h | loss @9h | t_end |",
        "|---|---|---|---|---|---|---|",
    ]


def line_2d(r):
    return (f"| {r[0]} | {r[1]:g} | {r[2]:g} | {r[3]} | "
            f"{r[4]:.2f} % | {r[5]:.2f} % | {r[6]:.0f} s |")


def append_report(base, header, lines):
    """Append ``lines`` (and a blank line) to base/REPORT.md, after
    ``header`` when the file is new; print what was appended."""
    report = os.path.join(base, "REPORT.md")
    out = ([] if os.path.exists(report) else list(header)) + lines + [""]
    with open(report, "a") as f:
        f.write("\n".join(out))
    print("\n".join(out))
