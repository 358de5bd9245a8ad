"""3D transport-parameter calibration vs the Reimers anchors, on the
PyTorch/CUDA port: the counterpart of scripts/calibrate_3d.py (same
ladder, same overrides, same REPORT.md rows), through the port's entry
points (scripts/calibration_torch.py ``run_config``: the port's
``cli.build`` and ``CoupledSolver``).

Usage: python scripts/calibrate_3d_torch.py [dx] [--tfinal=SECONDS]
           [label=D_grain:D_gb[:gb_width[:grain_size_mean[:accel_l]]] ...]
           [--out BASE] [--device cuda|cpu] [--grain-draw=banked]

Each label runs config/params_3d.cfg at ``dx`` (default 8e-6: 166,050
nodes) with its D_grain, D_gb, gb_width_cells and, when given,
grain_size_mean and corrosion_accel_l, in f32 with f64 refinement, to
T_final = --tfinal (default the 4.23 h anchor, 15,228 s; 32,400 for the
9 h anchor). grain_size_mean comes before corrosion_accel_l, so a ladder
point that sets only the latter spells the former out (twoanchor-c:
``2.1609e-17:2.1609e-15:0:40e-6:1.2790``). Writes
BASE/<label>/diagnostics.csv and appends the points' rows to
BASE/REPORT.md (BASE: output/calib_3d_torch unless --out says otherwise;
never under docs/runs/). ``compare_banked.py BASE/<label>/diagnostics.csv
docs/runs/calib_3d/<label>/diagnostics.csv`` holds a point against the
JAX package's banked run.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import calibration_torch as calib  # noqa: E402

CFG = os.path.join(calib.ROOT, "config", "params_3d.cfg")
DEFAULT_OUT = os.path.join("output", "calib_3d_torch")
LADDER = [
    ("2d-calibrated", 5e-11, 5e-9, 1, None, None),
    ("shipped-3d", 1e-16, 1e-14, 0, None, None),
    ("mid-a", 1e-12, 1e-10, 1, None, None),
    ("mid-b", 1e-13, 1e-11, 1, None, None),
]


def run_one(label, dx, D_grain, D_gb, gbw, outdir, gsm=None, accel=None,
            t_final=calib.T_ANCHOR1, device="cuda", draw="current"):
    """One ladder point to t_final; returns (diagnostics rows, the
    CoupledSolver)."""
    from pd_mg_pin_corrosion_tpu_torch.config import Config

    cfg = Config.load(CFG)
    cfg.dx = dx
    cfg.D_grain = D_grain
    cfg.D_gb = D_gb
    cfg.gb_width_cells = gbw
    if gsm is not None:
        cfg.grain_size_mean = gsm
    if accel is not None:
        cfg.corrosion_accel_l = accel
    cfg.T_final = t_final
    cfg.output_dir = outdir
    cfg.checkpoint_every = 0
    cfg.flow_output_stride = 10**9
    cfg.implicit_output_every = 10**9
    cfg.precision = "f32"
    cfg.compute_derived()
    return calib.run_config(
        cfg, device, draw, f"=== [{label}] N={{N}} D_grain={D_grain:g} "
        f"D_gb={D_gb:g} gb_width={gbw} ===")


def parse_ladder(args):
    ladder = []
    for a in args:
        label, _, dv = a.partition("=")
        parts = dv.split(":")
        dg, dgb = float(parts[0]), float(parts[1])
        gbw = int(parts[2]) if len(parts) > 2 else 1
        gsm = float(parts[3]) if len(parts) > 3 else None
        accel = float(parts[4]) if len(parts) > 4 else None
        ladder.append((label, dg, dgb, gbw, gsm, accel))
    return ladder or list(LADDER)


def main(argv=None) -> int:
    from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable

    argv = sys.argv[1:] if argv is None else list(argv)
    args, other, base, device, draw = calib.parse_switches(argv, DEFAULT_OUT)
    t_final = calib.T_ANCHOR1
    for a in other:
        if not a.startswith("--tfinal="):
            raise SystemExit(f"unknown switch {a}")
        t_final = float(a.split("=", 1)[1])
    dx = float(args[0]) if args else 8.0e-6
    ladder = parse_ladder(args[1:])

    os.makedirs(base, exist_ok=True)
    results = []
    try:
        for label, dg, dgb, gbw, gsm, accel in ladder:
            rows, _ = run_one(label, dx, dg, dgb, gbw,
                              os.path.join(base, label), gsm=gsm,
                              accel=accel, t_final=t_final, device=device,
                              draw=draw)
            results.append(calib.result_3d(label, dg, dgb, gbw, rows))
    except DeviceUnavailable as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    calib.append_report(base, calib.header_3d(dx),
                        [calib.line_3d(r) for r in results])
    return 0


if __name__ == "__main__":
    sys.exit(main())
