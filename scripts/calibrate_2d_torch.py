"""2D two-anchor calibration vs the Reimers anchors, on the PyTorch/CUDA
port: the counterpart of scripts/calibrate_2d.py (same ladder, same
overrides, same REPORT.md rows), through the port's entry points
(scripts/calibration_torch.py ``run_config``: the port's ``cli.build``
and ``CoupledSolver``).

Usage: python scripts/calibrate_2d_torch.py
           [label=D_grain:D_gb[:decay_l[:accel_l]] ...]
           [--out BASE] [--device cuda|cpu] [--grain-draw=banked]

Each label runs config/params_implicit_test.cfg (2D r-z, dx = 5e-6, 7,973
nodes, its own f32 precision and 9 h T_final) with its D_grain, D_gb and,
when given, corrosion_decay_l and corrosion_accel_l (0 disables either).
Writes BASE/<label>/diagnostics.csv and appends the points' rows to
BASE/REPORT.md (BASE: output/calib_2d_torch unless --out says otherwise;
never under docs/runs/). ``compare_banked.py
BASE/<label>/diagnostics.csv docs/runs/calib_2d/<label>/diagnostics.csv``
holds a point against the JAX package's banked run.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import calibration_torch as calib  # noqa: E402

CFG = os.path.join(calib.ROOT, "config", "params_implicit_test.cfg")
DEFAULT_OUT = os.path.join("output", "calib_2d_torch")
LADDER = [("baseline-9h", 1.0e-16, 1.0e-14, None, None)]


def run_one(label, D_grain, D_gb, decay_l, outdir, accel_l=None,
            t_final=None, device="cuda", draw="current"):
    """One ladder point, to the configuration's T_final unless ``t_final``
    is given; returns (diagnostics rows, the CoupledSolver)."""
    from pd_mg_pin_corrosion_tpu_torch.config import Config

    cfg = Config.load(CFG)
    cfg.D_grain = D_grain
    cfg.D_gb = D_gb
    if decay_l is not None:
        cfg.corrosion_decay_l = decay_l
    if accel_l is not None:
        cfg.corrosion_accel_l = accel_l
    if t_final is not None:
        cfg.T_final = t_final
    cfg.output_dir = outdir
    cfg.checkpoint_every = 0
    cfg.flow_output_stride = 10**9
    cfg.implicit_output_every = 10**9
    cfg.compute_derived()
    return calib.run_config(
        cfg, device, draw, f"=== [{label}] N={{N}} D_grain={D_grain:g} "
        f"D_gb={D_gb:g} decay_l={decay_l} ===")


def parse_ladder(args):
    ladder = []
    for a in args:
        label, _, dv = a.partition("=")
        parts = dv.split(":")
        dg, dgb = float(parts[0]), float(parts[1])
        dl = float(parts[2]) if len(parts) > 2 else None
        al = float(parts[3]) if len(parts) > 3 else None
        ladder.append((label, dg, dgb, dl, al))
    return ladder or list(LADDER)


def main(argv=None) -> int:
    from pd_mg_pin_corrosion_tpu_torch.fields import DeviceUnavailable

    argv = sys.argv[1:] if argv is None else list(argv)
    args, other, base, device, draw = calib.parse_switches(argv, DEFAULT_OUT)
    if other:
        raise SystemExit(f"unknown switch(es) {other}")
    ladder = parse_ladder(args)

    os.makedirs(base, exist_ok=True)
    results = []
    try:
        for label, dg, dgb, dl, al in ladder:
            rows, _ = run_one(label, dg, dgb, dl, os.path.join(base, label),
                              accel_l=al, device=device, draw=draw)
            results.append(calib.result_2d(label, dg, dgb, dl, al, rows))
    except DeviceUnavailable as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    calib.append_report(base, calib.header_2d(),
                        [calib.line_2d(r) for r in results])
    return 0


if __name__ == "__main__":
    sys.exit(main())
