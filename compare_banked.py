#!/usr/bin/env python3
"""Compare a whole run's diagnostics.csv with a banked one.

    python3 compare_banked.py RUN_CSV BANKED_CSV [--limit 0.01]

Prints both runs' last rows, the relative difference of the final
pin_mass_loss_pct and solid_nodes, and, over the whole curve, the largest
difference of each column against the banked curve interpolated (linearly
in time) at the run's own row times, and the largest difference of the
time at which each solid-node count is first reached. Exits 1 unless the
final pin_mass_loss_pct and solid_nodes are both within ``--limit``
(relative) of the banked ones. numpy only: it runs on any host.
"""

import argparse
import sys

import numpy as np


def rows(path):
    return np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run")
    ap.add_argument("banked")
    ap.add_argument("--limit", type=float, default=0.01)
    a = ap.parse_args(argv)
    ours, ref = rows(a.run), rows(a.banked)
    cols = ("pin_mass_loss_pct", "solid_nodes", "v_max", "C_max_fluid")
    for name, r in (("run", ours), ("banked", ref)):
        last = r[-1]
        print(f"{name}: {len(r)} rows, last t={last['time_s']:.6e} s "
              f"({last['time_h']:.4f} h) "
              + " ".join(f"{c}={last[c]:.6g}" for c in cols))
    final = {c: float(abs(ours[c][-1] - ref[c][-1]) / abs(ref[c][-1]))
             for c in ("pin_mass_loss_pct", "solid_nodes")}
    print("final rel diff: " + ", ".join(f"{c} {v:.3e}"
                                          for c, v in final.items())
          + f" (limit {a.limit:g})")
    t = ours["time_s"]
    inside = t <= ref["time_s"][-1]
    for c in cols:
        interp = np.interp(t[inside], ref["time_s"], ref[c])
        d = np.abs(ours[c][inside] - interp)
        k = int(np.argmax(d))
        print(f"curve {c}: max |diff| {d[k]:.4g} at t={t[inside][k]:.1f} s "
              f"(banked there {interp[k]:.6g}); max rel "
              f"{float((d / np.maximum(np.abs(interp), 1e-300)).max()):.3e}")
    # when each solid-node count is first reached
    shared = sorted(set(ours["solid_nodes"].astype(int))
                    & set(ref["solid_nodes"].astype(int)))
    first = [(n, t[np.argmax(ours["solid_nodes"] == n)],
              ref["time_s"][np.argmax(ref["solid_nodes"] == n)])
             for n in shared]
    if first:
        n, to, tr = max(first, key=lambda f: abs(f[1] - f[2]))
        print(f"dissolution times: {len(first)} shared solid counts; largest "
              f"shift {to - tr:+.1f} s at {n} solid nodes "
              f"(run {to:.1f} s, banked {tr:.1f} s)")
    ok = all(v <= a.limit for v in final.values())
    print(f"final rows within {a.limit:g}: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
