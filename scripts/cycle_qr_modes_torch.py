#!/usr/bin/env python3
"""cycle_qr's modes on the card, in CUDA graph replays and eagerly, against
a chain floor.

    python3 scripts/cycle_qr_modes_torch.py

Each mode of ``csrc/cycle_qr.cu`` runs on the state that
``cycle_loop.walk`` (seed 0, run on the card) leaves right before the
mode's first run there, restored before each timing. As
``scripts/gmres_qr_modes_torch.py`` times gmres_qr (its ``graph_ms``,
``eager_ms`` and ``latency_ns``): the mode captured 64 times into one CUDA
graph, timed by CUDA events over replays (median of 7 rounds of 10
replays), and eagerly (64 calls behind a spin kernel). The chain floor of
a mode is its longest chain of dependent float64 operations
(comparisons and conversions counted) times the latency of one dependent
float64 add measured in the same process; the bound is the mode's unique
bytes over 3.35 TB/s. Beside the modes, a one-element ``torch.add_``
timed the same two ways: what any node of one thread costs.

Prints the card's name and power limit, then one JSON line a case. Needs
a CUDA device; imports nothing of JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_RATE = 3.35e12
# each mode's longest chain of dependent float64 operations (csrc/cycle_qr.cu):
# BEGIN the cap's min, then a comparison (more()); CYC_START a sum, its
# comparison with 0 and the cap's conversion; FLOW_NEXT and FLOW_CHECK IT's
# conversion and the new IT's; FLOW_END the conversions of IT and IT0, then
# the sum into FLOW_ITERS; ASM_END a comparison; INNER_START a difference
# and its comparison; INNER_END the sum into STEPS, its conversion and the
# output test; PC_END a conversion and its successor's; OUTER a sum, then
# more()'s min and comparison
CHAINS = {"BEGIN": 2, "CYC_START": 3, "FLOW_NEXT": 2, "FLOW_CHECK": 2,
          "FLOW_END": 3, "ASM_END": 1, "INNER_START": 2, "INNER_END": 3,
          "PC_END": 2, "OUTER": 3}


def load_modes_script():
    spec = importlib.util.spec_from_file_location(
        "gmres_qr_modes_torch", os.path.join(ROOT, "scripts",
                                             "gmres_qr_modes_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def states_before_modes(cl, dl):
    """{mode: (Y, CF, S, F, sc, params)} on the card: the state before each
    mode's first run on cycle_loop.walk's sequence of seed 0."""
    lay, glay = cl.CycleLayout(4), dl.QrLayout(4, 8)
    Y = torch.zeros(lay.size, dtype=torch.float64, device="cuda")
    CF = torch.zeros(cl.N_FLAGS, dtype=torch.bool, device="cuda")
    S = torch.zeros(glay.size, dtype=torch.float64, device="cuda")
    S[glay.sc("T_FINAL")] = 40.0
    F = torch.zeros(dl.N_FLAGS, dtype=torch.bool, device="cuda")
    sc = glay.SC
    seen = {}

    def run_mode(mode, params, ys, ss):
        for k, v in ys.items():
            Y[cl.SC[k]] = v
        for k, v in ss.items():
            S[sc + dl.SC_INDEX[k]] = v
        if mode not in seen:
            seen[mode] = tuple(t.clone() for t in (Y, CF, S, F)) + (
                sc, params)
        cl.cycle_qr(mode, Y, CF, S, F, sc, params)

    cl.walk(run_mode, lambda: (Y.tolist(), CF.tolist()), 0)
    return seen


def main():
    if not torch.cuda.is_available():
        sys.exit("cycle_qr_modes_torch.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    from pd_mg_pin_corrosion_tpu_torch.kernels import build
    from pd_mg_pin_corrosion_tpu_torch.kernels import cycle_loop as cl
    from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl

    qm = load_modes_script()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    build.load()
    (add_ns, add_cyc), (mul_ns, _) = qm.latency_ns(build)
    print(json.dumps({"case": "f64_latency", "add_ns": add_ns,
                      "add_cycles": add_cyc, "mul_ns": mul_ns}))
    one = torch.zeros(1, device="cuda")
    ms, nodes, _ = qm.graph_ms(lambda: one.add_(1.0))
    print(json.dumps({"case": "one_element_add", "ms": ms, "nodes": nodes,
                      "eager_ms": qm.eager_ms(lambda: one.add_(1.0))}))
    seen = states_before_modes(cl, dl)
    names = {getattr(cl, n): n for n in CHAINS}
    lay = cl.CycleLayout(4)
    for mode in range(cl.N_MODES):
        Y0, CF0, S0, F0, sc, params = seen[mode]
        Y, CF, S, F = (t.clone() for t in (Y0, CF0, S0, F0))

        def seq(mode=mode, Y=Y, CF=CF, S=S, F=F, sc=sc, params=params):
            cl.cycle_qr(mode, Y, CF, S, F, sc, params)

        def restore(Y=Y, CF=CF, S=S, F=F, src=(Y0, CF0, S0, F0)):
            for a, b in zip((Y, CF, S, F), src):
                a.copy_(b)

        restore()
        g_ms, g_nodes, g_knodes = qm.graph_ms(seq)
        restore()
        e_ms = qm.eager_ms(seq)
        name = names[mode]
        chain = CHAINS[name]
        # Y's scalars and trip counters, CF, and gmres_qr's scalars
        nbytes = 8 * (len(cl.SCALARS) + len(cl.TRIPS)) + cl.N_FLAGS + (
            8 * 8 if name in ("INNER_START", "INNER_END") else 0)
        print(json.dumps({
            "case": name, "ms": g_ms, "nodes": g_nodes,
            "kernel_nodes": g_knodes, "eager_ms": e_ms, "chain_ops": chain,
            "floor_ms": chain * add_ns * 1e-6,
            "bound_ms": 1e3 * nbytes / HBM_RATE, "Y_size": lay.size}))


if __name__ == "__main__":
    main()
