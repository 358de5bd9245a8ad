#!/usr/bin/env python3
"""Sweep the free parameters of the port's basis_axpy and matvec3d kernels
on one CUDA device.

    python3 scripts/sweep_kernels_torch.py [axpy] [matvec3d]

The kernels' compile-time constants (``PD_AXPY_ROWS``: rows per register
group of basis_axpy; ``PD_MATVEC3D_GROUP``: weights of a row stored side by
side in matvec3d's packed layout; ``PD_MATVEC3D_TURN_BYTES``: bytes of
weights a thread loads per full turn of its row walk) are ``#ifndef``
macros in csrc/; this script builds one library per value (``kernels.build.build_library``), calls the C entry
points directly, holds every variant to the plain twin bit for bit, and
prints median times (chip_smoke.py's protocol: CUDA events around
back-to-back calls behind a spin kernel; for matvec3d also one call at a
time behind another kernel):

* axpy: rows per group x threads per block x 4-element pieces per thread,
  at (26, 196,749), (13, 196,749) and (26, 1,055,668), rows 128-byte
  aligned, beside ``torch.addmv`` on the same tensors;
* matvec3d: group size x bytes per turn, packed f32 and bf16 weights, on
  the assembled operator of config/params_3d.cfg (1,055,668 nodes,
  S = 178), each group size with its own packing.

The port's wrappers use the values the sources default to. Needs a CUDA
device; imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pd_mg_pin_corrosion_tpu_torch as pkg  # noqa: E402
from chip_smoke import (FLAGSHIP, SEED, apart_ms, median_ms,  # noqa: E402
                        nvidia_smi, seeded)
from pd_mg_pin_corrosion_tpu_torch import grains, kernels  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch.kernels.build import (  # noqa: E402
    build_library, ptr, stream)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai  # noqa: E402

AXPY_ROWS = (4, 8, 13)
AXPY_THREADS = (64, 128, 256)
AXPY_PIECES = (1, 2)
AXPY_SHAPES = ((26, 196_749), (13, 196_749), (26, 1_055_668))
MATVEC_GROUP = (4, 8, 16)
MATVEC_TURN_BYTES = (32, 64, 128)


def sweep_axpy(libs):
    """libs: {rows per group: library}."""
    rng = np.random.default_rng(SEED)
    good = True
    for k, n in AXPY_SHAPES:
        V = kernels.pitched_basis(k, n, torch.float32, "cuda")
        V.copy_(seeded(rng, (k, n)))
        w = seeded(rng, (n,))
        c = seeded(rng, (k,), dtype=torch.float64)
        c32 = c.float()
        twin = kernels.basis_axpy_plain(c, V, w)
        out = torch.empty_like(w)
        lib_ms = median_ms(lambda: torch.addmv(w, V.T, c32, alpha=-1), 20)
        print(f"[axpy] ({k}, {n}), pitch {V.stride(0)}: torch.addmv "
              f"{lib_ms:.4f} ms; bytes bound "
              f"{1e3 * (4 * k * n + 8 * n) / 3.35e12:.4f} ms")
        for rows, lib in libs.items():
            for threads in AXPY_THREADS:
                for pieces in AXPY_PIECES:
                    nblocks = max(1, -(-(n + 3) // 4 // (threads * pieces)))

                    def fn():
                        rc = lib.pd_basis_axpy(ptr(c), ptr(V), V.stride(0),
                                               ptr(w), k, n, nblocks, threads,
                                               ptr(out), 0, stream(V))
                        assert rc == 0, rc
                    fn()
                    torch.cuda.synchronize()
                    ok = torch.equal(out, twin)
                    print(f"[axpy]   rows {rows:2d} threads {threads:3d} "
                          f"pieces {pieces} blocks {nblocks:5d}: "
                          f"{median_ms(fn, 20):.4f} ms, bit-equal {ok}")
                    good &= ok
        del V, w
    return good


def sweep_matvec3d(libs):
    """libs: {(group, turn bytes): library}."""
    cfg = pkg.Config.load(FLAGSHIP)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                              device="cuda")
    rng = np.random.default_rng(SEED + 3)
    fluid = st.node_type == 0
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    op = ai.assemble(st, kit)
    x = torch.tensor(rng.random(kit.shape), dtype=torch.float32,
                     device="cuda")
    y = torch.empty_like(x)
    twins = {dtype: kernels.matvec3d_plain(x, op.W.to(dtype), op.diag,
                                           op.unknown, kit)
             for dtype in (torch.float32, torch.bfloat16)}
    ok = True
    z = torch.empty_like(x)

    def other():
        torch.add(x, x, out=z)
    for W, name in ((op.packed, "f32"), (op.W16, "bf16")):
        def wrapper():
            return kernels.matvec3d(x, W, op.diag, op.unknown, kit)
        print(f"[matvec3d] the port's wrapper (the sources' defaults, group "
              f"{W.group}), {name}: {median_ms(wrapper, 10):.4f} ms back to "
              f"back, {apart_ms(wrapper, other):.4f} ms behind another "
              f"kernel")
    for group in sorted({g for g, _ in libs}):
        p32 = kernels.pack_stencil(op.W, op.unknown, kit, group)
        print(f"[matvec3d] group {group}: {grid.N_total} nodes, S={kit.S}, "
              f"{p32.nnz} nonzero weights, {p32.values.numel()} stored")
        for packed, entry in ((p32, "pd_matvec3d_f32"),
                              (p32.to(torch.bfloat16), "pd_matvec3d_bf16")):
            for (g, turn), lib in libs.items():
                if g != group:
                    continue

                def fn():
                    rc = getattr(lib, entry)(
                        ptr(x), ptr(packed.values), ptr(packed.slots),
                        ptr(packed.count), ptr(packed.slice_ptr),
                        ptr(op.diag), ptr(op.unknown), ptr(kit.slot_offsets),
                        kit.S, *kit.shape, group, ptr(y), 0, stream(x))
                    assert rc == 0, rc
                y.zero_()
                fn()
                torch.cuda.synchronize()
                same = torch.equal(y, twins[packed.dtype])
                ok &= same
                print(f"[matvec3d]   {entry} group {group:2d} turn bytes "
                      f"{turn:3d}: {median_ms(fn, 10):.4f} ms back to back, "
                      f"{apart_ms(fn, other):.4f} ms behind another kernel, "
                      f"bit-equal {same}")
    return ok


def print_registers(tag, log, *patterns):
    """The ptxas 'Used N registers' lines of the entry functions whose
    mangled name contains every one of ``patterns``."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line and all(
                p in entry for p in patterns):
            name = entry[entry.find(patterns[0]):][:len(patterns[0]) + 8]
            print(f"[ptxas] {tag}: {name}: {line.split(':', 1)[1].strip()}")


def main():
    if not torch.cuda.is_available():
        print("sweep_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 1
    what = sys.argv[1:] or ["axpy", "matvec3d"]
    print(f"[sweep] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}")
    ok = True
    if "axpy" in what:
        libs = {r: build_library([f"PD_AXPY_ROWS={r}"]) for r in AXPY_ROWS}
        for r, lib in libs.items():
            print_registers(f"rows {r}", lib.log, "axpy_kernel")
        ok &= sweep_axpy({r: lib.lib for r, lib in libs.items()})
    if "matvec3d" in what:
        libs = {(g, t): build_library([f"PD_MATVEC3D_GROUP={g}",
                                       f"PD_MATVEC3D_TURN_BYTES={t}"])
                for g in MATVEC_GROUP for t in MATVEC_TURN_BYTES}
        for (g, t), lib in libs.items():
            print_registers(f"group {g} turn bytes {t}", lib.log,
                            "matvec3d_kernel")
        ok &= sweep_matvec3d({k: lib.lib for k, lib in libs.items()})
    print(f"[sweep] {'ok' if ok else 'FAILED: a variant differs from its twin'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
