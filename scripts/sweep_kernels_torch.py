#!/usr/bin/env python3
"""Sweep the free parameters of the port's basis_axpy, basis_dots, matvec3d
(with slots3d_f64, which walks its packed f32 layout), ns3d, ns2d, ard2d and
ns3d_chunked kernels on one CUDA device.

    python3 scripts/sweep_kernels_torch.py [axpy] [dots] [matvec3d] [ns3d]
                                           [ns2d] [ard2d] [ns3d_chunked]

The kernels' compile-time constants (``PD_AXPY_ROWS``: rows per register
group of basis_axpy; ``PD_DOTS_UNROLL``, ``PD_DOTS_STREAM``: pieces a lane
of basis_dots loads ahead, and whether it reads the basis with evict-first
loads; ``PD_MATVEC3D_GROUP``:
weights of a row stored side by side in matvec3d's packed layout;
``PD_MATVEC3D_TURN_BYTES``: bytes of weights a thread loads per full turn
of its row walk; ``PD_NS3D_R``, ``_TX``, ``_TY``, ``_ZT``, ``_WX``,
``_PAD``, ``_BLOCKS``: ns3d's z nodes a thread, tile, warp shape, row
padding and blocks an SM; ``PD_NS2D_R``, ``_TX``, ``_TY``, ``_WX``,
``_PAD``, ``_BLOCKS``: the same of ns2d, x nodes a thread; ``PD_ARD2D_R``,
``_TX``, ``_TY``, ``_WX``, ``_PAD``, ``_BLOCKS``: the same of ard2d;
``PD_NS3DC_R_XLA``, ``_R_FACTORED``, ``_R_JCONV``, ``_R_JSTAT``,
``_UNROLL``, ``_TX_<BZ>``, ``_TY_<BZ>``, ``_ZT_<BZ>``: ns3d_chunked's z
nodes a thread per form, staged positions a thread loads at once and, per
BZ rung, cross-section and threads along z) are ``#ifndef``
macros in csrc/; this script
builds one library per value (``kernels.build.build_library``), calls the C
entry points directly, holds every variant to the plain twin (bit for bit;
basis_dots to rtol 2e-6), and prints median times (chip_smoke.py's
protocol: CUDA events around back-to-back calls behind a spin kernel; for
matvec3d, slots3d_f64, ns3d, ns2d, ard2d and ns3d_chunked also one call at
a time behind another kernel; the variants' libraries are built four at a
time):

* axpy: rows per group x threads per block x 4-element pieces per thread,
  at (26, 196,749), (13, 196,749) and (26, 1,055,668), rows 128-byte
  aligned, beside ``torch.addmv`` on the same tensors;
* dots: pieces ahead x evict-first x threads per block x blocks an SM x
  items a warp, at
  (26, 196,749), (26, 1,055,668), (13, 1,055,668) and the k = 1 self-dot of
  1,055,668 floats, beside ``torch.mv``;
* ns3d: tile shape x z nodes a thread x blocks an SM (``NS3D_VARIANTS``) on
  the seeded state of config/params_3d.cfg;
* ns2d: tile shape x x nodes a thread x warp shape x row padding x blocks
  an SM (``NS2D_VARIANTS``) on the seeded state of
  config/params_fine_calibration.cfg (567 x 347 nodes, S = 36);
* ard2d: tile shape x x nodes a thread x warp shape (``ARD2D_VARIANTS``)
  on chip_smoke.py's seeded explicit-step inputs at the fine-calibration
  grid (some SOLID nodes salt-blocked);
* ns3d_chunked: nodes a thread x cross-section and threads per BZ
  (``NS3DC_VARIANTS``), each of the four forms at every rung (NCHUNK 6),
  on the seeded state of config/params_3d.cfg;
* matvec3d: group size x bytes per turn, packed f32 and bf16 weights, and
  slots3d_f64 over the packed f32 weights, on the assembled operator of
  config/params_3d.cfg (1,055,668 nodes, S = 178), each group size with
  its own packing.

The port's wrappers use the values the sources default to. Needs a CUDA
device; imports nothing of JAX.
"""

import concurrent.futures
import itertools
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pd_mg_pin_corrosion_tpu_torch as pkg  # noqa: E402
from chip_smoke import (FINE, FLAGSHIP, SEED, apart_ms,  # noqa: E402
                        median_ms, nvidia_smi, seeded)
from pd_mg_pin_corrosion_tpu_torch import grains, kernels  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch.kernels.build import (  # noqa: E402
    build_library, ptr, stream)
from pd_mg_pin_corrosion_tpu_torch.ops import ard_implicit as ai  # noqa: E402

AXPY_ROWS = (4, 8, 13)
AXPY_THREADS = (64, 128, 256)
AXPY_PIECES = (1, 2)
AXPY_SHAPES = ((26, 196_749), (13, 196_749), (26, 1_055_668))
# (pieces a lane loads ahead, evict-first loads of the basis: 0 never, 1
# always)
DOTS_BUILDS = ((2, 0), (4, 0), (8, 0), (2, 1), (4, 1))
DOTS_THREADS = (256, 512, 1024)
DOTS_BLOCKS_PER_SM = (1, 2, 4)
DOTS_ITEMS = (1, 2)   # (row, part) items a warp, about
DOTS_SHAPES = ((26, 196_749), (26, 1_055_668), (13, 1_055_668),
               (1, 1_055_668), (1, 196_749))   # k = 1: the self-dot
# (R, TX, TY, ZT, WX, PAD, BLOCKS); the first is the source's default
NS3D_VARIANTS = ((4, 16, 8, 2, 8, 2, 2), (2, 16, 8, 2, 8, 2, 3),
                 (2, 16, 8, 4, 8, 2, 2), (3, 16, 8, 2, 8, 2, 2),
                 (4, 16, 8, 2, 16, 2, 2), (4, 32, 4, 2, 32, 0, 2),
                 (4, 16, 8, 4, 8, 2, 1), (8, 16, 8, 1, 8, 2, 2),
                 (4, 8, 8, 2, 8, 2, 4), (4, 16, 4, 2, 8, 2, 3))
NS3D_KEYS = ("R", "TX", "TY", "ZT", "WX", "PAD", "BLOCKS")
# (R, TX, TY, WX, PAD, BLOCKS); the first is the source's default
NS2D_VARIANTS = ((2, 32, 16, 16, 1, 3), (2, 32, 16, 16, 0, 3),
                 (2, 16, 16, 8, 1, 6), (2, 32, 8, 16, 1, 6),
                 (4, 32, 16, 8, 1, 3), (4, 32, 16, 8, 0, 3),
                 (4, 32, 16, 4, 1, 3), (4, 64, 16, 16, 1, 2),
                 (3, 48, 16, 16, 1, 3), (1, 32, 8, 32, 1, 4),
                 (1, 32, 16, 32, 1, 2))
NS2D_KEYS = ("R", "TX", "TY", "WX", "PAD", "BLOCKS")
# (R, TX, TY, WX, PAD, BLOCKS) of ard2d; the first is the source's default
ARD2D_VARIANTS = ((2, 32, 16, 16, 1, 3), (1, 32, 16, 32, 1, 2),
                  (1, 32, 8, 32, 1, 4), (4, 32, 16, 8, 1, 3),
                  (4, 64, 16, 16, 1, 3), (2, 16, 16, 8, 1, 6),
                  (2, 32, 8, 16, 1, 6), (2, 64, 16, 32, 1, 2),
                  (4, 32, 32, 8, 1, 2))
ARD2D_KEYS = ("R", "TX", "TY", "WX", "PAD", "BLOCKS")
# (R of the XLA, factored, jconv and jstat forms, UNROLL, then per rung BZ
# = 8, 16, 32: TX, TY, ZT) of ns3d_chunked; the first is the source's
# default
NS3DC_VARIANTS = ((2, 2, 2, 4, 4, 16, 8, 2, 8, 8, 4, 8, 8, 8),
                  (2, 2, 2, 2, 4, 16, 8, 2, 8, 8, 4, 8, 8, 8),
                  (1, 2, 2, 4, 4, 16, 8, 2, 8, 8, 4, 8, 8, 8),
                  (2, 4, 4, 4, 4, 16, 8, 2, 8, 8, 4, 8, 8, 8),
                  (2, 2, 2, 4, 1, 16, 8, 2, 8, 8, 4, 8, 8, 8),
                  (2, 2, 2, 4, 4, 16, 8, 2, 16, 8, 4, 8, 8, 8),
                  (2, 2, 2, 4, 4, 16, 8, 2, 8, 8, 4, 8, 8, 4))
NS3DC_KEYS = ("R_XLA", "R_FACTORED", "R_JCONV", "R_JSTAT", "UNROLL", "TX_8",
              "TY_8", "ZT_8", "TX_16", "TY_16", "ZT_16", "TX_32", "TY_32",
              "ZT_32")
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


def sweep_dots(libs):
    """libs: {(pieces ahead, evict-first): library}."""
    rng = np.random.default_rng(SEED + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    good = True
    for k, n in DOTS_SHAPES:
        w = seeded(rng, (n,))
        if k == 1:
            V = w[None]
        else:
            V = kernels.pitched_basis(k, n, torch.float32, "cuda")
            V.copy_(seeded(rng, (k, n)))
        twin = kernels.basis_dots_plain(V, w)
        out = torch.empty(k, dtype=torch.float64, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        nbytes = 4 * n * (1 if k == 1 else k + 1) + 8 * k
        print(f"[dots] ({k}, {n}){' self-dot' if k == 1 else ''}: torch.mv "
              f"{median_ms(lambda: torch.mv(V, w), 20):.4f} ms; the port's "
              f"wrapper {median_ms(lambda: kernels.basis_dots(V, w), 20):.4f}"
              f" ms; bytes bound {1e3 * nbytes / 3.35e12:.4f} ms")
        for (ahead, evict), lib in libs.items():
            for threads, per_sm, items in itertools.product(
                    DOTS_THREADS, DOTS_BLOCKS_PER_SM, DOTS_ITEMS):
                if threads * per_sm > 2048:
                    continue
                parts = max(1, -(-items * (threads // 32) // k))
                nblocks = min(sms * per_sm, -(-n // 4))
                partial = torch.empty(k * nblocks, dtype=torch.float64,
                                      device="cuda")

                def fn():
                    rc = lib.pd_basis_dots(
                        ptr(V), V.stride(0) if k > 1 else n, ptr(w), k, n,
                        nblocks, threads, parts, ptr(partial), ptr(ticket),
                        ptr(out), 0, stream(V))
                    assert rc == 0, rc
                fn()
                torch.cuda.synchronize()
                ok = torch.allclose(out, twin, rtol=2e-6, atol=0.0)
                print(f"[dots]   ahead {ahead} evict-first {evict} threads "
                      f"{threads:4d} blocks {nblocks:4d} parts {parts:2d}: "
                      f"{median_ms(fn, 20, reps=5):.4f} ms, "
                      f"within rtol 2e-6 {ok}")
                good &= ok
        del V, w
    return good


def flagship_state(seed):
    """(cfg, grid, kit, state) of config/params_3d.cfg on the card, the
    FLUID nodes' rho and vel perturbed from ``seed``."""
    cfg = pkg.Config.load(FLAGSHIP)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                              device="cuda")
    rng = np.random.default_rng(seed)
    fluid = st.node_type == 0
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    return cfg, grid, kit, st


def sweep_ns3d(libs):
    """libs: {variant tuple: library}."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.ns3d import _constants
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    _, grid, kit, st = flagship_state(SEED + 3)
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    twin = kernels.ns3d_plain(*args)
    consts = _constants(kit)
    rho_out, vel_out = torch.empty_like(st.rho), torch.empty_like(st.vel)
    z = torch.empty_like(st.vel)

    def other():
        torch.add(st.vel, st.vel, out=z)

    def wrapper():
        return kernels.ns3d(*args)
    print(f"[ns3d] {grid.N_total} nodes, S={kit.S}; the port's wrapper (the "
          f"sources' defaults): {median_ms(wrapper, 10):.4f} ms back to back, "
          f"{apart_ms(wrapper, other):.4f} ms behind another kernel")
    good = True
    for variant, lib in libs.items():
        geo = kernels.ns3d_geometry(lib)
        tab = kernels.ns3d_tables(kit, geo.pitch, geo.plane)
        _, busy, staged, halo = kernels.ns3d_staging(kit, st.node_type, geo)

        def fn():
            rc = lib.pd_ns3d(
                ptr(st.rho), ptr(st.vel), ptr(p), ptr(st.node_type), ptr(dt),
                ptr(tab.offsets), ptr(tab.coefs), ptr(tab.runs),
                ptr(kit.actconv3d), kit.S, tab.runs.shape[0], *kit.shape,
                *consts, ptr(rho_out), ptr(vel_out), 0, stream(st.rho))
            assert rc == 0, rc
        rho_out.zero_()
        vel_out.zero_()
        fn()
        torch.cuda.synchronize()
        same = torch.equal(rho_out, twin[0]) and torch.equal(vel_out, twin[1])
        good &= same
        print(f"[ns3d]   {dict(zip(NS3D_KEYS, variant))}: tile {geo.tx} x "
              f"{geo.ty} x {geo.tz}, {geo.threads} threads, "
              f"{geo.tile_bytes / 1e3:.1f} KB, {busy} busy tiles, halo factor "
              f"{halo:.2f}, {staged / 1e6:.1f} MB staged: "
              f"{median_ms(fn, 10):.4f} ms back to back, "
              f"{apart_ms(fn, other):.4f} ms behind another kernel, "
              f"bit-equal {same}")
    return good


def sweep_ns2d(libs):
    """libs: {variant tuple: library}."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.ns2d import _constants
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    cfg = pkg.Config.load(FINE)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                              device="cuda")
    rng = np.random.default_rng(SEED)
    fluid = st.node_type == pkg.FLUID
    st.rho = torch.where(fluid, st.rho + seeded(rng, kit.shape, 0.01), st.rho)
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    twin = kernels.ns2d_plain(*args)
    consts = _constants(kit)
    rho_out, vel_out = torch.empty_like(st.rho), torch.empty_like(st.vel)
    z = torch.empty_like(st.vel)

    def other():
        torch.add(st.vel, st.vel, out=z)

    def wrapper():
        return kernels.ns2d(*args)
    print(f"[ns2d] {grid.N_total} nodes, S={kit.S}; the port's wrapper (the "
          f"sources' defaults): {median_ms(wrapper, 20):.4f} ms back to back, "
          f"{apart_ms(wrapper, other):.4f} ms behind another kernel")
    good = True
    for variant, lib in libs.items():
        geo = kernels.ns2d_geometry(lib)
        tab = kernels.ns2d_tables(kit, geo.pitch)
        tiles, busy, staged, halo = kernels.ns2d_staging(kit, st.node_type,
                                                         geo)

        def fn():
            rc = lib.pd_ns2d(
                ptr(st.rho), ptr(st.vel), ptr(p), ptr(st.node_type), ptr(dt),
                ptr(tab.offsets), ptr(tab.coefs), ptr(tab.runs), kit.S,
                tab.runs.shape[0], *kit.shape, *consts, ptr(rho_out),
                ptr(vel_out), 0, stream(st.rho))
            assert rc == 0, rc
        rho_out.zero_()
        vel_out.zero_()
        fn()
        torch.cuda.synchronize()
        same = torch.equal(rho_out, twin[0]) and torch.equal(vel_out, twin[1])
        good &= same
        print(f"[ns2d]   {dict(zip(NS2D_KEYS, variant))}: tile {geo.tx} x "
              f"{geo.ty}, {geo.threads} threads, "
              f"{geo.tile_bytes / 1e3:.1f} KB, {busy} of {tiles} tiles busy, "
              f"halo factor {halo:.2f}, {staged / 1e6:.2f} MB staged: "
              f"{median_ms(fn, 20):.4f} ms back to back, "
              f"{apart_ms(fn, other):.4f} ms behind another kernel, "
              f"bit-equal {same}")
    return good


def sweep_ard2d(libs):
    """libs: {variant tuple: library}. ard2d on chip_smoke.py's inputs:
    the fine-calibration grid with grains, a seeded C (some SOLID nodes
    salt-blocked) and seeded FLUID velocities."""
    from pd_mg_pin_corrosion_tpu_torch.ops import ard as ard_ops
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    cfg = pkg.Config.load(FINE)
    grid = pkg.build_grid(cfg)
    kit = pkg.build_kit(grid, cfg, device="cuda")
    st = pkg.initialize_state(grid, cfg, grains=grains.generate(grid, cfg),
                              device="cuda")
    rng = np.random.default_rng(SEED)
    fluid = st.node_type == pkg.FLUID
    solid = st.node_type == pkg.SOLID_MG
    st.vel = torch.where(fluid[..., None],
                         st.vel + seeded(rng, st.vel.shape, 0.02 * cfg.U_in),
                         st.vel)
    st.C = torch.where(solid, 1.0 - 0.2 * torch.tensor(
        rng.random(kit.shape), dtype=torch.float32, device="cuda"),
        torch.where(fluid, torch.tensor(rng.random(kit.shape),
                                        dtype=torch.float32, device="cuda"),
                    0.0))
    salt = ard_ops.compute_salt_blocked(st, kit)
    Ds = ard_ops.solid_diffusivity(st.is_gb, st.is_precip, cfg,
                                   ard_ops.micro_d_factor(cfg, 0.05,
                                                          kit.dtype, "cuda"))
    vmag = ns.vel_magnitude(st.vel)
    dt = float(ard_ops.compute_dt(st, kit))
    args = (st.C, st.vel, vmag, st.node_type, Ds, salt, dt, kit)
    twin = kernels.ard2d_plain(*args)
    out = torch.empty_like(st.C)
    z = torch.empty_like(st.vel)
    dt_dev = torch.full((), dt, dtype=torch.float32, device="cuda")

    def other():
        torch.add(st.vel, st.vel, out=z)

    def wrapper():
        return kernels.ard2d(*args)
    print(f"[ard2d] {grid.N_total} nodes, S={kit.S}, {int(salt.sum())} of "
          f"{int(solid.sum())} SOLID nodes salt-blocked; the port's wrapper "
          f"(the sources' defaults): {median_ms(wrapper, 20):.4f} ms back to "
          f"back, {apart_ms(wrapper, other):.4f} ms behind another kernel")
    good = True
    for variant, lib in libs.items():
        geo = kernels.ard2d_geometry(lib)
        tab = kernels.ns2d_tables(kit, geo.pitch)
        tiles, busy, staged, halo = kernels.ard2d_staging(kit, st.node_type,
                                                          geo)

        def fn():
            rc = lib.pd_ard2d(
                ptr(st.C), ptr(st.vel), ptr(vmag), ptr(st.node_type), ptr(Ds),
                ptr(salt), ptr(dt_dev), ptr(tab.offsets), ptr(tab.coefs),
                ptr(tab.runs), kit.S, tab.runs.shape[0], *kit.shape,
                kit.beta_lap, cfg.D_liquid, 2.0 * cfg.D_liquid,
                cfg.alpha_art_diff, cfg.dx, kit.alpha / kit.V_H, ptr(out), 0,
                stream(st.C))
            assert rc == 0, rc
        out.zero_()
        fn()
        torch.cuda.synchronize()
        same = torch.equal(out, twin)
        good &= same
        print(f"[ard2d]   {dict(zip(ARD2D_KEYS, variant))}: tile {geo.tx} x "
              f"{geo.ty}, {geo.threads} threads, "
              f"{geo.tile_bytes / 1e3:.1f} KB, {busy} of {tiles} tiles busy, "
              f"halo factor {halo:.2f}, {staged / 1e6:.2f} MB staged: "
              f"{median_ms(fn, 20):.4f} ms back to back, "
              f"{apart_ms(fn, other):.4f} ms behind another kernel, "
              f"bit-equal {same}")
    return good


def sweep_ns3d_chunked(libs):
    """libs: {variant tuple: library}. The four forms at every rung (BZ 8,
    16, 32; NCHUNK 6) on the seeded state of config/params_3d.cfg."""
    from pd_mg_pin_corrosion_tpu_torch.kernels.ns3d import _constants
    from pd_mg_pin_corrosion_tpu_torch.kernels.ns3d_chunked import FORMS
    from pd_mg_pin_corrosion_tpu_torch.ops import ns

    _, grid, kit, st = flagship_state(SEED + 3)
    p = ns.tait_pressure(st.rho, kit)
    dt = ns.compute_dt(st, kit)
    args = (st.rho, st.vel, p, st.node_type, dt, kit)
    actconv = kernels.compute_actconv(kit, st.node_type)
    consts = _constants(kit)
    rho_out, vel_out = torch.empty_like(st.rho), torch.empty_like(st.vel)
    z = torch.empty_like(st.vel)

    def other():
        torch.add(st.vel, st.vel, out=z)
    good = True
    for fi, form in enumerate(FORMS):
        if form == "jstat":
            twin = kernels.ns3d_jstat_plain(*args, actconv, nchunk=6)
        else:
            twin = kernels.ns3d_chunked_plain(
                *args, nchunk=6,
                factored={"xla": False, "factored": True,
                          "jconv": "jconv"}[form])
        for bz in kernels.BZ_RUNGS:
            for variant, lib in libs.items():
                geo = kernels.ns3d_chunked_geometry(form, bz, lib)
                tab = kernels.ns3d_chunked_tables(kit, form, 6, geo.pitch,
                                                  geo.plane)
                _, busy, staged, halo = kernels.ns3d_staging(
                    kit, st.node_type, geo)

                def fn():
                    rc = lib.pd_ns3d_chunked(
                        fi, ptr(st.rho), ptr(st.vel), ptr(p),
                        ptr(st.node_type),
                        ptr(actconv) if form == "jstat" else None, ptr(dt),
                        ptr(tab.offsets), ptr(tab.coefs), ptr(tab.runs),
                        ptr(tab.chunk_end), 6, kit.S, tab.runs.shape[0],
                        *kit.shape, bz, *consts, ptr(rho_out), ptr(vel_out),
                        0, stream(st.rho))
                    assert rc == 0, rc
                rho_out.zero_()
                vel_out.zero_()
                fn()
                torch.cuda.synchronize()
                same = (torch.equal(rho_out, twin[0])
                        and torch.equal(vel_out, twin[1]))
                good &= same
                print(f"[ns3d_chunked]   {form} BZ {bz} "
                      f"{dict(zip(NS3DC_KEYS, variant))}: tile {geo.tx} x "
                      f"{geo.ty} x {geo.tz}, R {geo.r}, {geo.threads} "
                      f"threads, {geo.tile_bytes / 1e3:.1f} KB, {busy} busy "
                      f"tiles, halo factor {halo:.2f}, {staged / 1e6:.1f} MB "
                      f"staged: {median_ms(fn, 10):.4f} ms back to back, "
                      f"{apart_ms(fn, other):.4f} ms behind another kernel, "
                      f"bit-equal {same}")
    return good


def sweep_matvec3d(libs):
    """libs: {(group, turn bytes): library}."""
    _, grid, kit, st = flagship_state(SEED + 3)
    op = ai.assemble(st, kit)
    W = ai._dense_operator(st, kit, 0.0)[0]   # the card's op keeps none
    x = torch.tensor(np.random.default_rng(SEED + 4).random(kit.shape),
                     dtype=torch.float32, device="cuda")
    x64 = x.double()
    y = torch.empty_like(x)
    y64 = torch.empty_like(x64)
    twins = {dtype: kernels.matvec3d_plain(x, W.to(dtype), op.diag,
                                           op.unknown, kit)
             for dtype in (torch.float32, torch.bfloat16)}
    twin64 = kernels.slots3d_f64_plain(x64, W, kit)
    ok = True
    z = torch.empty_like(x)

    def other():
        torch.add(x, x, out=z)
    for packed, name in ((op.packed, "f32"), (op.W16, "bf16")):
        def wrapper():
            return kernels.matvec3d(x, packed, op.diag, op.unknown, kit)
        print(f"[matvec3d] the port's wrapper (the sources' defaults, group "
              f"{packed.group}), {name}: {median_ms(wrapper, 10):.4f} ms "
              f"back to back, {apart_ms(wrapper, other):.4f} ms behind "
              f"another kernel")

    def slots_wrapper():
        return kernels.slots3d_f64(x64, op.packed, kit)
    print(f"[matvec3d] the port's slots3d_f64 wrapper: "
          f"{median_ms(slots_wrapper, 10):.4f} ms back to back, "
          f"{apart_ms(slots_wrapper, other):.4f} ms behind another kernel")
    for group in sorted({g for g, _ in libs}):
        p32 = kernels.pack_stencil(W, op.unknown, kit, group)
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
        for (g, turn), lib in libs.items():
            if g != group:
                continue

            def fn():
                rc = lib.pd_slots3d_f64(
                    ptr(x64), ptr(p32.values), ptr(p32.slots),
                    ptr(p32.count), ptr(p32.slice_ptr), ptr(kit.slot_offsets),
                    kit.S, *kit.shape, group, ptr(y64), 0, stream(x64))
                assert rc == 0, rc
            y64.zero_()
            fn()
            torch.cuda.synchronize()
            same = torch.equal(y64, twin64)
            ok &= same
            print(f"[matvec3d]   pd_slots3d_f64 group {group:2d} turn bytes "
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


def build_all(defines, workers=4):
    """build_library for each list of defines, ``workers`` at a time."""
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(build_library, defines))


def main():
    if not torch.cuda.is_available():
        print("sweep_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 1
    what = sys.argv[1:] or ["axpy", "dots", "matvec3d", "ns3d", "ns2d",
                            "ard2d", "ns3d_chunked"]
    print(f"[sweep] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}")
    ok = True
    if "axpy" in what:
        libs = {r: build_library([f"PD_AXPY_ROWS={r}"]) for r in AXPY_ROWS}
        for r, lib in libs.items():
            print_registers(f"rows {r}", lib.log, "axpy_kernel")
        ok &= sweep_axpy({r: lib.lib for r, lib in libs.items()})
    if "dots" in what:
        libs = {(a, e): build_library([f"PD_DOTS_UNROLL={a}",
                                       f"PD_DOTS_STREAM={e}"])
                for a, e in DOTS_BUILDS}
        for (a, e), lib in libs.items():
            print_registers(f"ahead {a} evict-first {e}", lib.log,
                            "dots_kernel")
        ok &= sweep_dots({v: lib.lib for v, lib in libs.items()})
    if "ns3d" in what:
        libs = {v: build_library([f"PD_NS3D_{k}={x}"
                                  for k, x in zip(NS3D_KEYS, v)])
                for v in NS3D_VARIANTS}
        for v, lib in libs.items():
            print_registers(" ".join(map(str, v)), lib.log, "ns3d_kernel")
        ok &= sweep_ns3d({v: lib.lib for v, lib in libs.items()})
    if "ns2d" in what:
        libs = {v: build_library([f"PD_NS2D_{k}={x}"
                                  for k, x in zip(NS2D_KEYS, v)])
                for v in NS2D_VARIANTS}
        for v, lib in libs.items():
            print_registers(" ".join(map(str, v)), lib.log, "ns2d_kernel")
        ok &= sweep_ns2d({v: lib.lib for v, lib in libs.items()})
    if "ard2d" in what:
        libs = build_all([f"PD_ARD2D_{k}={x}" for k, x in zip(ARD2D_KEYS, v)]
                         for v in ARD2D_VARIANTS)
        libs = dict(zip(ARD2D_VARIANTS, libs))
        for v, lib in libs.items():
            print_registers(" ".join(map(str, v)), lib.log, "ard2d_kernel")
        ok &= sweep_ard2d({v: lib.lib for v, lib in libs.items()})
    if "ns3d_chunked" in what:
        libs = build_all([f"PD_NS3DC_{k}={x}" for k, x in zip(NS3DC_KEYS, v)]
                         for v in NS3DC_VARIANTS)
        libs = dict(zip(NS3DC_VARIANTS, libs))
        for v, lib in libs.items():
            print_registers(" ".join(map(str, v)), lib.log,
                            "ns3d_chunked_kernel")
        ok &= sweep_ns3d_chunked({v: lib.lib for v, lib in libs.items()})
    if "matvec3d" in what:
        libs = {(g, t): build_library([f"PD_MATVEC3D_GROUP={g}",
                                       f"PD_MATVEC3D_TURN_BYTES={t}"])
                for g in MATVEC_GROUP for t in MATVEC_TURN_BYTES}
        for (g, t), lib in libs.items():
            print_registers(f"group {g} turn bytes {t}", lib.log,
                            "stencil_kernel")
        ok &= sweep_matvec3d({k: lib.lib for k, lib in libs.items()})
    print(f"[sweep] {'ok' if ok else 'FAILED: a variant differs from its twin'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
