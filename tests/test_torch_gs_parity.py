"""gs_parity in the port against the JAX package and the C++ reference.

gs_parity replays the reference's in-place outlet and smoothing sweeps
(boundary.cpp:88-131 and :332-376 under one OpenMP thread) in node order:
the port runs them on the host (``boundary._gs_outlet_bc`` /
``_gs_smooth``) over the tables of ``kit._gs_tables``. Held here:

* the eight tables equal to the JAX kit's, on tests/golden/parity.cfg and
  on the 8,303-node 3D grid of tests/test_pallas_interpret.py;
* one outlet sweep and one smoothing sweep on a seeded state against JAX
  ``_gs_outlet_bc`` / ``_gs_smooth``: float64 to round-off (rtol 1e-14);
  float32 to S units of 2^-24 (XLA does not take a long reduction one add
  at a time, and an f32 sum of up to S terms in another order differs by
  up to S roundings);
* the port's whole float64 parity.cfg run with gs_parity = 1 against the
  C++ reference binary's tests/golden/parity_diagnostics_ref.csv, with
  tests/test_parity.py's gates (solid_nodes exact, time_s 1e-9, the rest
  1e-6 relative). The JAX side of that gate is marked slow; the JAX
  package reproduces the CSV byte for byte, so the CSV stands for it.
"""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import boundary as j_bc
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import boundary as t_bc
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import cli, state_from_numpy

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PARITY = os.path.join(GOLDEN, "parity.cfg")
# tests/test_pallas_interpret.py's 3D geometry
GRID_3D = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
           "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6"]
CASES = {"parity": [], "3d": GRID_3D}
TABLES = ("out_idx", "out_nbr", "out_valid", "smo_idx", "smo_nbr",
          "smo_valid", "smo_near_in", "smo_near_out")


def _kits(case, precision="f64"):
    j, t = JConfig.load(PARITY), TConfig.load(PARITY)
    for c in (j, t):
        c.apply_overrides([*CASES[case], "gs_parity=1",
                           f"precision={precision}"])
    jg = j_build_grid(j)
    return jg, j, j_build_kit(jg, j), t_build_kit(t_build_grid(t), t,
                                                 device="cpu")


@pytest.fixture(scope="module")
def kits():
    return {case: _kits(case) for case in CASES}


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_gs_tables_equal_jax(kits, case, name):
    _, _, jk, tk = kits[case]
    ref = np.asarray(getattr(jk, f"gs_{name}"))
    ours = getattr(tk.gs, name)
    assert ours.dtype == ref.dtype and len(ours) > 0
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gs_sweep_plans_follow_the_tables(kits, case):
    """Each plan lists every swept node once, in the tables' (ascending)
    order, with the neighbours it may read in slot order: every valid one
    for the outlet sweep, the valid ones on the interior side for the
    smoothing."""
    _, _, _, tk = kits[case]
    gs = tk.gs
    if case == "parity":
        assert len(gs.out_idx) == 96     # parity.cfg's OUTLET nodes
    sgn = np.asarray([o[0] for o in tk.offsets])
    for sweep, idx, nbr, use in (
            (gs.outlet, gs.out_idx, gs.out_nbr, gs.out_valid),
            (gs.smooth, gs.smo_idx, gs.smo_nbr,
             gs.smo_valid & ((gs.smo_near_out[:, None] & (sgn < 0))
                             | (gs.smo_near_in[:, None] & (sgn > 0))))):
        band = sweep.band.numpy()
        np.testing.assert_array_equal(band[[i for i, _ in sweep.nodes]], idx)
        np.testing.assert_array_equal(band[sweep.swept.numpy()], idx)
        for (_, js), row, ok in zip(sweep.nodes, nbr, use):
            np.testing.assert_array_equal(band[list(js)], row[ok])


def _states(case, precision, seed):
    """JAX and port states from one seeded perturbation of the initial
    fields: rho and vel on FLUID, C everywhere, and a few OUTLET-band
    FLUID nodes made SOLID so the sweeps meet every neighbour type."""
    jg, j, jk, tk = _kits(case, precision)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.array(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(seed)
    nt = host["node_type"]
    fluid = nt == 0
    host["rho"] = np.where(fluid, host["rho"] + rng.normal(0, 1.0, nt.shape),
                           host["rho"])
    host["vel"] = host["vel"] + rng.normal(0, 0.1, host["vel"].shape)
    host["C"] = rng.random(nt.shape)
    flip = fluid & (rng.random(nt.shape) < 0.1)
    host["node_type"] = np.where(flip, np.uint8(1), nt)
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy(host, dtype=tk.dtype, device="cpu")
    return jk, js, tk, ts


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gs_sweeps_equal_jax(case, precision):
    jk, js, tk, ts = _states(case, precision, seed=5)
    rtol = 1e-14 if precision == "f64" else tk.S * 2.0**-24
    jo = jax.jit(lambda s: j_bc._gs_outlet_bc(s, jk))(js)
    to = t_bc.apply_outlet_bc(ts, tk)
    for f in ("rho", "vel", "C"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), rtol=rtol,
                                   atol=0.0, err_msg=f"outlet {f}")
    # the sweep is sequential: some outlet node read a value written
    # earlier in the same sweep (a snapshot sweep would differ)
    snap = dataclasses.replace(tk, gs=None)
    assert not torch.equal(t_bc.apply_outlet_bc(ts, snap).C, to.C)

    jsm = jax.jit(lambda s: j_bc._gs_smooth(s, jk))(js)
    tsm = t_bc.smooth_boundary_concentration(ts, tk)
    np.testing.assert_allclose(tsm.C.numpy(), np.asarray(jsm.C), rtol=rtol,
                               atol=0.0)
    assert not torch.equal(tsm.C, ts.C)


@pytest.fixture
def keep_the_heap():
    """The plain twins allocate and free MB-sized temporaries in every flow
    iteration; by default glibc hands the heap's top back to the system
    each time and faults the pages in again, which took half of this
    run's 40,600 iterations. Keep the heap (glibc's mallopt; elsewhere a
    no-op): the same arithmetic, about half the time."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD
    mallopt(-3, 1 << 25)    # M_MMAP_THRESHOLD (glibc's largest)


def test_gs_parity_run_matches_reference_binary(tmp_path, keep_the_heap):
    """North-star gate 1: the port's f64 parity.cfg run with gs_parity = 1
    (the CLI on the CPU) against the C++ reference binary's diagnostics."""
    out = tmp_path / "out"
    solver = cli.run([PARITY, f"output_dir={out}", "precision=f64",
                      "gs_parity=1", "implicit_output_every=1000000000",
                      "--device", "cpu"])
    ref = np.atleast_1d(np.genfromtxt(
        os.path.join(GOLDEN, "parity_diagnostics_ref.csv"), delimiter=",",
        names=True))
    ours = np.atleast_1d(np.genfromtxt(f"{out}/diagnostics.csv",
                                       delimiter=",", names=True))
    assert solver.total_dissolved == 180
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    np.testing.assert_allclose(ours["time_s"], ref["time_s"], rtol=1e-9)
    for col in ("pin_mass_loss_pct", "v_max", "C_max_fluid"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=1e-6,
                                   err_msg=col)
