"""The port's slot-chunked and j-static 3D NS steps (``kernels.ns3d_chunked``
in its three forms and ``kernels.ns3d_jstat``, plain twins on the CPU)
against the functions of ``scripts/exp_ns3d_chunked.py`` itself, on the
8,303-node 3D grid of tests/test_pallas_interpret.py (S = 178).

The script is imported from its path, unchanged; its kernels are TPU
Pallas kernels with DMA copies and semaphores, so ``pl.pallas_call`` is
wrapped (``monkeypatch``) to run them in the TPU interpreter
(``interpret=pltpu.InterpretParams()``). Tolerances: rho within 1 ulp
(measured: 0 in the chunked XLA and factored forms, 1 in jconv and
jstat), vel rtol 1e-5 atol 1e-9 (measured: at most 1.0e-7 of max |v|): the
interpreter's XLA may fuse a multiply-add that the port rounds twice."""

import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.ops import ns as j_ns
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import kernels, state_from_numpy
from pd_mg_pin_corrosion_tpu_torch import kit as t_kit_mod
from pd_mg_pin_corrosion_tpu_torch.ops import ns as t_ns

torch.set_num_threads(2)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "exp_ns3d_chunked.py")
# tests/test_pallas_interpret.py's 3D geometry
GEOMETRY = ["dim=3", "dx=8e-6", "R_wire=16e-6", "L_wire=64e-6",
            "R_tube=48e-6", "L_upstream=32e-6", "L_downstream=32e-6",
            "precision=f32"]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_ns3d_chunked", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


@pytest.fixture(scope="module")
def states():
    """JAX and port (kit, state, dt) from one seeded f32 state."""
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.apply_overrides(GEOMETRY)
    jg = j_build_grid(j)
    jk, tk = j_build_kit(jg, j), t_build_kit(t_build_grid(t), t)
    js = j_initialize_state(jg, j, dtype=jk.jdtype)
    host = {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}
    rng = np.random.default_rng(9)
    fluid = host["node_type"] == 0
    host["rho"] = np.where(fluid, host["rho"] + rng.normal(0, 0.1, fluid.shape),
                           host["rho"])
    host["vel"] = np.where(fluid[..., None],
                           host["vel"] + rng.normal(0, 0.05, fluid.shape + (3,)),
                           host["vel"])
    js = type(js)(**{k: jnp.asarray(v, getattr(js, k).dtype)
                     for k, v in host.items()})
    ts = state_from_numpy(host, dtype=tk.dtype)
    dt = j_ns.compute_dt(js, jk)
    return jk, js, tk, ts, dt, torch.tensor(float(dt), dtype=torch.float32)


@pytest.mark.parametrize("nchunk", [2, 4, 6, 8])
def test_group_chunks_equal_the_script(script, states, nchunk):
    jk, _, tk, *_ = states
    chunks = kernels.group_chunks(tk, nchunk)
    assert chunks == script._group_chunks(jk, nchunk)
    # the chunks, in order, are the kit's ns_slots order
    order = [(dk, dj, di) for chunk in chunks for (dj, di), slots in chunk
             for dk, *_ in slots]
    np.testing.assert_array_equal(tk.ns_offsets.numpy(), order)


def test_compute_actconv_equals_the_script(script, states):
    jk, js, tk, ts, *_ = states
    np.testing.assert_array_equal(
        kernels.compute_actconv(tk, ts.node_type).numpy(),
        np.asarray(script.compute_actconv(jk, js.node_type)))


# (form, the script's call, the port's call) with the script's defaults:
# ns_step_chunked BZ=16 NCHUNK=6, ns_step_jstat BZ=8 NCHUNK=2
FORMS = {
    "xla": (lambda m, js, jk, dt: m.ns_step_chunked(js, jk, dt,
                                                    factored=False),
            dict(factored=False)),
    "factored": (lambda m, js, jk, dt: m.ns_step_chunked(js, jk, dt),
                 dict(factored=True)),
    "jconv": (lambda m, js, jk, dt: m.ns_step_chunked(js, jk, dt,
                                                      factored="jconv"),
              dict(factored="jconv")),
    "jstat": (lambda m, js, jk, dt: m.ns_step_jstat(
        js, jk, dt, m.compute_actconv(jk, js.node_type)), dict(nchunk=2)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_twin_matches_the_script(script, states, interpret, form):
    jk, js, tk, ts, jdt, dt = states
    ref = FORMS[form][0](script, js, jk, jdt)
    p = t_ns.tait_pressure(ts.rho, tk)
    args = (ts.rho, ts.vel, p, ts.node_type, dt, tk)
    kw = FORMS[form][1]
    if form == "jstat":
        actconv = kernels.compute_actconv(tk, ts.node_type)
        rho, vel = kernels.ns3d_jstat(*args, actconv, **kw)
        twin = kernels.ns3d_jstat_plain(*args, actconv, **kw)
    else:
        rho, vel = kernels.ns3d_chunked(*args, **kw)
        twin = kernels.ns3d_chunked_plain(*args, **kw)
    # CPU tensors: the wrapper is the twin and launches nothing
    assert torch.equal(rho, twin[0]) and torch.equal(vel, twin[1])
    assert sum(kernels.launch_counts()[k] for k in (
        "ns3d_chunked_xla", "ns3d_chunked_factored", "ns3d_chunked_jconv",
        "ns3d_jstat")) == 0
    np.testing.assert_array_max_ulp(rho.numpy(), np.asarray(ref.rho), 1)
    np.testing.assert_allclose(vel.numpy(), np.asarray(ref.vel), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(t_ns.tait_pressure(ts.rho, tk).numpy(),
                               np.asarray(ref.pressure), rtol=1e-6)
    assert not torch.equal(rho, ts.rho)


def test_chunking_sets_the_numbers_and_slot_ranges_do_not(states,
                                                          monkeypatch):
    """One chunk of the j-static form with the kit's pure-act sums is ns3d's
    act-static step, bit for bit; the twins' slot ranges (a memory bound)
    do not change the bits."""
    _, _, tk, ts, _, dt = states
    p = t_ns.tait_pressure(ts.rho, tk)
    args = (ts.rho, ts.vel, p, ts.node_type, dt, tk)
    one = kernels.ns3d_jstat_plain(*args, tk.actconv3d, nchunk=1)
    ref = kernels.ns3d_plain(*args)
    assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])
    whole = [kernels.ns3d_chunked_plain(*args, nchunk=4, factored=f)
             for f in (False, True, "jconv")]
    monkeypatch.setattr(t_kit_mod, "SLOT_CHUNK_ELEMS", 7 * 8303)
    for f, w in zip((False, True, "jconv"), whole):
        r, v = kernels.ns3d_chunked_plain(*args, nchunk=4, factored=f)
        assert torch.equal(r, w[0]) and torch.equal(v, w[1])
    with pytest.raises(KeyError):
        kernels.ns3d_chunked(*args, factored="other")
