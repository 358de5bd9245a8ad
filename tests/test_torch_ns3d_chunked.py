"""The port's slot-chunked and j-static 3D NS steps (``kernels.ns3d_chunked``
in its three forms and ``kernels.ns3d_jstat``, plain twins on the CPU)
against the functions of ``scripts/exp_ns3d_chunked.py`` itself, on the
8,303-node 3D grid of tests/test_pallas_interpret.py (S = 178); and what
the staged CUDA kernel rests on: its slot table (``ns3d_chunked_tables``)
and its walk in PyTorch (``ns3d_chunked_staged_plain``), bit for bit
against each form's twin for nchunk 2, 4, 6 and 8 on the tiles of the
ladder's BZ rungs and on the whole grid.

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
    jk, tk = j_build_kit(jg, j), t_build_kit(t_build_grid(t), t, device="cpu")
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
    ts = state_from_numpy(host, dtype=tk.dtype, device="cpu")
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
    # the kernel's walk in PyTorch is the twin, bit for bit
    staged = kernels.ns3d_chunked_staged_plain(
        form, *args, actconv=actconv if form == "jstat" else None,
        **{k: v for k, v in kw.items() if k == "nchunk"})
    assert torch.equal(staged[0], rho) and torch.equal(staged[1], vel)
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


def _form_args(states, form):
    _, _, tk, ts, _, dt = states
    p = t_ns.tait_pressure(ts.rho, tk)
    args = (ts.rho, ts.vel, p, ts.node_type, dt, tk)
    actconv = (kernels.compute_actconv(tk, ts.node_type) if form == "jstat"
               else None)
    return args, actconv


def _twin(form, args, actconv, nchunk):
    if form == "jstat":
        return kernels.ns3d_jstat_plain(*args, actconv, nchunk=nchunk)
    return kernels.ns3d_chunked_plain(
        *args, nchunk=nchunk,
        factored={"xla": False, "factored": True, "jconv": "jconv"}[form])


# (tz, ty, tx): the csrc defaults' tiles of the BZ = 8, 16 and 32 rungs (the
# 23 x 19 x 19 grid is no multiple of any), and one tile that holds the grid
STAGED_TILES = [(8, 8, 16), (16, 8, 16), (32, 8, 8), None]


@pytest.mark.parametrize("tile", STAGED_TILES,
                         ids=["bz8", "bz16", "bz32", "whole"])
@pytest.mark.parametrize("nchunk", [2, 4, 6, 8])
@pytest.mark.parametrize("form", ["xla", "factored", "jconv", "jstat"])
def test_staged_walk_equals_the_twin_bit_for_bit(states, form, nchunk, tile):
    args, actconv = _form_args(states, form)
    R = 1 if form == "xla" else 2
    twin = _twin(form, args, actconv, nchunk)
    rho, vel = kernels.ns3d_chunked_staged_plain(
        form, *args, nchunk=nchunk, actconv=actconv, R=R, tile=tile)
    assert torch.equal(rho.view(torch.int32), twin[0].view(torch.int32))
    assert torch.equal(vel.view(torch.int32), twin[1].view(torch.int32))


@pytest.mark.parametrize("R", [1, 2, 4])
def test_staged_walk_holds_for_any_nodes_a_thread(states, R):
    """Nodes a thread do not enter a node's sum; the chunking does."""
    args, _ = _form_args(states, "factored")
    twin = _twin("factored", args, None, 6)
    rho, vel = kernels.ns3d_chunked_staged_plain(
        "factored", *args, nchunk=6, R=R, tile=(8, 8, 8))
    assert torch.equal(rho, twin[0]) and torch.equal(vel, twin[1])
    other = _twin("factored", args, None, 2)
    assert not (torch.equal(rho, other[0]) and torch.equal(vel, other[1]))


@pytest.mark.parametrize("nchunk", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("form", ["xla", "jstat"])
def test_chunked_tables_hold_the_kits_slots(states, form, nchunk):
    _, _, tk, *_ = states
    pitch, plane = 24, 24 * 14
    tab = kernels.ns3d_chunked_tables(tk, form, nchunk, pitch, plane)
    S = tk.S
    assert tab.offsets.dtype == torch.int32 and tab.offsets.shape == (S,)
    # a slot's offset decodes to its (dk, dj, di) plus the halo
    off = tab.offsets.long()
    decoded = torch.stack([off // plane, off % plane // pitch, off % pitch],
                          1) - 3
    assert torch.equal(decoded, tk.ns_offsets.long())
    # runs: dk steps by one inside, (dj, di) fixed; 38 at S = 178
    first, length = tab.runs[:, 0].long(), tab.runs[:, 1].long()
    assert int(length.sum()) == S and tab.runs.shape[0] == 38
    # each chunk ends where a run does, at the group boundary of
    # group_chunks, the last at the last run
    ends = tab.chunk_end.long()
    assert tab.chunk_end.shape == (nchunk,) and int(ends[-1]) == 38
    slot_ends = [sum(len(g) for _, g in c) for c in kernels.group_chunks(
        tk, nchunk)]
    assert (torch.cat([first, torch.tensor([S])])[ends].tolist()
            == np.cumsum(slot_ends).tolist())
    # the coefficients, a slot's side by side
    rows = [tk.dist[s] for s in tk.ns_slots.tolist()]
    if form == "xla":
        assert tab.coefs.shape == (S, 8) and not tab.coefs[:, 6:].any()
        np.testing.assert_array_equal(
            tab.coefs[:, 0].numpy(),
            np.float32([1.0 / xi for xi in rows]))
    else:
        assert tab.coefs.shape == (S, 4)
        np.testing.assert_array_equal(tab.coefs.T.numpy(),
                                      tk.ns_coefs.float().numpy())


def test_chunked_tables_refuse_a_wider_stencil(states):
    _, _, tk, *_ = states
    far = tk.ns_offsets.clone()
    far[0, 2] = -4
    with pytest.raises(ValueError, match="halo"):
        kernels.ns3d_chunked_tables(
            dataclasses.replace(tk, ns_offsets=far), "jstat", 6, 24, 336)


def test_staged_walk_refuses_a_tile_that_splits_a_thread(states):
    args, _ = _form_args(states, "factored")
    with pytest.raises(ValueError, match="multiple of R"):
        kernels.ns3d_chunked_staged_plain("factored", *args, R=4,
                                          tile=(6, 8, 8))


@pytest.mark.parametrize("bz", [4, 12, 64])
def test_only_the_ladders_rungs_have_a_kernel(bz):
    assert kernels.BZ_RUNGS == (8, 16, 32)
    with pytest.raises(ValueError, match="BZ"):
        kernels.ns3d_chunked_geometry("factored", bz)
