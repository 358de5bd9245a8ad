"""GMRES's decisions on the device (``kernels.device_loop.gmres_qr``) and
the gated route on the CPU.

gmres_qr's plain twin (the contract of csrc/gmres_qr.cu) against the host
forms the port kept: ``ops.gmres._givens`` for each Arnoldi step's
rotations and ``_back_substitute`` (each row's sum one term at a time in
ascending order) for a cycle's coefficients, bit for bit, on hypothesis
columns, a happy breakdown (h = 0) and a column whose squares underflow
(denom <= 1e-300: no rotation, a zero pivot); START, ARNOLDI and ACCEPT
from the raw dot products against the same step with the scalar glue as
separate PyTorch operations (``torch.add`` of CGS2's coefficients,
``torch.sqrt`` of the self-dots, ``ops.gmres.inv_norm`` cast to the basis
dtype and multiplied in) and the rotations on S's column, in float32 and
float64, seeded columns, breakdowns, a NaN self-dot, a negative pivot and
a zero column among them; the scalar modes (acceptance, the refinement's
passes, a step's end) against their Python statement, NaN and exit cases
included.

The gated route as the CPU runs it (each IF, WHILE and SWITCH taken by a
host read of its flag, the same bodies and flags the card's graph holds)
against the host-decision loop of tests/test_torch_gmres_graph.py, bit for
bit in C, the residual, the Arnoldi steps and the cycles: parity.cfg f32
and f64, the 8,303-node 3D grid with its refinement, the block and gather
AMR grids, the extrapolated start, restarts, and a solve that ends at
maxiter short of its tolerance; each reads the host once besides its
gates.
"""

import functools
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst
from test_torch_flow_graph import _bits
from test_torch_gmres_graph import (_built, _fresh, _operator, _same,
                                    reference_step)

from pd_mg_pin_corrosion_tpu_torch.dispatch import ops_for
from pd_mg_pin_corrosion_tpu_torch.kernels import device_loop as dl
from pd_mg_pin_corrosion_tpu_torch.ops import gmres as t_gmres

torch.set_num_threads(2)


def _state(m, cap=2):
    lay = dl.QrLayout(m, cap)
    return (lay, torch.zeros(lay.size, dtype=torch.float64),
            torch.zeros(lay.n_flags, dtype=torch.bool))


def _put(S, lay, **vals):
    for name, v in vals.items():
        S[lay.sc(name)] = v


def _glue_column(c1, c2, dot):
    """An Arnoldi step's Hessenberg column [c1 + c2, sqrt(dot)] as separate
    PyTorch operations (float64)."""
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    return torch.cat([torch.add(f64(c1), f64(c2)),
                      torch.sqrt(f64(dot)).reshape(1)]).tolist()


def _host_cycle(cols, beta):
    """The host loop's rotations over the columns ``cols`` (each j + 2
    entries) from g = [beta, 0, ...]: (cs, sn, g, R, -y)."""
    m = len(cols)
    R = np.zeros((m + 1, m))
    g = np.zeros(m + 1)
    g[0] = beta
    cs, sn = np.ones(m), np.zeros(m)
    for j, col in enumerate(cols):
        hcol = np.zeros(m + 1)
        hcol[:j + 2] = col
        c, s = t_gmres._givens(hcol, cs, sn, j)
        cs[j], sn[j] = c, s
        g_next = -s * g[j]
        g[j + 1] = g_next
        g[j] = c * g[j]
        R[:, j] = hcol
    return cs, sn, g, R, -t_gmres._back_substitute(R, g, m)


def _twin_cycle(raw, rr):
    """gmres_qr's plain twin over the raw inputs ``raw`` ((c1, c2, dot) a
    step) from <r, r> = ``rr``: START, ARNOLDI per step (tol 0: no early
    exit), FINISH."""
    m = len(raw)
    lay, S, F = _state(m)
    scale = torch.zeros(1, dtype=torch.float64)
    dl.gmres_qr_plain(dl.BEGIN, 0, S, F, m,
                      (0.0, math.inf, 0.0, 0.0, 1, 0, 1, 1, 1, 1, 1))
    _put(S, lay, BN=1.0, RN=1.0)
    dl.gmres_qr_plain(dl.HEAD, 0, S, F, m)
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    dl.gmres_qr_plain(dl.START, 0, S, F, m, dot=f64(rr), scale=scale)
    for j, (c1, c2, dot) in enumerate(raw):
        dl.gmres_qr_plain(dl.ARNOLDI, j, S, F, m, c1=f64(c1), c2=f64(c2),
                          dot=f64(dot), scale=scale)
    dl.gmres_qr_plain(dl.FINISH, 0, S, F, m)
    R = S[:lay.G].view(m, m + 1).T.numpy()
    return (S[lay.CS:lay.SN].numpy(), S[lay.SN:lay.H].numpy(),
            S[lay.G:lay.CS].numpy(), R, S[lay.YC:lay.SC].numpy(), lay, S)


def _same_bits(a, b):
    """Equal bit for bit but for the NaNs' payloads (a NaN equals a
    NaN)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    assert np.array_equal(a[~nan].view(np.int64), b[~nan].view(np.int64))


def _check_cycle(raw, rr):
    """The twin over the raw inputs against the host loop over the columns
    and beta the glue makes of them."""
    cols = [_glue_column(*step) for step in raw]
    beta = float(torch.sqrt(torch.tensor(rr, dtype=torch.float64)))
    cs, sn, g, R, y = _host_cycle(cols, beta)
    tcs, tsn, tg, tR, ty, lay, S = _twin_cycle(raw, rr)
    m = len(cols)
    for a, b in ((cs, tcs), (sn, tsn), (g, tg), (y, ty)):
        _same_bits(a, b)
    # the rows the rotations wrote: each column's first j + 2
    for j in range(m):
        _same_bits(R[:j + 2, j], tR[:j + 2, j])
    assert int(S[lay.sc("J")]) == m
    assert int(S[lay.TRIPS + lay.end(0) + m]) == 1
    assert int(S[lay.TRIPS + lay.cyc(0)]) == 1


finite = hst.floats(min_value=-1e3, max_value=1e3, allow_nan=False,
                    allow_infinity=False, allow_subnormal=False)


@settings(max_examples=60, deadline=None)
@given(hst.integers(min_value=1, max_value=9).flatmap(
    lambda m: hst.tuples(
        hst.just(m),
        hst.lists(hst.lists(finite, min_size=m + 1, max_size=m + 1),
                  min_size=m, max_size=m),
        hst.lists(hst.floats(min_value=1e-3, max_value=1e3), min_size=m,
                  max_size=m),
        hst.floats(min_value=1e-6, max_value=1e6))))
def test_twin_equals_the_host_rotations(case):
    """Random Hessenberg columns (c1 a row, c2 half of it, a positive
    subdiagonal h from the self-dot h * h, as an Arnoldi step's norm is):
    the twin's rotations, g, R and -y bit for bit the host loop's."""
    m, rows, hs, beta = case
    raw = [(row[:j + 1], [0.5 * x for x in row[:j + 1]], hs[j] * hs[j])
           for j, row in enumerate(rows)]
    _check_cycle(raw, beta * beta)


def test_twin_equals_the_host_at_a_breakdown():
    """A happy breakdown (h = 0 at the last step) and a first column whose
    squares underflow (denom <= 1e-300: c = 1, s = 0, R[0, 0] = 0), the
    back-substitution then dividing by zero, bit for bit the host loop
    (NaNs as NaNs)."""
    rng = np.random.default_rng(3)
    raw = [(list(rng.normal(size=j + 1)), list(rng.normal(size=j + 1)),
            (abs(rng.normal()) + 0.1) ** 2) for j in range(4)]
    raw[-1] = (*raw[-1][:2], 0.0)           # h = 0
    _check_cycle(raw, 6.25)
    raw3 = raw[:2]
    raw3[0] = ([1e-200], [0.0], 0.0)        # squares underflow: denom 0
    with np.errstate(divide="ignore", invalid="ignore"):
        _check_cycle(raw3, 1.0)


def qr_check_sequence(m, rng):
    """gmres_qr's modes in a step's order, for holding the kernel against
    its twin: (mode, j, arg), arg BEGIN's params or a dict of scalars to
    set first (upper case; ACCEPT's RNEW the candidate's self-dot) and raw
    inputs (START's self-dot ``dot``; ARNOLDI's CGS2 coefficients ``c1``,
    ``c2`` and self-dot ``dot``). The main solve's loop (COPY 0) runs a
    cycle that breaks down at once on a negative pivot (cosine -1), one on
    a zero column (denom 0: cosine 1, the back-substitution dividing by
    zero) and m steps with two zero subdiagonals; then the refinement and
    both correction loops (COPY 1 and 2), each with a breakdown, the
    second opening on a negative pivot; then the step's end."""
    def col(j, zero=False):
        h = abs(rng.normal()) + 0.1
        return {"c1": rng.normal(size=j + 1),
                "c2": 1e-3 * rng.normal(size=j + 1),
                "dot": 0.0 if zero else h * h}

    def cols(js, zero=()):
        return [(dl.ARNOLDI, j, col(j, j in zero)) for j in js]

    def pivot(h0):
        return (dl.ARNOLDI, 0, {"c1": np.array([h0]), "c2": np.zeros(1),
                                "dot": 0.0})

    def end(rnew):
        return [(dl.FINISH, 0, None), (dl.ACCEPT, 0, {"RNEW": rnew * rnew})]

    half = max(m // 2, 2)
    return [
        (dl.BEGIN, 0, (0.0, 1e9, 1e-4, 1e-6, 8, 3, 10, 4, 1, 2, 1000)),
        (dl.HEAD, 0, {"BN": 3.0, "RN": 1.0}),
        (dl.START, 0, {"dot": 1.0}), pivot(-2.0), *end(2.0),
        (dl.START, 0, {"dot": 1.0}), pivot(0.0), *end(2.0),
        (dl.START, 0, {"dot": 1.0}), *cols(range(m), {m // 3, m // 2}),
        *end(0.5),
        (dl.REF_FIRST, 0, {"BN": 2.0, "RN": 1e-5}),
        (dl.CORRECT, 0, {"BN": 1e-5, "RN": 1e-5}),
        (dl.START, 0, {"dot": 1e-10}), *cols(range(half), {1}), *end(1e-7),
        (dl.UPDATE, 0, {"RN": 1e-6}),
        (dl.CORRECT, 0, {"BN": 1e-6, "RN": 1e-6}),
        (dl.START, 0, {"dot": 1e-12}), pivot(-1.0), *cols(range(1, half)),
        *end(1e-8),
        (dl.UPDATE, 0, {"RN": 1e-9}),
        (dl.TAIL, 1, {"DT": 30.0, "NBELOW": 0.0, "LOSS": 1.0, "SOLID": 9.0,
                      "VMAX": 2.0, "CMAX": 0.5})]


def qr_apply(lay, S, arg, scale):
    """Set the scalars of a qr_check_sequence entry into S (on any
    device); its raw inputs as gmres_qr keyword arguments on S's device,
    with ``scale`` for the basis vector's scale."""
    if not isinstance(arg, dict):
        return {}
    raw = {}
    for name, v in arg.items():
        if name.isupper():
            S[lay.sc(name)] = v
        else:
            raw[name] = torch.tensor(v, dtype=torch.float64,
                                     device=S.device)
    if raw:
        raw["scale"] = scale
    return raw


def _glue_mode(mode, j, S, F, lay, raw, vec):
    """START, ARNOLDI or ACCEPT with the scalar glue as separate PyTorch
    operations: the norm sqrt(dot) and the column c1 + c2 into S, the
    basis row vec * inv_norm(h) cast to vec's dtype, then the mode over S
    written out (the rotations by ``ops.gmres._givens``). Returns the
    basis row (None for ACCEPT)."""
    m = lay.m
    sc = lay.sc
    copy = min(max(int(S[sc("COPY")]), 0), dl.COPIES - 1)
    h = torch.sqrt(raw["dot"])
    row = None if vec is None else vec * t_gmres.inv_norm(h).to(vec.dtype)
    if mode == dl.ACCEPT:
        S[sc("RNEW")] = h
        res_new = float(S[sc("RNEW")]) / float(S[sc("SAFE_B")])
        res = float(S[sc("RES")])
        take = res_new < res and float(S[sc("J")]) > 0.0
        S[sc("RES")] = res_new if math.isnan(res_new) else min(res_new, res)
        S[sc("K")] += 1.0
        F[dl.ACTIVE] = bool(S[sc("K")] < S[sc("NCYC")]) and bool(
            S[sc("RES")] > S[sc("TOL")])
        F[dl.TAKE] = take
        if take:
            S[lay.TRIPS + lay.take(copy)] += 1.0
    elif mode == dl.START:
        S[sc("BETA")] = h
        beta = float(h)
        S[lay.G:lay.CS] = 0.0
        S[lay.G] = beta
        S[lay.CS:lay.SN] = 1.0
        S[lay.SN:lay.H] = 0.0
        S[sc("J")] = 0.0
        F[dl.RUNNING] = not beta / float(S[sc("SAFE_B")]) < float(
            S[sc("TOL")])
        S[lay.TRIPS + lay.cyc(copy)] += 1.0
    else:
        torch.add(raw["c1"][:j + 1], raw["c2"][:j + 1],
                  out=S[lay.H:lay.H + j + 1])
        S[lay.H + j + 1] = h
        hcol = S[lay.H:lay.YC].numpy().copy()
        c, s = t_gmres._givens(hcol, S[lay.CS:lay.SN].numpy().copy(),
                               S[lay.SN:lay.H].numpy().copy(), j)
        col = torch.from_numpy(hcol[:j + 2].copy())
        S[lay.H:lay.H + j + 2] = col
        S[lay.R + j * (m + 1):lay.R + j * (m + 1) + j + 2] = col
        S[lay.CS + j], S[lay.SN + j] = float(c), float(s)
        gj = float(S[lay.G + j])
        g_next = -s * gj
        S[lay.G + j + 1] = float(g_next)
        S[lay.G + j] = float(c * gj)
        S[sc("J")] = float(j + 1)
        F[dl.RUNNING] = (not abs(g_next) / float(S[sc("SAFE_B")]) < float(
            S[sc("TOL")]) and j + 1 < m)
        S[lay.TRIPS + lay.arn(copy) + j] += 1.0
    return row


RAW_CASES = ("seeded", "h_zero", "h_1e-31", "nan", "negative_pivot",
             "zero_column")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", RAW_CASES)
def test_raw_inputs_equal_the_glue(case, dtype):
    """START, ARNOLDI (j = 0 .. m - 1) and ACCEPT of the twin from the raw
    dot products against the same modes after the glue as separate
    PyTorch operations (_glue_mode): S and F bit for bit after each mode
    (NaNs as NaNs), and the basis row the scale makes, torch.mul(vec,
    scale), bit for bit vec * inv_norm(h) in the basis dtype. Cases: seeded
    columns; the self-dot at step 2 zero (h = 0), 1e-62 (h = 1e-31, below
    the scale's 1e-30) or NaN; a first column with a negative pivot or
    zero."""
    m, n = 5, 37
    rng = np.random.default_rng(RAW_CASES.index(case))
    lay, S, F = _state(m)
    dl.gmres_qr_plain(dl.BEGIN, 0, S, F, m,
                      (0.0, math.inf, 0.0, 0.0, 4, 0, 1, 1, 1, 1, 1))
    _put(S, lay, BN=2.0, RN=1.5)
    dl.gmres_qr_plain(dl.HEAD, 0, S, F, m)
    Sg, Fg = S.clone(), F.clone()
    scale = torch.zeros(1, dtype=dtype)
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    steps = []
    for j in range(m):
        h = abs(rng.normal()) + 0.1
        steps.append({"c1": f64(rng.normal(size=j + 1)),
                      "c2": f64(1e-3 * rng.normal(size=j + 1)),
                      "dot": f64(h * h)})
    special = {"h_zero": 0.0, "h_1e-31": 1e-62, "nan": math.nan}
    if case in special:
        steps[2]["dot"] = f64(special[case])
    if case in ("negative_pivot", "zero_column"):
        steps[0] = {"c1": f64([-2.0 if case == "negative_pivot" else 0.0]),
                    "c2": f64([0.0]), "dot": f64(0.0)}
    seq = [(dl.START, 0, {"dot": f64(2.25)}),
           *((dl.ARNOLDI, j, raw) for j, raw in enumerate(steps)),
           (dl.ACCEPT, 0, {"dot": f64(0.49)})]
    with np.errstate(divide="ignore", invalid="ignore"):
        for mode, j, raw in seq:
            vec = None if mode == dl.ACCEPT else torch.tensor(
                rng.normal(size=n), dtype=dtype)
            if mode == dl.ACCEPT:
                dl.gmres_qr_plain(dl.FINISH, 0, S, F, m)
                dl.gmres_qr_plain(dl.FINISH, 0, Sg, Fg, m)
                S[lay.sc("RNEW")] = raw["dot"]
                dl.gmres_qr_plain(mode, j, S, F, m)
            else:
                dl.gmres_qr_plain(mode, j, S, F, m, scale=scale, **raw)
            want = _glue_mode(mode, j, Sg, Fg, lay, raw, vec)
            _same_bits(S, Sg)
            assert torch.equal(F, Fg), (mode, j)
            if vec is not None:
                got = torch.mul(vec, scale)
                assert torch.equal(_bits(got), _bits(want)), (mode, j)
            if mode == dl.ARNOLDI and j == 2 and case in special:
                assert float(scale) == 0.0      # a zero vector is kept
    if case == "negative_pivot":
        assert float(S[lay.CS]) == -1.0


@pytest.mark.parametrize("m", [4, 25])
def test_twin_counts_each_cycle_loop_apart(m):
    """The trip counters of a step through qr_check_sequence land in the
    cycle loop under way (COPY 0, 1, 2), whatever the rotation's cosine
    (-1 on a negative pivot, 1 on a zero column): each Arnoldi step j, each
    cycle's end after j steps, each cycle and accepted restart of its own
    loop, and nothing outside the counters but the state's own fields."""
    lay, S, F = _state(m, cap=4)
    scale = torch.zeros(1, dtype=torch.float32)
    half = max(m // 2, 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        for mode, j, arg in qr_check_sequence(m, np.random.default_rng(m)):
            raw = qr_apply(lay, S, arg, scale)
            dl.gmres_qr_plain(mode, j, S, F, m,
                              arg if mode == dl.BEGIN else None, **raw)
    trips = S[lay.TRIPS:lay.ROWS].tolist()
    want = [0.0] * lay.n_trips
    for c, arn, ends, cyc, take in (
            (0, {0: 3, **{j: 1 for j in range(1, m)}}, {1: 2, m: 1}, 3, 1),
            (1, {j: 1 for j in range(half)}, {half: 1}, 1, 1),
            (2, {j: 1 for j in range(half)}, {half: 1}, 1, 1)):
        for j, n in arn.items():
            want[lay.arn(c) + j] = float(n)
        for j, n in ends.items():
            want[lay.end(c) + j] = float(n)
        want[lay.cyc(c)] = float(cyc)
        want[lay.take(c)] = float(take)
    for name, n in (("head", 1), ("first", 1), ("correct", 2),
                    ("update", 2), ("tail", 1)):
        want[lay.trip[name]] = float(n)
    assert trips == want
    assert float(S[lay.sc("COPY")]) == 2.0
    assert float(S[lay.CS]) == -1.0     # the last loop's negative pivot


@pytest.mark.parametrize("bn, rn, tol, ncyc", [
    (2.0, 1.0, 1e-3, 4), (0.0, 0.0, 1e-3, 4), (2.0, math.nan, 1e-3, 4),
    (math.nan, 1.0, 1e-3, 4), (2.0, 1e-9, 1e-3, 4), (2.0, 1.0, 1e-3, 0)])
def test_solve_start_and_acceptance(bn, rn, tol, ncyc):
    """HEAD and ACCEPT against gmres.cycles' statements: safe_b = max(bn,
    1e-300) (Python's max: a NaN norm stays), the restart flag k < cycles
    and res > tol, and after a cycle the monotone acceptance and res =
    res_new if it is NaN else min(res_new, res)."""
    m = 3
    lay, S, F = _state(m)
    dl.gmres_qr_plain(dl.BEGIN, 0, S, F, m,
                      (0.0, 1.0, tol, tol, ncyc, 0, 1, 1, 1, 1, 1))
    _put(S, lay, BN=bn, RN=rn)
    dl.gmres_qr_plain(dl.HEAD, 0, S, F, m)
    safe_b = max(bn, 1e-300)
    res = rn / safe_b
    assert repr(float(S[lay.sc("RES")])) == repr(res)
    assert bool(F[dl.ACTIVE]) == (0 < ncyc and res > tol)
    for r_new, j in ((0.5 * rn, 2), (2.0 * rn, 1), (math.nan, 3),
                     (0.1 * rn, 0)):
        # RNEW holds the candidate's self-dot; ACCEPT takes its root
        _put(S, lay, RNEW=r_new * r_new, J=float(j))
        dl.gmres_qr_plain(dl.ACCEPT, 0, S, F, m)
        r_new = math.sqrt(r_new * r_new)
        assert repr(float(S[lay.sc("RNEW")])) == repr(r_new)
        res_new = r_new / safe_b
        take = res_new < res and j > 0
        res = res_new if math.isnan(res_new) else min(res_new, res)
        assert bool(F[dl.TAKE]) == take
        assert repr(float(S[lay.sc("RES")])) == repr(res)


@pytest.mark.parametrize("first", [3e-5, 5e-7, 2e-6])
def test_refinement_passes_and_tol_c(first):
    """REF_FIRST / UPDATE against gmres.solve's host loop: the residual
    over max(||b64||, 1e-300), the pass flag res > tol and tol_c = min(max(
    0.5 tol / max(res, 1e-300), 1e-4), 0.5); CORRECT starts two cycles to
    tol_c."""
    m, tol = 2, 1e-6
    lay, S, F = _state(m)
    dl.gmres_qr_plain(dl.BEGIN, 0, S, F, m,
                      (0.0, 1.0, 1e-4, tol, 8, 0, 1, 1, 1, 1, 1))
    _put(S, lay, BN=4.0, RN=4.0 * first)
    dl.gmres_qr_plain(dl.REF_FIRST, 0, S, F, m)
    res = 4.0 * first / 4.0
    assert bool(F[dl.GO]) == (res > tol)
    if res > tol:
        tol_c = min(max(0.5 * tol / max(res, 1e-300), 1e-4), 0.5)
        assert repr(float(S[lay.sc("TOLC")])) == repr(tol_c)
        _put(S, lay, BN=1.0, RN=0.5)
        dl.gmres_qr_plain(dl.CORRECT, 0, S, F, m)
        assert float(S[lay.sc("TOL")]) == tol_c
        assert float(S[lay.sc("NCYC")]) == 2.0 and bool(F[dl.ACTIVE])
    _put(S, lay, RN=4.0 * 1e-7)
    dl.gmres_qr_plain(dl.UPDATE, 0, S, F, m)
    assert not F[dl.GO] and float(S[lay.sc("REFRES")]) == 1e-7


@pytest.mark.parametrize("exit_by", ["budget", "cap", "T_final", "batch",
                                     "output", "none"])
def test_step_end_exits_and_rows(exit_by):
    """TAIL against the JAX package's implicit_inner_chunk body and cond
    (coupling.py:143-175): t += dt in float64, the step count, the
    dissolution flag n_below >= batch, max |res| (NaN kept), a row (t,
    loss, solid, v_max, C_max) at each count (total0 + k) a multiple of
    diag_every, and the loop's exits: the budget, the cap, T_final, the
    batch and an output boundary."""
    m = 2
    lay, S, F = _state(m, cap=8)
    total0 = 5
    params = {"budget": (0.0, 100.0, 3, 8, 99, 1000),
              "cap": (0.0, 100.0, 20, 4, 99, 1000),
              "T_final": (0.0, 2.5, 20, 8, 99, 1000),
              "batch": (0.0, 100.0, 20, 8, 3, 1000),
              "output": (0.0, 100.0, 20, 8, 99, 3),
              "none": (0.0, 100.0, 20, 8, 99, 1000)}[exit_by]
    t0, T_final, steps_left, cap, batch, out_every = params
    dl.gmres_qr_plain(dl.BEGIN, 0, S, F, m,
                      (t0, T_final, 1e-4, 1e-6, 8, total0, steps_left, cap,
                       batch, 2, out_every))
    t, k, rows, mr = t0, 0, [], 0.0
    for n_below, res in ((0, 1e-7), (1, math.nan), (3, 2e-7), (0, 1e-8),
                         (2, 3e-7), (0, 1e-7), (0, 1e-7), (0, 1e-7)):
        if not F[dl.STEP]:
            break
        dt = 0.7
        _put(S, lay, DT=dt, NBELOW=float(n_below), LOSS=1.5 * k,
             SOLID=180.0 - k, VMAX=2.0, CMAX=0.01 * k, RES=res)
        dl.gmres_qr_plain(dl.TAIL, 0, S, F, m)
        t += dt
        k += 1
        mr = math.nan if math.isnan(mr) or math.isnan(res) else max(mr, res)
        if (total0 + k) % 2 == 0:
            rows.append([t, 1.5 * (k - 1), 180.0 - (k - 1), 2.0,
                         0.01 * (k - 1)])
        go = (k < steps_left and k < cap and t < T_final
              and not n_below >= batch and (total0 + k) % out_every != 0)
        assert bool(F[dl.STEP]) == go
    assert repr(float(S[lay.sc("T")])) == repr(t)
    assert int(S[lay.sc("KK")]) == k and int(S[lay.sc("NROWS")]) == len(rows)
    assert repr(float(S[lay.sc("MAXRES")])) == repr(mr)
    got = S[lay.ROWS:lay.ROWS + 5 * len(rows)].view(-1, 5).tolist()
    assert repr(got) == repr(rows)
    expect_k = {"budget": 3, "cap": 4, "T_final": 4, "batch": 3,
                "output": 1, "none": 8}[exit_by]
    assert k == expect_k


# (kit, dt: "adaptive" or seconds, step keywords, x0 from C: a factor)
CASES = {
    "parity_f32": ("parity_f32", "adaptive", {}, None),
    "parity_f64": ("parity_f64", "adaptive", {}, None),
    "grid3d_refined": ("grid3d_f32", 10.0, {}, None),
    "blocks": ("blocks_f32", "adaptive", {}, None),
    "gather": ("gather_f32", 60.0, {}, None),
    "x0": ("parity_f32", "adaptive", {}, 1.02),
    "restarts": ("parity_f64", 60.0, {"restart": 4, "maxiter": 200}, None),
    # GMRES(3) with 6 Arnoldi steps stops at maxiter above its tolerance
    "maxiter": ("parity_f64", 600.0, {"restart": 3, "maxiter": 6}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gated_route_equals_the_host_decisions(case):
    """implicit_step through the gated route on the CPU (every gate a host
    read of gmres_qr's flag) against the host-decision loop: C and the
    residual bit for bit, the same Arnoldi steps and cycles; one read of
    the state besides the gates' flags."""
    name, dt_key, kw, x0_scale = CASES[case]
    kit, st = _built(name)
    op = _operator(st, kit, packed=name == "grid3d_f32")
    dt = (ops_for(kit).compute_adaptive_dt(st, op, kit)
          if dt_key == "adaptive" else dt_key)
    x0 = None if x0_scale is None else st.C * x0_scale
    _fresh(kit)
    t_gmres.reset_gmres_counts()
    t_gmres.reset_step_counts()
    got = t_gmres.implicit_step(ops_for(kit).linear_system, st, op, kit, dt,
                                x0=x0, **kw)
    counts = dict(t_gmres.GMRES_COUNTS)
    reads = t_gmres.STEP_COUNTS["host_reads"]
    ref_counts = {"steps": 0, "cycles": 0}
    ref = reference_step(st, op, kit, dt, x0=x0, counts=ref_counts, **kw)
    _same(got, ref)
    assert (counts["eager"], counts["cycles"]) == (ref_counts["steps"],
                                                   ref_counts["cycles"])
    assert counts["replays"] == counts["launches"] == 0
    assert reads == 1 and counts["host_reads"] > 0
    if case == "maxiter":
        tol = t_gmres.default_tol(kit.dtype)
        assert got[1] > tol and ref_counts["cycles"] == 2
        assert ref_counts["steps"] == 6
    if case == "restarts":
        assert ref_counts["cycles"] > 1
    assert torch.equal(_bits(got[0].C), _bits(ref[0].C))


def test_captures_hold_off_the_cycle_collector():
    """kernels.no_collection, around every CUDA graph capture (the flow's
    and the programs'): a dead cycle is collected on entry, the collector
    stays off inside (a collection there could free a dead kit's graphs,
    whose destruction invalidates the capture) and is on again after,
    when the block raises too."""
    import gc
    import weakref

    from pd_mg_pin_corrosion_tpu_torch.kernels import no_collection

    class Node:
        pass

    node = Node()
    node.self = node
    dead = weakref.ref(node)
    del node
    assert gc.isenabled()
    with no_collection():
        assert dead() is None and not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError):
        with no_collection():
            raise RuntimeError("the capture failed")
    assert gc.isenabled()
