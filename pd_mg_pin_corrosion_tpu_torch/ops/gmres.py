"""Restarted GMRES (right-preconditioned, CGS2 Arnoldi, Givens QR).

Port of ``pd_mg_pin_corrosion_tpu/ops/gmres.py``. Same algorithm and
exits: GMRES(m) with classical Gram-Schmidt fully reorthogonalized (CGS2,
coefficients beyond the current step masked out), Givens QR of the
Hessenberg matrix updated per step so a cycle exits at the first step whose
least-squares residual meets the target, monotone restarts (a cycle that
raised the true residual is discarded), Eigen's maxiter/restart cycle
count, and float64 Gram-Schmidt scalars over float32 Krylov vectors.

Host-driven: vectors stay on the device, the (m+1) x m Hessenberg, the
rotations and the back-substitution run on the host in float64 (the JAX
package's associative-scan Givens update was a TPU latency device; the
sequential rotation here is the same algebra). One host sync per Arnoldi
step reads the new Hessenberg column.

Storage: the Krylov basis is one [m+1, N] tensor whose rows are contiguous
and start on 128-byte lines (``kernels.pitched_basis``: N is odd on the
fine-calibration grid, and the axpy kernel reads rows 16 bytes a thread).
With ``flat_kernels`` the whole-basis contractions (CGS2 dots and
recombinations, norms, the solution update) go through the CUDA kernel
wrappers ``kernels.basis_dots`` / ``kernels.basis_axpy`` (plain twins on
the CPU); without it they use the plain versions directly, as float64 runs
must.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import (basis_axpy, basis_axpy_plain, basis_dots,
                       basis_dots_plain, pitched_basis)


def vector_norm(x: torch.Tensor) -> float:
    """2-norm as a Python float (float64 accumulation)."""
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


def _givens(hcol: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply the j previous rotations to the new column, then zero its
    subdiagonal with a new one. Returns (c, s)."""
    for i in range(j):
        t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i] = t
    denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
    if denom > 1e-300:
        c, s = hcol[j] / denom, hcol[j + 1] / denom
    else:
        c, s = 1.0, 0.0
    hcol[j] = denom
    hcol[j + 1] = 0.0
    return c, s


def _back_substitute(R: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:n] @ y[i + 1:n]) / R[i, i]
    return y


def gmres(A, b, x0, *, tol: float, restart: int, maxiter: int, M=None,
          flat_kernels: bool = False):
    """Solve A x = b. Returns (x, (residual, n_cycles)) with the relative
    residual ||b - A x|| / ||b|| as a float.

    A: linear operator (function), M: right preconditioner (function).
    ``maxiter`` counts total inner iterations as in Eigen
    (pd_ard_implicit.cpp:399-401): cycles = ceil(maxiter / restart).
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    dots = basis_dots if flat_kernels else basis_dots_plain
    axpy = basis_axpy if flat_kernels else basis_axpy_plain
    shape = b.shape
    m = restart
    n_cycles = max(1, -(-maxiter // restart))
    N = b.numel()

    def snorm_t(v):  # 0-d float64 tensor on the device
        return torch.sqrt(dots(v[None], v)[0])

    def fnorm(v):
        return float(snorm_t(v.reshape(-1)))

    b_norm = fnorm(b)
    safe_b = max(b_norm, 1e-300)
    V = pitched_basis(m + 1, N, b.dtype, b.device)

    def arnoldi_cycle(x):
        r = (b - A(x)).reshape(-1)
        beta = fnorm(r)
        inv_beta = 1.0 / max(beta, 1e-300) if beta > 1e-30 else 0.0
        V[0] = r * inv_beta

        R = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.ones(m)
        sn = np.zeros(m)
        j = 0
        done = beta / safe_b < tol
        while j < m and not done:
            w = A(M(V[j].view(shape))).reshape(-1)
            # CGS2 against v_0..v_j (coefficients of later rows are zero)
            Vj = V[:j + 1]
            c1 = dots(Vj, w)
            w = axpy(c1, Vj, w)
            c2 = dots(Vj, w)
            w = axpy(c2, Vj, w)
            h_last_t = snorm_t(w)
            host = torch.cat([c1 + c2, h_last_t[None]]).cpu().numpy()
            hcol = np.zeros(m + 1)
            hcol[:j + 2] = host
            h_last = host[j + 1]
            inv_h = 1.0 / max(h_last, 1e-300) if h_last > 1e-30 else 0.0
            # happy breakdown keeps a zero vector; its column is never used
            V[j + 1] = w * inv_h

            c, s = _givens(hcol, cs, sn, j)
            cs[j], sn[j] = c, s
            g_next = -s * g[j]
            g[j + 1] = g_next
            g[j] = c * g[j]
            R[:, j] = hcol
            j += 1
            done = abs(g_next) / safe_b < tol

        if j == 0:
            return x
        y = _back_substitute(R, g, j)
        c = torch.tensor(-y, dtype=torch.float64, device=b.device)
        dx = M(axpy(c, V[:j]).view(shape))
        return x + dx

    res = fnorm(b - A(x0)) / safe_b
    x, k = x0, 0
    while k < n_cycles and res > tol:
        x_new = arnoldi_cycle(x)
        res_new = fnorm(b - A(x_new)) / safe_b
        # monotone restarts: never accept a cycle that raised the residual
        # (a NaN residual is reported, and ends the loop, as in the JAX twin)
        if res_new < res:
            x = x_new
        res = res_new if math.isnan(res_new) else min(res_new, res)
        k += 1
    return x, (res, k)
