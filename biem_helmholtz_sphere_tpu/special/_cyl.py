"""Complex-argument cylinder Bessel seeds J0, J1, H1_0, H1_1.

These are the only transcendental seeds the whole framework needs: every
d-dimensional spherical Bessel/Hankel function reduces to either the 2D
(integer-order cylinder) family or the 3D (half-integer, trigonometric)
family via j_n^{(d)}(z) = z^{-m} j^{(base)}_{n+m}(z) with d = base + 2m
(see special/_family.py).  The reference obtains these from scipy.special
(C/Fortran; reference: uv.lock:1723 via ultrasphere); here they are pure
JAX over the real-pair complex type (ops/cplx.py, kept from the
package's first, complex-free accelerator design), so they trace, jit
and vmap.

Algorithm: ascending power series for |z| <= CUT (DLMF 10.2.2, 10.8.1),
Hankel asymptotic expansions for |z| > CUT (DLMF 10.17.5-6).  Accuracy at
the seam is ~1e-12 relative in float64.  Valid for Re z >= 0 (z = k*r with
r > 0, Re k >= 0); moderate Im z supported.
"""

import jax
import numpy as np

from ..ops import cplx
from ..ops.cplx import C

_EULER_GAMMA = 0.5772156649015328606
_CUT = 14.0
_N_SERIES = 42
_N_ASYM = 24


def _guard(i, val):
    """Cap the mul-add chain depth XLA's algebraic simplifier can see.

    The simplifier spends ~one fixed-point run per level of a dependent
    Horner chain; chains beyond ~50 levels trip its 50-run cap and log
    "circular simplification loop" on EVERY solver compile (round 5
    bisect: a plain real 60-level Horner chain reproduces it —
    tools/simplifier_repro.py).  A barrier every 16 levels bounds the
    visible depth; evaluation order and rounding are unchanged.
    """
    if i % 16 != 0:
        return val
    return jax.lax.optimization_barrier(val)


def _series_j01(z):
    """J0, J1 by ascending series: sum_k (-1)^k (z/2)^(2k+n) / (k! (k+n)!)."""
    q = (z / 2.0) ** 2
    j0 = C.of(0.0)
    j1 = C.of(0.0)
    for i, k in enumerate(range(_N_SERIES - 1, -1, -1)):
        # log-space factorials: coefficients stay finite for all k
        lf_k = float(np.sum(np.log(np.arange(1, k + 1)))) if k > 0 else 0.0
        c0 = (-1.0) ** k * np.exp(-2.0 * lf_k)
        c1 = (-1.0) ** k * np.exp(-2.0 * lf_k - np.log(k + 1.0))
        j0 = _guard(i, j0 * q + c0)
        j1 = _guard(i, j1 * q + c1)
    return j0, j1 * (z / 2.0)


def _series_y01(z, j0, j1):
    """Y0, Y1 by the logarithmic ascending series (DLMF 10.8.1)."""
    q = (z / 2.0) ** 2
    lg = cplx.log(z / 2.0) + _EULER_GAMMA
    s0 = C.of(0.0)
    hk = 0.0
    coef0 = []
    for k in range(1, _N_SERIES):
        hk += 1.0 / k
        lf_k = float(np.sum(np.log(np.arange(1, k + 1))))
        coef0.append((-1.0) ** (k + 1) * hk * np.exp(-2.0 * lf_k))
    for i, c in enumerate(reversed(coef0)):
        s0 = _guard(i, (s0 + c) * q)
    y0 = (lg * j0 + s0) * (2.0 / np.pi)

    s1 = C.of(0.0)
    coef1 = []
    psi1 = -_EULER_GAMMA
    for k in range(_N_SERIES):
        psi2 = psi1 + 1.0 / (k + 1.0)
        lf_k = float(np.sum(np.log(np.arange(1, k + 1)))) if k > 0 else 0.0
        lf_k1 = lf_k + np.log(k + 1.0)
        coef1.append((-1.0) ** k * (psi1 + psi2) * np.exp(-lf_k - lf_k1))
        psi1 = psi2
    for i, c in enumerate(reversed(coef1)):
        s1 = _guard(i, s1 * q + c)
    # NOTE: Y1 (DLMF 10.8.1) uses plain ln(z/2); gamma is inside the psi terms.
    y1 = (
        (lg - _EULER_GAMMA) * j1 * (2.0 / np.pi)
        - (2.0 / np.pi) / z
        - s1 * (z / 2.0) * (1.0 / np.pi)
    )
    return y0, y1


def _asym_series(nu, z, sign):
    """sum_k (sign*i)^k a_k(nu) / z^k for the Hankel asymptotics."""
    mu = 4.0 * nu * nu
    coefs = []
    a = 1.0
    for k in range(1, _N_ASYM):
        a *= (mu - (2.0 * k - 1.0) ** 2) / (k * 8.0)
        coefs.append(complex((sign * 1j) ** k) * a)
    inv = 1.0 / z
    s = C.of(0.0)
    for i, c in enumerate(reversed(coefs)):
        s = _guard(i, (s + c) * inv)
    return s + 1.0


def _asym_h(nu, z, sign):
    """H^{(1)}_nu (sign=+1) or H^{(2)}_nu (sign=-1), DLMF 10.17.5-6."""
    s = _asym_series(nu, z, sign)
    omega = z - (0.5 * nu + 0.25) * np.pi
    pref = cplx.sqrt((2.0 / np.pi) / z)
    return pref * cplx.exp(omega * (sign * 1j)) * s


def cyl_jh01(z):
    """Return (J0, J1, H1_0, H1_1) at z (real array or C), elementwise.

    Replaces scipy.special.{j0,j1,hankel1} on the JAX compute path
    (reference capability: SURVEY.md section 2.4 item 2).
    """
    z = C.of(z)
    big = abs(z) > _CUT
    z_small = cplx.where(big, C.of(1.0), z)
    z_big = cplx.where(big, z, C.of(2.0 * _CUT))

    j0_s, j1_s = _series_j01(z_small)
    y0_s, y1_s = _series_y01(z_small, j0_s, j1_s)
    h0_s = j0_s + y0_s * 1j
    h1_s = j1_s + y1_s * 1j

    h1a_0 = _asym_h(0.0, z_big, +1)
    h1a_1 = _asym_h(1.0, z_big, +1)
    h2a_0 = _asym_h(0.0, z_big, -1)
    h2a_1 = _asym_h(1.0, z_big, -1)
    j0_a = (h1a_0 + h2a_0) * 0.5
    j1_a = (h1a_1 + h2a_1) * 0.5

    j0 = cplx.where(big, j0_a, j0_s)
    j1 = cplx.where(big, j1_a, j1_s)
    h0 = cplx.where(big, h1a_0, h0_s)
    h1 = cplx.where(big, h1a_1, h1_s)
    return j0, j1, h0, h1
