"""d-dimensional spherical Bessel/Hankel functions for all orders 0..n_end-1.

Convention (fixed by requiring the d-dim outgoing Green's function expansion
G(x,y) = i k^{d-2} sum_{n,p} j_n(k|y|) h^{(1)}_n(k|x|) Y_{n,p}(x^)conj(Y_{n,p}(y^))
to hold, which is the convention the reference's layer-potential coefficients
slc_n = i k^{d-2} rho^{d-1} j_n(k rho) assume; reference: _biem.py:516-518):

    j_n^{(d)}(z) = sqrt(pi/2) z^{-(d-2)/2} J_{n+(d-2)/2}(z)
    h_n^{(d)}(z) = sqrt(pi/2) z^{-(d-2)/2} H^{(1)}_{n+(d-2)/2}(z)

For d = 3 this is the classical spherical Bessel function; for d = 2 it is
sqrt(pi/2) J_n.  Every dimension reduces to the base-2 (cylinder) or base-3
(trigonometric) family: with d = base + 2m,

    j_n^{(d)}(z) = z^{-m} j_{n+m}^{(base)}(z).

Order recurrence: f_{n-1} + f_{n+1} = c_n f_n with c_n = (2n + base - 2)/z.
j_n is computed by upward recurrence from exact seeds in the oscillatory
regime n <= |z| and by a normalized downward (Miller) recurrence with
log-scale overflow protection in the evanescent regime n > |z|; h_n by
upward recurrence (always stable).  All arithmetic is over the real-pair
complex type (ops/cplx.py), kept from the package's first, complex-free
accelerator design.
Replaces the reference's scipy.special C/Fortran kernels (SURVEY.md
section 2.4 item 2).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import gamma as _sp_gamma

from ..ops import cplx
from ..ops.cplx import C
from ._cyl import cyl_jh01

_MILLER_BUFFER = 36
_SQRT_PI_2 = float(np.sqrt(np.pi / 2.0))


def _rescale_for(dtype):
    """Log-scaling threshold: must be representable in the real dtype."""
    return 1e150 if jnp.finfo(dtype).bits >= 64 else 1e30


def _seeds(base, z):
    """(j0, j1, h0, h1) of the base family at C z."""
    if base == 2:
        j0, j1, h0, h1 = cyl_jh01(z)
        return (j0 * _SQRT_PI_2, j1 * _SQRT_PI_2, h0 * _SQRT_PI_2, h1 * _SQRT_PI_2)
    # base == 3: closed trigonometric forms
    sin, cos = cplx.sin(z), cplx.cos(z)
    eiz = cplx.exp(z * 1j)
    small = abs(z) < 1e-4
    zs = cplx.where(small, C.of(1.0), z)
    z2 = zs * zs
    j0 = cplx.where(small, 1.0 - z2 / 6.0 * (1.0 - z2 / 20.0), sin / zs)
    j1 = cplx.where(
        small, z / 3.0 * (1.0 - z2 / 10.0 * (1.0 - z2 / 28.0)), sin / z2 - cos / zs
    )
    h0 = eiz * (-1j) / zs
    h1 = -eiz * (zs + 1j) / z2
    return j0, j1, h0, h1


def _stack_orders(head, rest):
    """Concat list of leading C values with scan output C [..., n]."""
    return cplx.concatenate(
        [cplx.stack(head, axis=-1), cplx.moveaxis(rest, 0, -1)], axis=-1
    )


def _upward(base, n_top, f0, f1, z):
    """Upward recurrence f_{n+1} = c_n f_n - f_{n-1}; returns C [..., n_top+1]."""
    inv = 1.0 / z
    if n_top == 0:
        return cplx.stack([f0], axis=-1)
    if n_top == 1:
        return cplx.stack([f0, f1], axis=-1)

    def step(carry, n):
        fm, fn = carry
        fp = fn * inv * (2.0 * n + base - 2.0) - fm
        return (fn, fp), fp

    ns = jnp.arange(1, n_top, dtype=z.re.dtype)
    (_, _), rest = jax.lax.scan(step, (f0, f1), ns, unroll=8)
    return _stack_orders([f0, f1], rest)


def _miller_down(base, n_max, z):
    """Downward (Miller) recurrence, unnormalized, with log-scaling.

    Returns (a: C [..., n_max+1], sig [..., n_max+1]): unnormalized
    f_n = a[..., n] * exp(sig[..., n]).
    """
    n_start = n_max + _MILLER_BUFFER
    inv = 1.0 / z
    rescale = _rescale_for(z.re.dtype)
    log_rescale = float(np.log(rescale))

    def step(carry, n):
        fn1, fn, sig = carry  # f_{n+1}, f_n at scale exp(sig)
        fm = fn * inv * (2.0 * n + base - 2.0) - fn1  # f_{n-1}
        too_big = abs(fm) > rescale
        scale = jnp.where(too_big, 1.0 / rescale, 1.0)
        fm2 = fm * scale
        fn2 = fn * scale
        sig2 = sig + jnp.where(too_big, log_rescale, 0.0)
        return (fn2, fm2, sig2), (fm2, sig2)

    zero = C.of(jnp.zeros_like(z.re))
    one = C.of(jnp.ones_like(z.re))
    sig0 = jnp.zeros_like(z.re)
    ns = jnp.arange(n_start, 0, -1, dtype=z.re.dtype)
    (_, _, _), (fs, sigs) = jax.lax.scan(step, (zero, one, sig0), ns, unroll=8)
    fs = cplx.moveaxis(fs, 0, -1)[..., ::-1]
    sigs = jnp.moveaxis(sigs, 0, -1)[..., ::-1]
    return fs[..., : n_max + 1], sigs[..., : n_max + 1]


@partial(jax.jit, static_argnums=(0, 1))
def family_jh(base, n_max, z):
    """j_n, h_n of the base family for n = 0..n_max at z (real or C).

    Returns (j, h): C with shape [..., n_max + 1].
    """
    z = C.of(z)
    j0, j1, h0, h1 = _seeds(base, z)
    h = _upward(base, n_max, h0, h1, z)
    j_up = _upward(base, n_max, j0, j1, z)

    a, sig = _miller_down(base, n_max, z)
    # Normalize via the Wronskian j_1 h_0 - j_0 h_1 = i / z^{base-1}.
    w_target = (1.0 / z ** (base - 1)) * 1j
    e10 = jnp.exp(sig[..., 1] - sig[..., 0])
    denom = a[..., 1] * e10 * h0 - a[..., 0] * h1
    s = w_target / denom
    j_down = s[..., None] * a * jnp.exp(sig - sig[..., :1])

    n_arr = jnp.arange(n_max + 1, dtype=z.re.dtype)
    use_up = n_arr <= abs(z)[..., None]
    j = cplx.where(use_up, j_up, j_down)
    return j, h


def _upward_scaled(base, n_top, f0, f1, z):
    """Upward recurrence in mantissa-exponent form.

    Returns (mant: C [..., n_top+1], e: [..., n_top+1]) with
    f_n = mant_n * exp(e_n).  Rescales whenever |mant| leaves
    [1/rescale, rescale], so h_n stays representable far beyond the
    float32 overflow point (|h_n(z)| ~ (2n-1)!!/z^{n+1} for n >> |z|).
    """
    inv = 1.0 / z
    rescale = _rescale_for(z.re.dtype)
    log_rescale = float(np.log(rescale))
    zero_e = jnp.zeros_like(z.re)
    if n_top == 0:
        return cplx.stack([f0], axis=-1), zero_e[..., None]
    if n_top == 1:
        return cplx.stack([f0, f1], axis=-1), jnp.stack(
            [zero_e, zero_e], axis=-1
        )

    def step(carry, n):
        fm, fn, e = carry
        fp = fn * inv * (2.0 * n + base - 2.0) - fm
        big = abs(fp) > rescale
        scale = jnp.where(big, 1.0 / rescale, 1.0)
        fp2 = fp * scale
        fn2 = fn * scale
        e2 = e + jnp.where(big, log_rescale, 0.0)
        return (fn2, fp2, e2), (fp2, e2)

    ns = jnp.arange(1, n_top, dtype=z.re.dtype)
    (_, _, _), (rest, e_rest) = jax.lax.scan(step, (f0, f1, zero_e), ns, unroll=8)
    mant = _stack_orders([f0, f1], rest)
    e = jnp.concatenate(
        [zero_e[..., None], zero_e[..., None], jnp.moveaxis(e_rest, 0, -1)],
        axis=-1,
    )
    return mant, e


def _scaled_deriv(base, m, mant, e, z, inv_zm_log):
    """Derivative in mantissa-exponent form given a scaled order table.

    f'_n = f_{n-1} - ((n + base - 2)/z) f_n; each output order carries
    exponent max(e_{n-1}, e_n) so both terms fold in with factors <= 1.
    Returns (mant', e') for the d-dim function z^{-m} f_{n+m} shifted
    exactly like _shift_deriv (the z^{-m} log goes into e').
    """
    n_top_p1 = mant.shape[-1]
    n_arr = jnp.arange(n_top_p1, dtype=z.re.dtype)
    fm1 = cplx.concatenate([mant[..., 1:2], mant[..., :-1]], axis=-1)
    em1 = jnp.concatenate([e[..., 1:2], e[..., :-1]], axis=-1)
    ep = jnp.maximum(em1, e)
    t1 = fm1 * jnp.exp(em1 - ep)
    t2 = (mant * jnp.exp(e - ep)) * ((1.0 / z)[..., None] * (n_arr + base - 2.0))
    fp = t1 - t2
    # n = 0: f'_0 = -f_1 exactly
    fp = cplx.concatenate([-mant[..., 1:2], fp[..., 1:]], axis=-1)
    ep = jnp.concatenate([e[..., 1:2], ep[..., 1:]], axis=-1)
    if m == 0:
        return fp, ep
    # d/dz [z^{-m} f_{n+m}] = z^{-m} (f'_{n+m} - (m/z) f_{n+m}):
    # fold the -(m/z) f term at the f' exponent, shift z^{-m} into e.
    t3 = mant * jnp.exp(e - ep) * ((1.0 / z) * m)[..., None]
    return fp - t3, ep + inv_zm_log[..., None]


@partial(jax.jit, static_argnums=(0, 1))
def spherical_jh_scaled(d, n_end, z):
    """Scaled j, j', h, h' for n = 0..n_end-1: ((jm,je),(jpm,jpe),(hm,he),(hpm,hpe)).

    Each function value is mant * exp(e) with |mant| kept representable,
    so assembly at n >> |k t| stays finite in float32 (the unscaled
    spherical_jh_all overflows h and underflows j there).  z must be
    nonzero.
    """
    if d < 2:
        raise ValueError(f"dimension must be >= 2, got {d}")
    base = 2 if d % 2 == 0 else 3
    m = (d - base) // 2
    z = C.of(z)
    n_top = n_end + m

    j0, j1, h0, h1 = _seeds(base, z)
    hm, he = _upward_scaled(base, n_top, h0, h1, z)
    jm_up, je_up = _upward_scaled(base, n_top, j0, j1, z)

    a, sig = _miller_down(base, n_top, z)
    # Wronskian normalization (see family_jh); keep |s| in the exponent.
    w_target = (1.0 / z ** (base - 1)) * 1j
    e10 = jnp.exp(sig[..., 1] - sig[..., 0])
    denom = a[..., 1] * e10 * h0 - a[..., 0] * h1
    s = w_target / denom
    s_abs = jnp.sqrt(s.abs2())
    s_hat = s * jnp.where(s_abs > 0, 1.0 / s_abs, 1.0)
    jm_down = s_hat[..., None] * a
    je_down = sig - sig[..., :1] + jnp.log(jnp.where(s_abs > 0, s_abs, 1.0))[..., None]

    n_arr = jnp.arange(n_top + 1, dtype=z.re.dtype)
    use_up = n_arr <= abs(z)[..., None]
    jm = cplx.where(use_up, jm_up, jm_down)
    je = jnp.where(use_up, je_up, je_down)

    inv_zm_log = -m * jnp.log(abs(z)) if m > 0 else jnp.zeros_like(z.re)
    zm_phase = (z * (1.0 / abs(z))) ** (-m) if m > 0 else C.of(jnp.ones_like(z.re))

    jpm, jpe = _scaled_deriv(base, m, jm, je, z, inv_zm_log)
    hpm, hpe = _scaled_deriv(base, m, hm, he, z, inv_zm_log)

    def shift(mant, e):
        out_m = mant[..., m : m + n_end]
        out_e = e[..., m : m + n_end] + inv_zm_log[..., None]
        if m > 0:
            out_m = zm_phase[..., None] * out_m
        return out_m, out_e

    jm, je = shift(jm, je)
    hm, he = shift(hm, he)
    if m > 0:
        jpm = zm_phase[..., None] * jpm
        hpm = zm_phase[..., None] * hpm

    def norm(mant, e):
        # The recurrences rescale in coarse jumps (log_rescale ~ 69 in
        # f32), leaving |mant| anywhere in e^{+-35}; downstream code
        # multiplies up to three mantissas, so renormalize to |mant| ~ 1
        # and let the exponent carry everything.  max(|re|, |im|) avoids
        # squaring (mantissas up to ~1e30 would overflow |.|^2 in f32).
        a = jnp.maximum(jnp.abs(mant.re), jnp.abs(mant.im))
        ln = jnp.log(jnp.where(a > 0, a, 1.0))
        return mant * jnp.exp(-ln), e + ln

    return (
        norm(jm, je),
        norm(jpm[..., m : m + n_end], jpe[..., m : m + n_end]),
        norm(hm, he),
        norm(hpm[..., m : m + n_end], hpe[..., m : m + n_end]),
    )


@partial(jax.jit, static_argnums=(0, 1))
def spherical_h_scaled(d, n_end, z):
    """Scaled outgoing h_n only: (mant C, e) with h_n = mant * exp(e).

    Upward recurrence only — no Miller pass, so this is CHEAPER than
    spherical_jh_all when just h is needed (field evaluation), while
    staying representable at any order.  Mantissas are normalized to
    |mant| ~ 1.
    """
    if d < 2:
        raise ValueError(f"dimension must be >= 2, got {d}")
    base = 2 if d % 2 == 0 else 3
    m = (d - base) // 2
    z = C.of(z)
    n_top = n_end + m
    _, _, h0, h1 = _seeds(base, z)
    hm, he = _upward_scaled(base, n_top, h0, h1, z)
    out_m = hm[..., m : m + n_end]
    out_e = he[..., m : m + n_end]
    if m > 0:
        out_e = out_e - m * jnp.log(abs(z))[..., None]
        out_m = ((z * (1.0 / abs(z))) ** (-m))[..., None] * out_m
    a = jnp.maximum(jnp.abs(out_m.re), jnp.abs(out_m.im))
    ln = jnp.log(jnp.where(a > 0, a, 1.0))
    return out_m * jnp.exp(-ln), out_e + ln


def _shift_deriv(base, m, f, z, inv_zm):
    """Derivative of z^{-m} f_{n+m} given base-family table f: C [..., n_top+1].

    f'_n(base) = f_{n-1} - ((n + base - 2)/z) f_n,  f'_0 = -f_1.
    d/dz [z^{-m} f_{n+m}] = z^{-m} (f'_{n+m} - (m/z) f_{n+m}).
    """
    n_top_p1 = f.shape[-1]
    n_arr = jnp.arange(n_top_p1, dtype=z.re.dtype)
    fm1 = cplx.concatenate([f[..., 1:2], f[..., :-1]], axis=-1)
    fp = fm1 - f * ((1.0 / z)[..., None] * (n_arr + base - 2.0))
    # n = 0: f'_0 = -f_1 exactly, for both base families
    fp = cplx.concatenate([-f[..., 1:2], fp[..., 1:]], axis=-1)
    if m == 0:
        return fp
    return inv_zm[..., None] * (fp - f * ((1.0 / z) * m)[..., None])


@partial(jax.jit, static_argnums=(0, 1))
def spherical_jh_all(d, n_end, z):
    """j_n^{(d)}, j_n', h_n^{(d)}, h_n' for n = 0..n_end-1 at z (real or C).

    Returns (j, jp, h, hp): C, each of shape [..., n_end].  Engine behind
    the reference's `ultrasphere.shn1` and `potential_coef` radial factors
    (reference: _biem.py:440-447, 654-685).
    """
    if d < 2:
        raise ValueError(f"dimension must be >= 2, got {d}")
    base = 2 if d % 2 == 0 else 3
    m = (d - base) // 2
    z = C.of(z)
    at_zero = (z.re == 0) & (z.im == 0)
    zs = cplx.where(at_zero, C.of(jnp.ones_like(z.re)), z)
    # one extra order so that derivative tables (needing f_{n+1} at n=0)
    # are never empty, even for n_end = 1
    n_top = n_end + m
    jf, hf = family_jh(base, n_top, zs)
    inv_zm = zs ** (-m) if m > 0 else C.of(jnp.ones_like(zs.re))
    jp_full = _shift_deriv(base, m, jf, zs, inv_zm)
    hp_full = _shift_deriv(base, m, hf, zs, inv_zm)
    j = inv_zm[..., None] * jf[..., m : m + n_end]
    h = inv_zm[..., None] * hf[..., m : m + n_end]
    jp = jp_full[..., m : m + n_end]
    hp = hp_full[..., m : m + n_end]
    # z = 0 limits: j_n(0) = c_d delta_{n0}, j_n'(0) = (c_d/d) delta_{n1},
    # with c_d = sqrt(pi/2) 2^{-nu} / Gamma(nu+1); h diverges -> inf.
    nu = 0.5 * (d - 2.0)
    c_d = float(np.sqrt(np.pi / 2.0) * 2.0 ** (-nu) / _sp_gamma(nu + 1.0))
    n_arr = jnp.arange(n_end)
    z0 = at_zero[..., None]
    j = cplx.where(z0, C.of(jnp.where(n_arr == 0, c_d, 0.0)), j)
    jp = cplx.where(z0, C.of(jnp.where(n_arr == 1, c_d / d, 0.0)), jp)
    h = cplx.where(z0, C(jnp.inf, jnp.inf), h)
    hp = cplx.where(z0, C(jnp.inf, jnp.inf), hp)
    return j, jp, h, hp
