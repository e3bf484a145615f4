"""Real-pair complex arithmetic: the package's complex number layer.

Complex arrays are carried as explicit (real, imag) pairs of real
arrays.  The layer was kept from the package's first accelerator
design, whose hardware had no complex units; whether native complex
dtypes are faster on the GPU is an open ROADMAP.md question.  It
provides:

  *  `C` — a frozen pytree dataclass (re, im) with full operator
     overloading (+, -, *, /, @, **int, indexing, conj, abs, ...), so
     numerical code reads exactly like complex jnp code;
  *  contractions via the 3-multiplication Karatsuba split
     (re = t1 - t2, im = (ar+ai)(br+bi) - t1 - t2), turning a complex
     matmul into 3 real matmuls instead of 4;
  *  `solve` — complex linear solve through the real block embedding
     [[Ar, -Ai], [Ai, Ar]] (a real LU);
  *  drop-in helpers (where, take, sum, einsum, exp, expi, ...) mirroring
     the jnp API.

`C` is a registered pytree: it flows through jit / vmap / scan carries /
shardings unchanged.  On any backend the same code runs; CPU pays ~2x
memory versus native complex64 but stays within a few percent on time.

This replaces the complex-dtype usage of the reference's NumPy/Torch
backends (SURVEY.md section 2.4 item 4).
"""

import os
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _coerce(o):
    """C if o is complex-like, else None (meaning: treat o as real)."""
    if isinstance(o, C):
        return o
    if isinstance(o, (np.ndarray, np.generic)):
        if np.iscomplexobj(o):
            return C(jnp.asarray(o.real), jnp.asarray(o.imag))
        return None
    if isinstance(o, complex):
        return C(jnp.asarray(o.real), jnp.asarray(o.imag))
    if hasattr(o, "dtype") and jnp.issubdtype(o.dtype, jnp.complexfloating):
        return C(jnp.real(o), jnp.imag(o))
    return None


def _is_complex_like(x):
    return _coerce(x) is not None


@dataclass(frozen=True)
class C:
    """A complex array as a (re, im) pair of real arrays.

    >>> import numpy as np
    >>> z = C.of(1 + 2j) * C.of(3 - 1j)
    >>> complex(z)
    (5+5j)
    >>> C.of(np.array([1.0, 2.0])).abs2().tolist()  # |z|^2
    [1.0, 4.0]
    """

    re: Any
    im: Any

    # -- constructors -------------------------------------------------
    @staticmethod
    def of(x):
        """Coerce anything complex-like (C, complex scalar, complex array,
        real array) to C."""
        if isinstance(x, C):
            return x
        if isinstance(x, complex):
            return C(jnp.asarray(x.real), jnp.asarray(x.imag))
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return C(jnp.real(x), jnp.imag(x))
        return C(x, jnp.zeros_like(x))

    @staticmethod
    def zeros(shape, dtype=None):
        dtype = dtype or jnp.float32
        z = jnp.zeros(shape, dtype=dtype)
        return C(z, z)

    # -- array-ish metadata -------------------------------------------
    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.re), jnp.shape(self.im))

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return jnp.result_type(self.re, self.im)

    @property
    def real(self):
        return self.re

    @property
    def imag(self):
        return self.im

    def astype(self, dtype):
        return C(self.re.astype(dtype), self.im.astype(dtype))

    def to_numpy(self):
        """Materialize as a numpy complex array (host)."""
        return np.asarray(self.re) + 1j * np.asarray(self.im)

    def __complex__(self):
        return complex(self.to_numpy().reshape(()))

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        oc = _coerce(o)
        if oc is not None:
            return C(self.re + oc.re, self.im + oc.im)
        # real operand: im must still broadcast to the result shape
        re = self.re + o
        return C(re, jnp.broadcast_to(self.im, jnp.shape(re)))

    __radd__ = __add__

    def __neg__(self):
        return C(-self.re, -self.im)

    def __sub__(self, o):
        oc = _coerce(o)
        if oc is not None:
            return C(self.re - oc.re, self.im - oc.im)
        re = self.re - o
        return C(re, jnp.broadcast_to(self.im, jnp.shape(re)))

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        oc = _coerce(o)
        if oc is not None:
            return C(
                self.re * oc.re - self.im * oc.im,
                self.re * oc.im + self.im * oc.re,
            )
        return C(self.re * o, self.im * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        oc = _coerce(o)
        if oc is not None:
            d = oc.re * oc.re + oc.im * oc.im
            return C(
                (self.re * oc.re + self.im * oc.im) / d,
                (self.im * oc.re - self.re * oc.im) / d,
            )
        return C(self.re / o, self.im / o)

    def __rtruediv__(self, o):
        return C.of(o) / self

    def __pow__(self, n):
        if not isinstance(n, int):
            raise TypeError("C ** exponent supports ints only; use cpow/exp")
        if n < 0:
            return 1.0 / (self ** (-n))
        out = C.of(jnp.ones_like(self.re))
        base = self
        while n:
            if n & 1:
                out = out * base
            base = base * base
            n >>= 1
        return out

    def __matmul__(self, o):
        return matmul(self, C.of(o))

    def __rmatmul__(self, o):
        return matmul(C.of(o), self)

    def conj(self):
        return C(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def __abs__(self):
        return jnp.sqrt(self.abs2())

    # -- shape ops ----------------------------------------------------
    def _map(self, f):
        return C(f(self.re), f(self.im))

    def __getitem__(self, idx):
        re, im = jnp.broadcast_arrays(self.re, self.im)
        return C(re[idx], im[idx])

    def reshape(self, *s):
        return self._map(lambda a: a.reshape(*s))

    def sum(self, axis=None):
        return self._map(lambda a: jnp.sum(a, axis=axis))

    def at_set(self, idx, val):
        val = C.of(val)
        re, im = jnp.broadcast_arrays(self.re, self.im)
        return C(re.at[idx].set(val.re), im.at[idx].set(val.im))

    def at_add(self, idx, val):
        val = C.of(val)
        re, im = jnp.broadcast_arrays(self.re, self.im)
        return C(re.at[idx].add(val.re), im.at[idx].add(val.im))

    def block_until_ready(self):
        self.re.block_until_ready()
        self.im.block_until_ready()
        return self


jax.tree_util.register_dataclass(C, data_fields=["re", "im"], meta_fields=[])


# -- free functions ----------------------------------------------------
def expi(theta):
    """e^{i theta} for real theta."""
    theta = jnp.asarray(theta)
    return C(jnp.cos(theta), jnp.sin(theta))


def exp(z):
    """e^z for C (or real) z."""
    if not isinstance(z, C):
        return C.of(jnp.exp(jnp.asarray(z)))
    m = jnp.exp(z.re)
    return C(m * jnp.cos(z.im), m * jnp.sin(z.im))


def sin(z):
    """sin z for C (or real) z."""
    if not isinstance(z, C):
        return C.of(jnp.sin(jnp.asarray(z)))
    return C(jnp.sin(z.re) * jnp.cosh(z.im), jnp.cos(z.re) * jnp.sinh(z.im))


def cos(z):
    """cos z for C (or real) z."""
    if not isinstance(z, C):
        return C.of(jnp.cos(jnp.asarray(z)))
    return C(jnp.cos(z.re) * jnp.cosh(z.im), -jnp.sin(z.re) * jnp.sinh(z.im))


def ipow(n):
    """i**n for an integer array n (host numpy): returns a C constant."""
    n = np.asarray(n) % 4
    re = np.where(n == 0, 1.0, np.where(n == 2, -1.0, 0.0))
    im = np.where(n == 1, 1.0, np.where(n == 3, -1.0, 0.0))
    return C(jnp.asarray(re), jnp.asarray(im))


def ipow_device(n, dtype=jnp.float32):
    """i**n for an int jnp array, computed on device.

    Use instead of `ipow` when n is large (e.g. [H]-sized inside a jit):
    host-numpy ipow embeds O(size) f32 literals in the executable, and
    anything derived from them is constant-folded at compile time —
    [H, H] phase tables cost O(H^2) compile memory/time that way."""
    m = jnp.asarray(n) % 4
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)
    re = jnp.where(m == 0, one, jnp.where(m == 2, -one, zero))
    im = jnp.where(m == 1, one, jnp.where(m == 3, -one, zero))
    return C(re, im)


def sqrt(z):
    """Principal square root of C z."""
    z = C.of(z)
    r = abs(z)
    re = jnp.sqrt(jnp.maximum((r + z.re) / 2.0, 0.0))
    im_mag = jnp.sqrt(jnp.maximum((r - z.re) / 2.0, 0.0))
    return C(re, jnp.where(z.im < 0, -im_mag, im_mag))


def log(z):
    z = C.of(z)
    return C(0.5 * jnp.log(z.abs2()), jnp.arctan2(z.im, z.re))


def cpow(z, p):
    """z**p for real (possibly non-integer) p."""
    return exp(log(z) * p)


def where(cond, a, b):
    a = C.of(a)
    b = C.of(b)
    return C(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))


def take(z, idx, axis=-1):
    return C(jnp.take(z.re, idx, axis=axis), jnp.take(z.im, idx, axis=axis))


def take_along_axis(z, idx, axis):
    return C(
        jnp.take_along_axis(z.re, idx, axis=axis),
        jnp.take_along_axis(z.im, idx, axis=axis),
    )


def moveaxis(z, src, dst):
    return z._map(lambda a: jnp.moveaxis(a, src, dst))


def broadcast_to(z, shape):
    return z._map(lambda a: jnp.broadcast_to(a, shape))


def concatenate(zs, axis=0):
    zs = [C.of(z) for z in zs]
    return C(
        jnp.concatenate([z.re for z in zs], axis=axis),
        jnp.concatenate([z.im for z in zs], axis=axis),
    )


def stack(zs, axis=0):
    zs = [C.of(z) for z in zs]
    return C(
        jnp.stack([z.re for z in zs], axis=axis),
        jnp.stack([z.im for z in zs], axis=axis),
    )


def sum(z, axis=None):
    return z.sum(axis=axis)


def einsum(spec, a, b):
    """Contraction of two operands, any mix of real / C.

    C x C uses the Karatsuba 3-multiplication split: 3 real einsums
    instead of 4.
    """
    a_c = isinstance(a, C) or _is_complex_like(a)
    b_c = isinstance(b, C) or _is_complex_like(b)
    if a_c and b_c:
        a = C.of(a)
        b = C.of(b)
        t1 = jnp.einsum(spec, a.re, b.re)
        t2 = jnp.einsum(spec, a.im, b.im)
        t3 = jnp.einsum(spec, a.re + a.im, b.re + b.im)
        return C(t1 - t2, t3 - t1 - t2)
    if a_c:
        a = C.of(a)
        return C(jnp.einsum(spec, a.re, b), jnp.einsum(spec, a.im, b))
    if b_c:
        b = C.of(b)
        return C(jnp.einsum(spec, a, b.re), jnp.einsum(spec, a, b.im))
    return jnp.einsum(spec, a, b)


def matvec(a, x):
    """Dense complex matvec ``A @ x`` with ONE streaming pass over each
    real half of A.

    A dense matvec is HBM-bandwidth-bound: its cost is reading the
    [N, N] matrix, not the FLOPs.  The Karatsuba einsum split (3 real
    einsums) streams 3 matrix-sized operands per product — and the
    third operand (a.re + a.im) is either materialized (extra write +
    read) or re-read from both halves, so the real traffic is 3-4
    matrix passes.  Stacking (x.re, x.im) as a 2-column right-hand side
    instead lets each half of A be streamed exactly once:

        P = A.re @ [xr xi]    (one pass over A.re)
        Q = A.im @ [xr xi]    (one pass over A.im)
        out = (P[...,0] - Q[...,1]) + i (P[...,1] + Q[...,0])

    Total traffic = one pass over (A.re, A.im) — the lower bound.  The
    2-column product leaves the matrix units mostly idle, which is
    irrelevant at this arithmetic intensity.  Broadcasts over leading batch axes like
    ``einsum('...ij,...j->...i')``.
    """
    a = C.of(a)
    x = C.of(x)
    xs = jnp.stack(jnp.broadcast_arrays(x.re, x.im), axis=-1)  # [..., N, 2]
    p = jnp.einsum("...ij,...jc->...ic", a.re, xs)
    q = jnp.einsum("...ij,...jc->...ic", a.im, xs)
    return C(p[..., 0] - q[..., 1], p[..., 1] + q[..., 0])


def matmul(a, b):
    a = C.of(a)
    b = C.of(b)
    t1 = a.re @ b.re
    t2 = a.im @ b.im
    t3 = (a.re + a.im) @ (b.re + b.im)
    return C(t1 - t2, t3 - t1 - t2)


def solve(a, b):
    """Solve A x = b for C operands via the real block embedding.

    A: [..., N, N], b: [..., N].  [[Ar, -Ai],[Ai, Ar]] [xr; xi] = [br; bi].
    """
    a = C.of(a)
    b = C.of(b)
    n = a.shape[-1]
    top = jnp.concatenate([a.re, -a.im], axis=-1)
    bot = jnp.concatenate([a.im, a.re], axis=-1)
    m = jnp.concatenate([top, bot], axis=-2)  # [..., 2N, 2N]
    rhs = jnp.concatenate([b.re, b.im], axis=-1)  # [..., 2N]
    x = jnp.linalg.solve(m, rhs[..., None])[..., 0]
    return C(x[..., :n], x[..., n:])


# Default GMRES tolerances (relative to ||M^-1 b||).  float32: Jacobi-
# preconditioned GMRES stalls around 3e-6 relative residual at bench
# scale, and 3e-5 sits under the float32 boundary-residual floor.
GMRES_TOL_F32 = 3e-5
GMRES_TOL_F64 = 1e-11


def gmres_solve_op(
    mv, diag, b, tol=None, restart=None, maxiter=20, x0=None,
    with_info=False, precond=None,
):
    """Solve A x = b by Jacobi-preconditioned GMRES for a C-linear
    operator given as a callable `mv` (C -> C) with diagonal `diag`.

    The BIEM combined-field system is second kind (diagonal blocks
    dominate for separated spheres), so GMRES converges in tens of
    iterations; each iteration is one matvec, with no LU at all, so
    its memory is O(N) beyond the operator itself.

    Hand-rolled (not jax.scipy's): Arnoldi with CGS2 orthogonalization
    and complex Givens rotations on the Hessenberg, inside a
    `lax.while_loop` that exits the moment the rotation-carried residual
    estimate passes tol — the dominant cost is the matvec (one full read
    of the matrix from HBM), and jax's "batched" GMRES always runs whole
    restart cycles (~1.5x the necessary matvecs at the bench config).
    Leading batch axes of `b` are solved as independent systems (per-
    system inner products and rotations); iteration continues until the
    slowest system converges.

    tol is relative to ||M^-1 b||; maxiter counts restart cycles, each
    of `restart` (default: f32 48 / f64 192) Krylov steps at most — one
    cycle normally suffices because restarting FORFEITS superlinear
    convergence: at a 256-sphere 2D system (n = 7936, f64 tol 1e-11),
    GMRES(64)x20 stagnated at relres 2e-6 after ~1300 matvecs while
    GMRES(256) converged to 1e-11 in one cycle, faster.
    Unused basis slots cost no matvecs (per-step convergence skip), only
    the orthogonalization passes over the full [m+1, n] basis (~4m/n of
    one matvec per step).

    with_info=True returns (x, relres, iters): the rotation-carried
    estimate of the final PRECONDITIONED relative residual per batch
    system, and the PER-SYSTEM count of Krylov steps until that
    system's estimate crossed tol (int32, batch shape).  Systems
    iterate together, so the matvec cost actually PAID by a batch is
    max(iters) — use the max for cost models and the per-system values
    for convergence diagnostics.  An iterative solver without
    convergence diagnostics cannot distinguish a converged from a
    stagnated solve; biem() surfaces these on the
    result object.

    precond: optional callable M^{-1} (C -> C, same flat shape)
    replacing the default Jacobi (diagonal) preconditioner — used by the
    lattice solver's block-circulant preconditioner, which solves the
    periodic-lattice analogue of the system exactly per FFT frequency
    and collapses the iteration count on large lattices.  `diag` is
    still used for the unpreconditioned diagonal fallback semantics and
    may be passed as ones when precond is given.
    """
    b = C.of(b)
    rdt = b.re.dtype
    f32 = jnp.finfo(rdt).bits == 32
    if tol is None:
        tol = GMRES_TOL_F32 if f32 else GMRES_TOL_F64
        # Artifact-regeneration override: reference-parity CSV rows need
        # ~11 converged digits (tol 1e-13 f64), which is wasteful for
        # ordinary solves.  Read at trace time only when tol was not
        # passed explicitly.
        env = os.environ.get("BHS_GMRES_TOL_F32" if f32 else "BHS_GMRES_TOL")
        if env:
            tol = float(env)
    m = restart if restart is not None else (48 if f32 else 192)
    m = max(1, min(m, b.shape[-1]))  # Krylov dimension caps at n
    x, relres, iters = _gmres_cgs2(
        mv, C.of(diag), b, tol, m, maxiter, x0=x0, precond=precond
    )
    if with_info:
        return x, relres, iters
    return x


def _gmres_cgs2(mv, diag, b, tol, m, maxiter, x0=None, precond=None):
    """Left-preconditioned restarted GMRES(m) (Jacobi by default, or a
    caller-supplied M^{-1}), batched over the leading axes of b; see
    gmres_solve_op.

    x0: optional warm start (same shape as b).  In a k-sweep the
    previous k-point's density is an excellent guess — the first cycle
    then starts from a residual ~|dk| instead of ||b|| and exits in a
    fraction of the Krylov steps.  Convergence is still measured
    against ||M^-1 b|| (not the initial residual), so the result meets
    the same tolerance as a cold start.

    Returns (x, relres, iters) — see gmres_solve_op with_info."""
    rdt = b.re.dtype
    batch = b.shape[:-1]
    nb = len(batch)
    tiny = float(np.finfo(np.dtype(rdt)).tiny) ** 0.5

    if precond is None:
        def pre_mv(x):
            return mv(x) / diag

        b_pre = b / diag
    else:
        def pre_mv(x):
            return precond(mv(x))

        b_pre = precond(b)

    def inv_or_zero(a):
        return jnp.where(a > tiny, 1.0 / jnp.maximum(a, tiny), 0.0)

    bnorm = jnp.sqrt(b_pre.abs2().sum(axis=-1))  # [batch]
    target = jnp.asarray(tol, rdt) * bnorm

    col = (slice(None),) + (None,) * nb  # lift [m+1] masks over batch

    def cycle(x):
        r = b_pre - pre_mv(x)
        beta = jnp.sqrt(r.abs2().sum(-1))  # [batch]
        v0 = r * inv_or_zero(beta)[..., None]
        V = C.zeros((m + 1,) + b.shape, rdt).at_set((0,), v0)
        R = C.zeros((m, m) + batch, rdt)  # R[col, row]
        g = C.zeros((m + 1,) + batch, rdt).at_set((0,), C.of(beta))
        # accumulated product of the Givens rotations applied so far
        # (each G_i = [[u, v], [-v, conj(u)]] on rows (i, i+1)); applying
        # it to a new Hessenberg column is ONE tiny [m+1, m+1] matvec
        # instead of a j-step sequential loop.
        eye = jnp.eye(m + 1, dtype=rdt)
        Q = C(
            jnp.broadcast_to(eye.reshape((m + 1, m + 1) + (1,) * nb),
                             (m + 1, m + 1) + batch),
            jnp.zeros((m + 1, m + 1) + batch, rdt),
        )

        def proj(V, w, mask):
            # one classical Gram-Schmidt pass against rows 0..j of V
            hr = (V.re * w.re + V.im * w.im).sum(-1) * mask
            hi = (V.re * w.im - V.im * w.re).sum(-1) * mask
            h = C(hr, hi)  # [m+1, batch]
            w2 = w - C(
                (hr[..., None] * V.re - hi[..., None] * V.im).sum(0),
                (hr[..., None] * V.im + hi[..., None] * V.re).sum(0),
            )
            return h, w2

        def step_work(st, j):
            V, R, g, Q, _ = st
            w = pre_mv(V[j])
            mask = (jnp.arange(m + 1) <= j).astype(rdt)[col]
            h1, w = proj(V, w, mask)
            h2, w = proj(V, w, mask)  # CGS2: reorthogonalize once
            h = h1 + h2  # [m+1, batch]
            hn = jnp.sqrt(w.abs2().sum(-1))  # [batch]
            V = V.at_set((j + 1,), w * inv_or_zero(hn)[..., None])
            # rotate the new column by the accumulated rotations
            hr = C(
                (Q.re * h.re[None] - Q.im * h.im[None]).sum(1),
                (Q.re * h.im[None] + Q.im * h.re[None]).sum(1),
            )
            # new rotation eliminating (hr[j], hn) -> (rr, 0)
            a = hr[j]
            rr = jnp.sqrt(a.abs2() + hn * hn)
            inv_r = inv_or_zero(rr)
            uj = where(rr > tiny, a.conj() * inv_r, C.of(jnp.ones_like(rr)))
            vj = hn * inv_r
            Qj, Qj1 = Q[j], Q[j + 1]
            Q = Q.at_set((j,), uj * Qj + vj * Qj1).at_set(
                (j + 1,), Qj1 * uj.conj() - Qj * vj
            )
            R = R.at_set((j,), hr.at_set((j,), C.of(rr))[:m])
            gj = g[j]
            g = g.at_set((j,), uj * gj).at_set((j + 1,), gj * (-vj))
            return V, R, g, Q, jnp.sqrt((gj * (-vj)).abs2())

        def step(st, j):
            # fixed-trip scan (the compile shape XLA handles best here);
            # once EVERY system is converged the whole step body — matvec
            # included — is skipped at runtime via cond, so the scan
            # costs per-step dispatch only beyond the exit point.
            resid = st[-1]
            st2 = jax.lax.cond(
                jnp.any(resid > target), lambda: step_work(st, j), lambda: st
            )
            return st2, resid

        st = (V, R, g, Q, beta)
        (V, R, g, Q, resid), resids = jax.lax.scan(step, st, jnp.arange(m))
        # number of steps that actually ran: resids[i] is the estimate
        # BEFORE step i; a step runs iff any system was unconverged then
        # (monotone: once all converged, every later step is skipped)
        ran = jnp.any(
            resids.reshape(m, -1) > target.reshape(1, -1), axis=1
        )
        j_f = jnp.sum(ran.astype(jnp.int32), dtype=jnp.int32)
        # per-SYSTEM convergence count: steps until THAT system's
        # rotation-carried estimate crossed its target (the estimate is
        # monotone nonincreasing within a cycle).  The matvec cost
        # actually paid is the batch max (systems iterate together);
        # this is the convergence diagnostic.
        j_sys = jnp.sum(
            resids > target[None], axis=0, dtype=jnp.int32
        )

        # back-substitution on the rotated (upper-triangular) system;
        # columns >= j_f get unit diagonal and zero rhs so y there is 0.
        valid = (jnp.arange(m) < j_f).astype(rdt)[col]
        gm = g[:m] * valid

        def back(i, y):
            l = m - 1 - i
            Rrow = R[:, l]  # C [m(col), batch]
            pmask = (jnp.arange(m) > l).astype(rdt)[col]
            s = C(
                (pmask * (Rrow.re * y.re - Rrow.im * y.im)).sum(0),
                (pmask * (Rrow.re * y.im + Rrow.im * y.re)).sum(0),
            )
            rll = Rrow[l]
            rll = where(l < j_f, rll, C.of(jnp.ones_like(rll.re)))
            scale = inv_or_zero(jnp.sqrt(rll.abs2()))
            yl = (gm[l] - s) * (rll.conj() * (scale * scale))
            return y.at_set((l,), yl)

        y = jax.lax.fori_loop(0, m, back, C.zeros((m,) + batch, rdt))
        corr = C(
            (y.re[..., None] * V.re[:m] - y.im[..., None] * V.im[:m]).sum(0),
            (y.re[..., None] * V.im[:m] + y.im[..., None] * V.re[:m]).sum(0),
        )
        return x + corr, resid, j_sys

    def obody(st):
        x, it, _, ns = st
        x2, resid, j_sys = cycle(x)
        return x2, it + 1, resid, ns + j_sys

    def ocond(st):
        _, it, resid, _ = st
        return (it < maxiter) & jnp.any(resid > target)

    if x0 is None:
        x0 = C.zeros(b.shape, rdt)
    else:
        x0 = broadcast_to(C.of(x0).astype(rdt), b.shape)
    inf0 = jnp.full(batch, np.inf, rdt)
    x, _, resid, nsteps = jax.lax.while_loop(
        ocond, obody, (x0, 0, inf0, jnp.zeros(batch, jnp.int32))
    )
    relres = resid * inv_or_zero(bnorm)
    return x, relres, nsteps


def gmres_solve(a, b, tol=None, restart=None, maxiter=20, with_info=False):
    """GMRES on an explicitly assembled dense C matrix (see
    gmres_solve_op for the method)."""
    a = C.of(a)

    d = C(
        jnp.diagonal(a.re, axis1=-2, axis2=-1),
        jnp.diagonal(a.im, axis1=-2, axis2=-1),
    )

    def mv(x):
        return matvec(a, x)

    return gmres_solve_op(
        mv, d, b, tol=tol, restart=restart, maxiter=maxiter,
        with_info=with_info,
    )


def gmres_solve_blocks(a4, b, tol=None, restart=None, maxiter=20):
    """GMRES on the block-structured matrix C [..., B, H, B', H'],
    b C [..., B*H] -> x C [..., B*H], WITHOUT reshaping the matrix to
    [N, N] (see gmres_solve_pairs for the memory rationale)."""
    a4 = C.of(a4)
    nb, h = a4.shape[-4], a4.shape[-3]
    batch = b.shape[:-1]

    d = C(
        jnp.diagonal(
            jnp.diagonal(a4.re, axis1=-4, axis2=-2), axis1=-3, axis2=-2
        ),
        jnp.diagonal(
            jnp.diagonal(a4.im, axis1=-4, axis2=-2), axis1=-3, axis2=-2
        ),
    )  # [..., B, H] (verified: double-diagonal emits b-then-i order)
    d = d.reshape(batch + (nb * h,))

    def mv(x):
        xb = x.reshape(batch + (nb, h))
        xs = jnp.stack(jnp.broadcast_arrays(xb.re, xb.im), axis=-1)
        p = jnp.einsum("...bisj,...sjc->...bic", a4.re, xs)
        q = jnp.einsum("...bisj,...sjc->...bic", a4.im, xs)
        out = C(p[..., 0] - q[..., 1], p[..., 1] + q[..., 0])
        return out.reshape(batch + (nb * h,))

    return gmres_solve_op(mv, d, b, tol=tol, restart=restart, maxiter=maxiter)


def gmres_solve_pairs(
    a5, b, tol=None, restart=None, maxiter=20, x0=None, with_info=False
):
    """GMRES on the PAIR-MAJOR block matrix C [..., B, B', H, H'],
    b C [..., B*H] -> x C [..., B*H].

    [B, B', H, H'] is the layout the block-gather assembly naturally
    emits (biem/_core.py::_assemble pair_major=True).  Reordering it to
    [B, H, B', H'] or reshaping to [N, N] makes XLA materialize a
    matrix-sized layout-normalizing copy per real half (three live
    matrix-sized buffers at the KB=4 k-blocked bench).  Contracting the
    pair-major form directly — a j-contraction batched over the source
    ball s, then a reduction over s — keeps the minor-most axis of the
    operand the contracting one, so the matrix lives ONCE in its
    producer layout.
    """
    a5 = C.of(a5)
    nb, h = a5.shape[-4], a5.shape[-2]
    batch = b.shape[:-1]

    # diag d[..., b, i] = a5[..., b, b, i, i]
    d = C(
        jnp.diagonal(
            jnp.diagonal(a5.re, axis1=-4, axis2=-3), axis1=-3, axis2=-2
        ),
        jnp.diagonal(
            jnp.diagonal(a5.im, axis1=-4, axis2=-3), axis1=-3, axis2=-2
        ),
    )  # [..., B, H] (verified: double-diagonal emits b-then-i order)
    d = d.reshape(batch + (nb * h,))

    def mv(x):
        xb = x.reshape(batch + (nb, h))
        xs = jnp.stack(jnp.broadcast_arrays(xb.re, xb.im), axis=-1)
        # j-contraction with s as a dot batch dim (j is minor-most in
        # the producer layout: no relayout copy), then reduce over s;
        # the [.., B, B', H, 2] intermediate is H/nb-fold smaller than
        # the matrix and fuses into the dot epilogue.
        p = jnp.einsum("...bsij,...sjc->...bsic", a5.re, xs).sum(-3)
        q = jnp.einsum("...bsij,...sjc->...bsic", a5.im, xs).sum(-3)
        out = C(p[..., 0] - q[..., 1], p[..., 1] + q[..., 0])
        return out.reshape(batch + (nb * h,))

    return gmres_solve_op(
        mv, d, b, tol=tol, restart=restart, maxiter=maxiter, x0=x0,
        with_info=with_info,
    )


def to_numpy(x):
    """C -> numpy complex; anything else -> np.asarray (host)."""
    if isinstance(x, C):
        return x.to_numpy()
    return np.asarray(x)


def asarray_if_c(z):
    """C -> jnp complex array (only valid on complex-supporting backends)."""
    if isinstance(z, C):
        return jnp.asarray(z.re) + 1j * jnp.asarray(z.im)
    return z
