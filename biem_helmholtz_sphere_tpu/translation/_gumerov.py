r"""Gumerov-Duraiswami recurrence coaxial translation (3D).

JAX rebuild of the `gumerov-expansion-coefficients` numba kernels
(reference: method="gumerov" at _biem.py:468,572; SURVEY.md section 2.3)
as `lax.scan` recurrence ladders instead of interpreted per-entry loops.

The coaxial (along the root axis) translation coefficients E^m_{n',n}(t),
defined by  S_{n,m}(y + t e_z) = sum_{n'} E^m_{n',n}(t) R_{n',m}(y),
are filled from the n' = column of radial functions by two exact ladders
(conventions pinned numerically against the quadrature coaxial factor in
tools/gd_derive.py; agreement ~1e-15):

  init       E^0_{n',0} = (-1)^{n'} sqrt(2n'+1) c_{n'}(kt)
             (c = h^{(1)} for (S|R), j for (R|R))
  sectorial  b1(m,m) E^{m+1}_{n',m+1} = b1(n'-1,m) E^m_{n'-1,m}
                                        + b2(n'+1,m) E^m_{n'+1,m}
  n-advance  a^m_n E^m_{n',n+1} = a^m_{n-1} E^m_{n',n-1}
                                  - a^m_{n'} E^m_{n'+1,n}
                                  + a^m_{n'-1} E^m_{n'-1,n}

with  a^m_n  = sqrt(((n+1+m)(n+1-m)) / ((2n+1)(2n+3)))      (0 for n < m)
      b1(n,m) = sqrt(((n+m+1)(n+m+2)) / ((2n+1)(2n+3)))
      b2(n,m) = sqrt(((n-m-1)(n-m))   / ((2n-1)(2n+1)))     (0 for n <= m)

Both ladders derive from the action of d/dz and (d/dx + i d/dy) on the
basis functions; coefficients are independent of sign(m), and the
resulting matrix lands directly in this package's orthonormal basis (no
phase conversion -- the i^{l'-l} factor of the quadrature path is
already carried by the (-1)^{n'} initialization).

Full (S|R)(t) for arbitrary t then follows the same rotation sandwich as
the default fast path: SR(t) = D(R) Coax(|t|) D(R)^H (see _rotation.py).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..harmonics._index import basis
from ..ops import cplx
from ..ops.cplx import C
from ..special._family import spherical_jh_all


def _require_gumerov_tree(c):
    """The reference restricts method="gumerov" to the 3D "ba" tree
    (documented constraint, reference _biem.py:569-574)."""
    if (
        c.c_ndim != 3
        or c.root.kind not in ("b", "bp")
        or len(c.root.children) != 1
        or c.root.children[0].kind != "a"
    ):
        raise ValueError(
            'method="gumerov" is only available for the 3D "ba" tree '
            "(reference: _biem.py:569-572)"
        )


def _a_np(m, n):
    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    num = np.maximum((n + 1 + m) * (n + 1 - m), 0.0)
    val = np.sqrt(num / ((2 * n + 1) * (2 * n + 3)))
    return np.where(n >= m, val, 0.0)


def _b1_np(n, m):
    # n = -1 rows are masked by the caller (zeroed); keep sqrt clean
    n = np.maximum(np.asarray(n, dtype=np.float64), 0.0)
    return np.sqrt((n + m + 1) * (n + m + 2) / ((2 * n + 1) * (2 * n + 3)))


def _b2_np(n, m):
    n = np.asarray(n, dtype=np.float64)
    val = np.sqrt(
        (n - m - 1) * (n - m) / np.maximum((2 * n - 1) * (2 * n + 1), 1.0)
    )
    return np.where(n - m - 1 >= 0, val, 0.0)


@lru_cache(maxsize=32)
def _gd_tables(c, n_end):
    """Static coefficient/index tables (plain numpy, dtype-agnostic)."""
    n = n_end
    npl = 3 * n + 2  # n' head-room: output n + one per n-step + one per m-step
    nprime = np.arange(npl)

    # sectorial ladder tables, m = 0..n-2 -> order m+1
    ms = np.arange(n - 1)[:, None]
    b1_prev = _b1_np(nprime[None, :] - 1, ms)  # coef on s[n'-1]
    b1_prev[:, 0] = 0.0
    b2_next = _b2_np(nprime[None, :] + 1, ms)  # coef on s[n'+1]
    b1_diag = _b1_np(ms[:, 0], ms[:, 0])

    # n-advance tables over the [m, n'] grid
    m_all = np.arange(n)[:, None]
    a_np_grid = _a_np(m_all, nprime[None, :])  # a^m_{n'}   [M, NPL]
    a_np_m1 = _a_np(m_all, nprime[None, :] - 1)  # a^m_{n'-1} [M, NPL]
    a_np_m1[:, 0] = 0.0
    a_col = _a_np(m_all, np.arange(n + 1)[None, :])  # a^m_n [M, N+1]

    # flat-basis gather: per harmonic h, root degree l and signed child m
    b = basis(c, n_end)
    root_jobs = b.node_jobs[c.root.nid]
    ell = np.array(
        [root_jobs[j][1] for j in b.node_job_index[c.root.nid]], dtype=np.int64
    )
    anid = c.root.children[0].nid
    a_jobs = b.node_jobs[anid]
    mm = np.array(
        [a_jobs[j][0] for j in b.node_job_index[anid]], dtype=np.int64
    )
    # E_flat axes [..., M, NPL, N] flattened: idx = |m|*NPL*N + l'*N + l
    idx = (
        np.abs(mm)[None, :] * (npl * n)
        + ell[:, None] * n
        + ell[None, :]
    )
    same_m = mm[:, None] == mm[None, :]
    return (
        npl,
        b1_prev,
        b2_next,
        b1_diag,
        a_np_grid,
        a_np_m1,
        a_col,
        idx,
        same_m,
    )


def gd_coaxial(c, r, n_end, k, kind="SR"):
    """Coaxial translation matrix by G-D recurrences: C [..., H, H].

    Drop-in equivalent of `_rotation.coaxial_sr` for the 3D "ba" tree;
    `r` [...] are translation distances along the root axis.
    """
    _require_gumerov_tree(c)
    (npl, b1_prev, b2_next, b1_diag, a_grid, a_m1, a_col, idx, same_m) = (
        _gd_tables(c, n_end)
    )
    n = n_end
    rdt = jnp.result_type(
        r.re.dtype if isinstance(r, C) else jnp.asarray(r).dtype, jnp.float32
    )
    z = k * r
    jf, _, hf, _ = spherical_jh_all(3, npl, z)
    rad = hf if kind == "SR" else jf  # C [..., NPL]
    sgn = jnp.asarray(
        (-1.0) ** np.arange(npl) * np.sqrt(2.0 * np.arange(npl) + 1.0), rdt
    )
    e0 = rad.astype(rdt) * sgn  # E^0_{n',0}  C [..., NPL]

    # --- sectorial ladder: all lowest-degree slices E^m_{n',m} ---
    b1p = jnp.asarray(b1_prev, rdt)
    b2n = jnp.asarray(b2_next, rdt)
    b1d = jnp.asarray(b1_diag, rdt)

    def sect_step(s, tabs):
        b1p_m, b2n_m, b1d_m = tabs
        down = cplx.concatenate([C.zeros(s.shape[:-1] + (1,), rdt), s[..., :-1]], axis=-1)
        up = cplx.concatenate([s[..., 1:], C.zeros(s.shape[:-1] + (1,), rdt)], axis=-1)
        nxt = (down * b1p_m + up * b2n_m) * (1.0 / b1d_m)
        return nxt, nxt

    _, sect_rest = jax.lax.scan(sect_step, e0, (b1p, b2n, b1d))
    # sect: [..., M, NPL] with slice m = E^m_{n',m}
    sect = cplx.concatenate(
        [e0[..., None, :], cplx.moveaxis(sect_rest, 0, -2)], axis=-2
    )

    # --- n-advance: columns E^m_{n',n}, vectorized over (m, n') ---
    ag = jnp.asarray(a_grid, rdt)  # a^m_{n'}
    am1 = jnp.asarray(a_m1, rdt)  # a^m_{n'-1}
    m_iota = jnp.asarray(np.arange(n))[:, None]  # [M, 1]

    col0 = cplx.where(m_iota == 0, sect, C.of(0.0))

    def n_step(carry, xs):
        e_prev, e_cur = carry
        n_idx, a_nm1, a_n = xs  # scalars / [M]
        up = cplx.concatenate(
            [e_cur[..., 1:], C.zeros(e_cur.shape[:-1] + (1,), rdt)], axis=-1
        )
        down = cplx.concatenate(
            [C.zeros(e_cur.shape[:-1] + (1,), rdt), e_cur[..., :-1]], axis=-1
        )
        num = (
            e_prev * a_nm1[:, None]
            - up * ag
            + down * am1
        )
        den = jnp.where(a_n > 0, a_n, 1.0)[:, None]
        e_next = num * (1.0 / den)
        e_next = cplx.where(m_iota == n_idx + 1, sect, cplx.where(m_iota <= n_idx, e_next, C.of(0.0)))
        return (e_cur, e_next), e_next

    ns = jnp.arange(n - 1)
    a_nm1_steps = jnp.asarray(
        np.stack([a_col[:, max(j - 1, 0)] * (j >= 1) for j in range(n - 1)]), rdt
    )  # a^m_{n-1} per step, [N-1, M]
    a_n_steps = jnp.asarray(a_col[:, : n - 1].T.copy(), rdt)  # a^m_n, [N-1, M]
    _, cols_rest = jax.lax.scan(
        n_step, (C.zeros(col0.shape, rdt), col0), (ns, a_nm1_steps, a_n_steps)
    )
    # E_all: [..., M, NPL, N]
    e_all = cplx.concatenate(
        [col0[..., None], cplx.moveaxis(cols_rest, 0, -1)], axis=-1
    )

    flat = e_all.reshape(e_all.shape[:-3] + (n * npl * n,))
    out = cplx.take(flat, jnp.asarray(idx), axis=-1)  # [..., H, H]
    return cplx.where(jnp.asarray(same_m), out, C.of(0.0))


def sr_gumerov(c, t_sph, n_end, k, kind="SR", t_cart=None):
    """(S|R) via rotation + G-D recurrence coaxial factor: C [..., H, H].

    Same sandwich as `_rotation.sr_rotation` with the coaxial factor from
    `gd_coaxial` -- the reference's method="gumerov" path rebuilt on
    lax.scan ladders.
    """
    from ._rotation import rotation_matrix

    _require_gumerov_tree(c)
    if t_cart is not None:
        t_vec = jnp.moveaxis(jnp.asarray(t_cart), 0, -1)
        r_t = jnp.linalg.norm(t_vec, axis=-1)
        t_hat = t_vec / jnp.where(r_t > 0, r_t, 1.0)[..., None]
    else:
        from ..coords import to_cartesian

        r_t = t_sph["r"]
        t_cart_ = to_cartesian(c, {**t_sph, "r": jnp.ones_like(r_t)})
        t_hat = jnp.moveaxis(t_cart_, 0, -1)
    coax = gd_coaxial(c, r_t, n_end, k, kind=kind)
    rot = rotation_matrix(c, t_hat, n_end)
    tmp = cplx.einsum("...ij,...kj->...ik", coax, rot.conj())
    return cplx.einsum("...ij,...jk->...ik", rot, tmp)
