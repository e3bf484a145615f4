"""Hyperspherical harmonic evaluation Y_h at arbitrary angles.

Rebuild of `ultrasphere_harmonics.harmonics` (reference call sites:
_biem.py:922-929).  Design: each tree node evaluates a *table* of
its distinct 1-D factors (Fourier modes for 'a', sin-power x orthonormal
Jacobi for 'b', Jacobi in cos(2 theta) for 'c') with batched recurrences,
then the flat harmonic axis is assembled by static gathers and an
elementwise product — no ragged shapes, no per-harmonic Python loops.

Factor conventions (orthonormal w.r.t. the node's surface measure):
  'a'  : e^{i m phi} / sqrt(2 pi)
  'b'  : (sin th)^{nc} p~_{l-nc}^{(lam,lam)}(cos th),  lam = nc + (s-1)/2,
         s = child.sdim
  'c'  : 2^{(n1+n2)/2 + (s1+s2)/4 + 1/2} (cos th)^{n1} (sin th)^{n2}
         p~_j^{(n2+(s2-1)/2, n1+(s1-1)/2)}(cos 2 th),  j = (l-n1-n2)/2

with p~ the *orthonormal* Jacobi family (special/_jacobi.py), so values
stay O(1) at large degree.  The product over nodes is orthonormal on
S^{d-1} and spans exactly the degree-n harmonic subspaces.
"""

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..special._jacobi import orthonormal_jacobi_table
from ._index import basis


def _int_powers(x, n_max):
    """[..., n_max+1] with entry i = x**i, as one cumprod over the
    powers (one pass, no per-entry pow)."""
    ones = jnp.ones_like(x)[..., None]
    if n_max == 0:
        return ones
    rep = jnp.repeat(x[..., None], n_max, axis=-1)
    return jnp.cumprod(jnp.concatenate([ones, rep], axis=-1), axis=-1)


def _node_table(node, jobs, spherical):
    """[..., n_jobs] factor values for one node at its angle."""
    ang = jnp.asarray(spherical[node.nid])
    if node.kind == "a":
        ms = np.array([p[0] for p in jobs])
        return cplx.expi(ang[..., None] * ms) * (1.0 / np.sqrt(2.0 * np.pi))
    if node.kind in ("b", "bp"):
        s = node.children[0].sdim
        ncs = sorted({p[0] for p in jobs})
        fam_of = {nc: i for i, nc in enumerate(ncs)}
        maxdeg = max(p[1] - p[0] for p in jobs)
        alphas = [nc + (s - 1) / 2.0 for nc in ncs]
        t = jnp.cos(ang)
        table = orthonormal_jacobi_table(t, maxdeg, alphas, alphas)
        sin_t = jnp.sin(ang)
        nc_arr = np.array(ncs, dtype=np.int32)
        sinpow = _int_powers(sin_t, int(nc_arr.max()))[..., nc_arr]  # [..., F]
        fidx = np.array([fam_of[p[0]] for p in jobs])
        didx = np.array([p[1] - p[0] for p in jobs])
        return sinpow[..., fidx] * table[..., fidx, didx]
    # 'c'
    s1 = node.children[0].sdim
    s2 = node.children[1].sdim
    fams = sorted({(p[0], p[1]) for p in jobs})
    fam_of = {f: i for i, f in enumerate(fams)}
    maxj = max((p[2] - p[0] - p[1]) // 2 for p in jobs)
    alphas = [n2 + (s2 - 1) / 2.0 for (n1, n2) in fams]
    betas = [n1 + (s1 - 1) / 2.0 for (n1, n2) in fams]
    u = jnp.cos(2.0 * ang)
    table = orthonormal_jacobi_table(u, maxj, alphas, betas)
    cos_t, sin_t = jnp.cos(ang), jnp.sin(ang)
    n1_arr = np.array([f[0] for f in fams], dtype=np.int32)
    n2_arr = np.array([f[1] for f in fams], dtype=np.int32)
    norm = 2.0 ** ((n1_arr + n2_arr) / 2.0 + (s1 + s2) / 4.0 + 0.5)
    fampow = (
        norm
        * _int_powers(cos_t, int(n1_arr.max()))[..., n1_arr]
        * _int_powers(sin_t, int(n2_arr.max()))[..., n2_arr]
    )
    fidx = np.array([fam_of[(p[0], p[1])] for p in jobs])
    jidx = np.array([(p[2] - p[0] - p[1]) // 2 for p in jobs])
    return fampow[..., fidx] * table[..., fidx, jidx]


class Phase(int):
    """Phase-convention marker (API parity with ultrasphere_harmonics.Phase;
    reference call sites pass Phase(0), _biem.py:633,701,926).  This
    implementation uses the fixed e^{i m phi} convention, which is the
    Phase(0) convention; other values are not implemented."""

    def __new__(cls, v=0):
        if int(v) != 0:
            raise NotImplementedError(
                "only the Phase(0) (e^{i m phi}) convention is implemented"
            )
        return super().__new__(cls, v)


def harmonics(c, spherical, n_end, phase=None):
    """Evaluate all Y_h, h = 0..num-1, at the given angles: [..., num].

    `spherical` maps node id -> angle array (broadcastable shapes); the
    radius entry "r", if present, is ignored (harmonics live on the
    sphere).  Reference: ush.harmonics(c, spherical, n_end, Phase(0),
    expand_dims=True, concat=True).  `phase` accepts Phase(0) for API
    parity.
    """
    if phase is not None:
        Phase(phase)
    b = basis(c, n_end)
    out = None
    for node in c.nodes:
        tab = _node_table(node, b.node_jobs[node.nid], spherical)
        v = tab[..., b.node_job_index[node.nid]]
        if out is None:
            out = v
        elif isinstance(v, cplx.C) and not isinstance(out, cplx.C):
            out = v * out
        else:
            out = out * v
    return cplx.C.of(out)
