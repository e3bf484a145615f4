"""Projection of a function on S^{d-1} onto the flat harmonic basis.

Rebuild of `ultrasphere_harmonics.expand` (reference: _biem.py:627-637):
f_h = integral f(y) conj(Y_h(y)) dS(y), by the tree's product quadrature.
This is a single [rest, Q] x [Q, H] matmul after evaluating
the integrand at the (static) quadrature nodes.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import C
from ._eval import harmonics
from ._quad import sphere_quadrature


def _quad_harmonics(c, n_end, deg):
    """Cached conj(Y) at quadrature nodes, pre-weighted: [Q, num]."""
    import jax

    return _quad_harmonics_impl(c, n_end, deg, jax.config.jax_enable_x64)


@lru_cache(maxsize=64)
def _quad_harmonics_impl(c, n_end, deg, _x64):
    import jax

    # Tables are constants: build them eagerly even if first touched
    # inside a jit trace (caching tracers would leak them).
    with jax.ensure_compile_time_eval():
        sph, w = sphere_quadrature(c, deg)
        sph_j = {k: jnp.asarray(v) for k, v in sph.items()}
        y = harmonics(c, sph_j, n_end)
        wy = y.conj() * jnp.asarray(w)[:, None]
    # Host numpy leaves: jit traces embed them as HLO literals instead
    # of capturing device buffers (translation._rotation._coax_tables).
    return sph, C(np.asarray(wy.re), np.asarray(wy.im))


def expand(c, f, n_end, deg=None):
    """Project callable f onto harmonics of degree < n_end: [..., num].

    f receives {nid: angles [Q]} (host numpy arrays: the quadrature is
    static) and must return an array whose FIRST axis is Q; remaining
    axes are preserved in front of the harmonic axis.

    `deg` sets quadrature exactness (default 2*(n_end-1)+1, matching the
    reference's expand(n=n_end) behavior of an n_end-point-per-node rule).
    """
    if deg is None:
        deg = 2 * (n_end - 1) + 1
    sph, wy = _quad_harmonics(c, n_end, deg)
    fx = C.of(f(sph))
    return cplx.einsum("q...,qh->...h", fx, wy)
