r"""Fused harmonic contraction for field evaluation on the 3D "ba" tree.

The general evaluation path materializes Y_h at every point — a
[points, B, H] complex tensor plus same-sized recurrence-table
temporaries — before the density contraction sum_h w_h Y_h collapses it
(reference analogue: _biem.py:922-966), which makes `uscat` bound by
device-memory traffic.  For the hot 3D case Y factorizes as

    Y_{l,m}(th, ph) = e^{i m ph}/sqrt(2 pi) (sin th)^{|m|}
                      p~_{l-|m|}^{(|m|,|m|)}(cos th)

so the contraction regroups per signed order m and Jacobi degree j:

    sum_h w_h rad_{l_h} Y_h =
      sum_m  A_m(ph, th) sum_j p~_j^{(|m|)}(cos th) rad_{j+|m|} w[m, j]

and the inner j-sum rides INSIDE the Jacobi three-term-recurrence scan:
the carry is (p_{l-1}, p_l, acc[..., B, M]) and nothing of size
[points, B, H] is ever written.  Working set drops from O(points*B*H)
to O(points*B*M), ~n_end-fold less HBM traffic.

The scan is indexed by DEGREE l (not per-family Jacobi degree j) in
"slot space": one lane per signed order m, each running its family's
(|m|, |m|) recurrence with per-step coefficient tables gathered at
trace time, seeded mid-scan at l == |m| via a static mask.  Degree-major
order makes the near-field radial factor h^(1)_l(kr) a plain per-step
SLICE rad[..., l] broadcast over m — the j-major form needed a
[points, B, M] gather per step, and a second gather mapped family
recurrences to slots; both forced XLA out of a single fused elementwise
scan body.

The M = 2n-1 order slots are processed in blocks of _MBS: an outer
python loop over blocks carries only the [pts, B] accumulator, and the
inner degree scan carries [pts, B, _MBS].  Measured on an H100 at the
bench deployment (PERF.md): 2.99e6 points/s against 2.31e6 for
one scan over all M slots.

`rad` carries the per-point radial factor h^{(1)}_l(kr) for the near
field (folded in by degree l = j + |m| via a per-step static gather);
None for the far field where the radial factor is constant and folded
into w by the caller.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..harmonics._eval import _int_powers
from ..harmonics._index import basis
from ..ops import cplx
from ..ops.cplx import C
from ..special._jacobi import jacobi_recurrence

# Probe hook (tools/eval_unroll_probe.py): nonzero forces the scan
# unroll factor. jit caches key on the value read at trace time.
_UNROLL_OVERRIDE = 0

# order slots per block of the degree scan (see module docstring)
_MBS = 16


def is_ba_tree(c):
    """True for the 3D "ba" tree (root 'b'/'bp' with a single 'a' child)."""
    return (
        c.c_ndim == 3
        and c.root.kind in ("b", "bp")
        and len(c.root.children) == 1
        and c.root.children[0].kind == "a"
    )


@lru_cache(maxsize=32)
def _fused_tables(c, n_end):
    """Static degree-major slot-space tables (numpy, trace-time).

    Slot m runs the orthonormal Jacobi (|m|, |m|) three-term recurrence
    re-indexed by degree l = j + |m|: zero until l = |m| - 1, seeded with
    p_0 = 1/b0 at l = |m|, recurring for l > |m|.  All per-step
    family-dependent coefficient lookups are resolved HERE into dense
    [n, M] tables so the scan body is pure elementwise arithmetic.
    """
    b_ = basis(c, n_end)
    ell = np.array(
        [b_.node_jobs[c.root.nid][j][1] for j in b_.node_job_index[c.root.nid]],
        dtype=np.int64,
    )
    anid = c.root.children[0].nid
    mm = np.array(
        [b_.node_jobs[anid][j][0] for j in b_.node_job_index[anid]],
        dtype=np.int64,
    )
    n = n_end
    m_axis = np.arange(-(n - 1), n)  # signed m per M-slot
    m_abs = np.abs(m_axis)
    n_m = len(m_axis)  # M = 2n - 1
    # h index per (m-slot, degree l); -1 where l < |m| or l >= n
    hmap = -np.ones((n_m, n), dtype=np.int64)
    hmap[mm + (n - 1), ell] = np.arange(b_.num)
    valid = hmap >= 0
    # orthonormal Jacobi recurrence coefficients per |m| family
    a_tab = np.zeros((n, n + 1))
    b_tab = np.zeros((n, n + 1))
    for f in range(n):
        a_tab[f], b_tab[f] = jacobi_recurrence(n, float(f), float(f))
    # degree-major per-step coefficient tables [n(l), M]
    lg = np.arange(n)[:, None]  # l
    fg = m_abs[None, :]  # |m|
    j1 = lg - fg - 1  # recurrence step index, meaningful for l > |m|
    rec = j1 >= 0
    j1c = np.clip(j1, 0, n - 1)
    A_lm = np.where(rec, a_tab[fg, j1c], 0.0)
    B_lm = np.where(rec, b_tab[fg, j1c], 0.0)
    B1_lm = np.where(rec, b_tab[fg, j1c + 1], 1.0)
    seed_lm = lg == fg
    p0_m = 1.0 / b_tab[m_abs, 0]
    return m_axis, m_abs, hmap, valid, A_lm, B_lm, B1_lm, seed_lm, p0_m


def fused_ba_dot(c, n_end, w, theta, phi, rad=None):
    """sum_h w[..., B, H] rad[..., B, :]_(l_h) Y_h(theta, phi) -> C [..., B].

    w: C, broadcastable [..., B, H] (point axes may be size-1);
    theta/phi: [..., B] angles of the evaluation directions;
    rad: C [..., B, L>=n_end] per-point radial table indexed by degree,
    or None (factor 1).
    """
    m_axis, m_abs, hmap, valid, A_lm, B_lm, B1_lm, seed_lm, p0_m = (
        _fused_tables(c, n_end)
    )
    n = n_end
    m = len(m_axis)
    mbs = _MBS
    nblk = -(-m // mbs)
    mp = nblk * mbs
    pad = mp - m
    rdt = jnp.result_type(theta.dtype, jnp.float32)
    w = C.of(w).astype(rdt)
    if rad is not None:
        rad = rad.astype(rdt)

    def padm(a, val=0.0):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)],
                      constant_values=val)

    # padded per-block STATIC tables (numpy, trace-time): traced block
    # indices would turn the sin^|m| lookup into a dynamic gather and
    # the per-step coefficients into scan xs, which measured far slower
    # than this python-unrolled form on the first accelerator.
    A_p = padm(A_lm)
    # reciprocal-multiply tables: no per-element division in the scan
    # body
    inv_b1 = 1.0 / padm(B1_lm, 1.0)
    BinvB1_p = padm(B_lm) * inv_b1
    invB1_p = inv_b1
    seed_p = padm(seed_lm.astype(np.float64)) != 0.0
    p0_p = padm(p0_m)
    maxis_p = padm(m_axis.astype(np.float64))
    mabs_p = padm(m_abs)

    # density weights regrouped by degree: [n, ..., B, MP]
    w2 = cplx.take(w, jnp.asarray(np.maximum(hmap, 0)), axis=-1)
    w2 = w2 * jnp.asarray(valid, dtype=rdt)  # [..., B, M, n]
    zshape = w2.shape[:-2] + (pad, n)
    w2 = cplx.concatenate([w2, C.zeros(zshape, dtype=rdt)], axis=-2)
    w2_steps = cplx.moveaxis(w2, -1, 0)  # [n, ..., B, MP]

    ct = jnp.cos(theta)
    x_ = ct[..., None].astype(rdt)  # [..., B, 1(MBS)]
    st = jnp.sin(theta).astype(rdt)
    st_pows = _int_powers(st, n - 1)  # [..., B, n]
    phi_e = phi[..., None].astype(rdt)

    rad_steps = None
    if rad is not None:
        rad_steps = cplx.moveaxis(rad[..., :n], -1, 0)  # [n, ..., B]

    batch = jnp.broadcast_shapes(
        w.re.shape[:-1],
        theta.shape,
        () if rad is None else rad.re.shape[:-1],
    )
    pn0 = jnp.zeros(x_.shape[:-1] + (mbs,), rdt)
    unroll = _UNROLL_OVERRIDE or min(n, 64)
    acc = C.zeros(batch, dtype=rdt)

    for blk in range(nblk):
        sl = slice(blk * mbs, (blk + 1) * mbs)
        a_f = jnp.asarray(A_p[:, sl], rdt)  # [n, MBS]
        b_f = jnp.asarray(BinvB1_p[:, sl], rdt)
        b1_f = jnp.asarray(invB1_p[:, sl], rdt)
        sd_f = jnp.asarray(seed_p[:, sl])
        p0_f = jnp.asarray(p0_p[sl], rdt)  # [MBS]
        w2_f = w2_steps[..., sl]  # [n, ..., B, MBS]
        acc_blk0 = C.zeros(batch + (mbs,), dtype=rdt)

        def step(carry, xs, p0_f=p0_f):
            pm, pn, accb = carry
            a_l, binvb1_l, invb1_l, sd_l, w2_l = xs[:5]
            pp = (x_ - a_l) * pn * invb1_l - binvb1_l * pm
            pp = jnp.where(sd_l, p0_f, pp)
            contrib = w2_l * pp
            if rad is not None:
                contrib = contrib * xs[5][..., None]
            return (pn, pp, accb + contrib), None

        xs = (a_f, b_f, b1_f, sd_f, w2_f)
        if rad is not None:
            xs = xs + (rad_steps,)
        (_, _, accb), _ = jax.lax.scan(
            step, (pn0, pn0, acc_blk0), xs, unroll=unroll
        )
        stpow = jnp.take(st_pows, jnp.asarray(mabs_p[sl]), axis=-1)
        az = cplx.expi(phi_e * jnp.asarray(maxis_p[sl], rdt))
        acc = acc + (accb * az * stpow).sum(axis=-1)
    return acc * (1.0 / np.sqrt(2.0 * np.pi))

