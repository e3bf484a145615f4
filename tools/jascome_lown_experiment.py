"""jascome low-n convention experiment (round 4).

RESULT:
  * n_end = 1 (table row n = 0) is EXACTLY REPRODUCED: invert the
    committed reference value through the pinned analytic n_end=1
    system -> the reference RHS quadrature mean of e^{i k rho x^.d^}
    is 1.0000001+2e-7j, i.e. every node has x^.d^ = 0: a 1-POINT Gauss
    rule on the polar node with the POLAR AXIS ALONG THE INCIDENT
    DIRECTION (ultrasphere maps the root cosine to x0; this repo maps
    it to the last axis — aliasing is not rotation invariant, which is
    the whole source of the low-n deviation).  Running our pipeline in
    that rotated frame with qb=1 reproduces -0.721263-1.035771i to the
    committed table's 6 decimals (err 4.7e-7).
  * n_end = 2, 3 (rows n = 1, 2) are NOT reproduced by ANY product
    quadrature in the searched space: 6 axis-frame assignments x
    {Gauss-Legendre, Gauss-Chebyshev, midpoint-trapezoid} theta rules x
    qb in {ne, ne+1} x qa in {2..5} x phi offsets {0, pi/qa} — best
    error 3.0e-1 vs the committed rows (this script prints the
    ranking).  The residual convention lives inside ultrasphere-
    harmonics' unvendored expand() (possibly least-squares on the grid
    rather than quadrature projection); rows n >= 4 — every converged
    value the paper quotes — match the reference to ~1e-6 regardless.

The committed repo tables keep the exact-RHS values (correct solutions
of the truncated systems); PARITY.md carries this conclusion.
"""
import itertools, sys
import jax
jax.config.update("jax_platforms","cpu"); jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
sys.path.insert(0,"/root/repo")
from biem_helmholtz_sphere_tpu.biem._core import (
    BIEMResultCalculator, _check_biem_inputs, _assemble)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types, to_cartesian
from biem_helmholtz_sphere_tpu.harmonics._eval import harmonics
from biem_helmholtz_sphere_tpu.harmonics._quad import gauss_jacobi, uniform_circle
from biem_helmholtz_sphere_tpu.ops import cplx
from biem_helmholtz_sphere_tpu.ops.cplx import C

c = create_from_branching_types("ba")
k = jnp.asarray(1.0)
ref_rows = {1: -0.721263-1.035771j, 2: -0.360256-0.766005j, 3: -0.680369-0.697851j}

FRAMES = {
  # (direction, centers_axis): our-frame vectors
  "d=x2,c=x0": (np.array([0.,0.,1.]), np.array([[2.,0.,0.],[-2.,0.,0.]])),
  "d=x2,c=x1": (np.array([0.,0.,1.]), np.array([[0.,2.,0.],[0.,-2.,0.]])),
  "d=x0,c=x1": (np.array([1.,0.,0.]), np.array([[0.,2.,0.],[0.,-2.,0.]])),
  "d=x0,c=x2": (np.array([1.,0.,0.]), np.array([[0.,0.,2.],[0.,0.,-2.]])),
  "d=x1,c=x0": (np.array([0.,1.,0.]), np.array([[2.,0.,0.],[-2.,0.,0.]])),
  "d=x1,c=x2": (np.array([0.,1.,0.]), np.array([[0.,0.,2.],[0.,0.,-2.]])),
}

def theta_rule(kind, q):
    if kind == "GL":
        t, w = gauss_jacobi(q, 0.0, 0.0)
        return np.arccos(t), w
    if kind == "cheb":  # Gauss-Chebyshev in cos, reweighted for sin measure
        j = np.arange(1, q+1)
        th = (2*j-1)*np.pi/(2*q)
        w = np.pi/q * np.sin(th)  # d t = sin th d th; GC weight pi/q w.r.t 1/sqrt(1-t^2)
        return th, w
    if kind == "trap":  # uniform theta incl endpoints? open trapezoid
        th = np.pi*(np.arange(q)+0.5)/q
        w = np.pi/q*np.sin(th)
        return th, w

def solve(ne, qb, qa, tkind, direction, centers, phoff=0.0):
    th, wb = theta_rule(tkind, qb)
    ph, wa = uniform_circle(qa)
    ph = ph + phoff
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    WB, WA = np.meshgrid(wb, wa, indexing="ij")
    sph = {c.root.nid: jnp.asarray(TH.ravel()), c.root.children[0].nid: jnp.asarray(PH.ravel())}
    y = harmonics(c, sph, ne)
    wy = y.conj() * jnp.asarray((WB*WA).ravel())[:, None]
    xhat = to_cartesian(c, sph, include_r=False)
    cen, rad, kc, eta, al, be = _check_biem_inputs(c, centers, np.ones(2), k, None, 1.0, 0.0)
    x = xhat[:, :, None] + np.moveaxis(centers, -1, 0)[:, None, :]
    uin_vals = cplx.expi(jnp.einsum("d,dqb->qb", jnp.asarray(direction), x))
    f = cplx.einsum("qb,qh->bh", -uin_vals, wy)
    m = _assemble(c, ne, cen, rad, kc, eta, al, be, None)
    n = 2 * f.shape[-1]
    dens = cplx.solve(m.reshape((n, n)), f.reshape((n,))).reshape(f.shape)
    calc = BIEMResultCalculator(c=c, centers=cen, radii=rad, k=kc, eta=eta,
                                density=dens, matrix=None, n_end=ne, kind="outer")
    return complex(calc.uscat(np.zeros((3,1))).to_numpy().ravel()[0])

ne = 2
res = []
for fr,(d,cen) in FRAMES.items():
    for tkind in ("GL","cheb","trap"):
        for qb in (2,3):
            for qa in (2,3,4,5):
                for phoff in (0.0, np.pi/qa):
                    u = solve(ne,qb,qa,tkind,d,cen,phoff)
                    res.append((abs(u-ref_rows[ne]), fr, tkind, qb, qa, round(phoff,3), u))
res.sort(key=lambda r: r[0])
for r in res[:8]:
    print(f"err={r[0]:.2e} {r[1]} {r[2]} qb={r[3]} qa={r[4]} off={r[5]} -> {r[6]:.6f}")
