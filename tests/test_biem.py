"""End-to-end solver tests against the reference's golden values.

Oracles (SURVEY.md section 6 / BASELINE.md): the README doctest value,
the jascome converged values per dimension, plus physics identities
(far-field/near-field consistency, boundary condition residual) and
jit/vmap behavior.
"""

import jax
import jax.numpy as jnp
import numpy as np

from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
import pytest

from biem_helmholtz_sphere_tpu import (
    BIEMResultCalculator,
    biem,
    max_memory,
    max_n_end,
    plane_wave,
    point_source,
)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types

GOLDEN = [
    # (branching type, n_end, uscat(0), tol) — two unit spheres at
    # (0, +-2, 0, ...), k=1, eta=1, sound-soft, plane wave along x0
    ("ba", 6, -0.741333 - 0.669657j, 2e-6),  # README.md:123-124
    ("bpa", 6, -0.741333 - 0.669657j, 2e-6),
    ("a", 9, -1.355933 - 0.657813j, 2e-6),  # jascome_output_2d.csv (n>=6)
    ("bba", 6, -0.454651 - 0.423387j, 2e-6),  # jascome_output_4d.csv
    ("bpbpa", 6, -0.454651 - 0.423387j, 2e-6),
    ("caa", 6, -0.454651 - 0.423387j, 2e-6),
]


def _two_sphere_problem(btype, n_end, k=1.0, alpha=1.0, beta=0.0, eta=1.0, **kw):
    c = create_from_branching_types(btype)
    d = c.c_ndim
    centers = np.zeros((2, d))
    centers[0, 1] = 2.0
    centers[1, 1] = -2.0
    direction = np.zeros(d)
    direction[0] = 1.0
    k = tonp(k)
    uin, uin_grad = plane_wave(k=k, direction=jnp.asarray(direction))
    return c, biem(
        c,
        centers=jnp.asarray(centers),
        radii=jnp.ones(2),
        k=k,
        n_end=n_end,
        alpha=alpha,
        beta=beta,
        uin=uin,
        uin_grad=uin_grad if (tonp(beta) != 0).any() else None,
        eta=tonp(eta),
        **kw,
    )


@pytest.mark.parametrize("btype,n_end,ref,tol", GOLDEN)
def test_golden_values(btype, n_end, ref, tol):
    c, calc = _two_sphere_problem(btype, n_end)
    u0 = complex(tonp(calc.uscat(jnp.zeros((c.c_ndim, 1)))).reshape(-1)[0])
    assert abs(u0 - ref) < tol, f"{btype}: {u0} vs {ref}"


ACCURACY_SWEEP_GOLDEN = [
    # Converged rows from the reference's committed k-sweep artifacts.
    # The reference sweep builds the incident plane wave at FIXED k=1
    # while sweeping the solver's k (reference cli.py:238-243); these
    # values are only reproduced under that config.
    # (btype, k, n_end, reference uscat(0), tol)
    ("a", 16.0, 32, 1.0035487245418335 + 0.09104501905173143j, 1e-10),
    # accuracy_k_a.csv rows n_end 32..215 agree to ~1e-12
    ("ba", 16.0, 38, 0.8383385497173603 + 0.14762772199014532j, 1e-9),
    # accuracy_k_ba.csv rows n_end 36..39 agree to ~1e-11
]


@pytest.mark.parametrize("btype,k,n_end,ref,tol", ACCURACY_SWEEP_GOLDEN)
def test_reference_accuracy_sweep_values(btype, k, n_end, ref, tol):
    """Pin converged reference accuracy_k_*.csv rows (uin built at k=1)."""
    c = create_from_branching_types(btype)
    d = c.c_ndim
    centers = np.zeros((2, d))
    centers[0, 1] = 2.0
    centers[1, 1] = -2.0
    direction = np.zeros(d)
    direction[0] = 1.0
    uin, _ = plane_wave(k=jnp.asarray(1.0), direction=jnp.asarray(direction))
    calc = biem(
        c,
        centers=jnp.asarray(centers),
        radii=jnp.ones(2),
        k=jnp.asarray(k),
        n_end=n_end,
        uin=uin,
    )
    u0 = complex(tonp(calc.uscat(jnp.zeros((d, 1)))).reshape(-1)[0])
    assert abs(u0 - ref) < tol, f"{btype} k={k}: {u0} vs {ref}"


# The reference's extreme-corner rows (accuracy_k_a.csv, all rows with
# n_end >= 2048 — its largest committed systems, up to n_end=3444 at
# k=2896.3).  tools/corner_f64.py regenerates these on the CPU f64 path;
# the committed accuracy/accuracy_corner_f64.csv matches each to <=2e-9.
REFERENCE_CORNER_ROWS = {
    (1448.1546878700494, 2048): 0.973256909956196 - 0.04091440033125521j,
    (2048.0, 2048): -1.0126795465820553 + 0.11489045399618833j,
    (2048.0, 2435): -1.0090569984204287 + 0.11768294759603562j,
    (2048.0, 2896): -1.0090569984211528 + 0.1176829475958682j,
    (2896.309375740099, 2048): -1.0065483166971274 + 0.09072245939166873j,
    (2896.309375740099, 2435): -0.993290127584141 + 0.08109394100204778j,
    (2896.309375740099, 2896): -0.9865468923235745 + 0.09106819808258138j,
    (2896.309375740099, 3444): -0.9908112211317346 + 0.08485239867101844j,
}


def test_corner_artifact_matches_reference():
    """The committed extreme-corner artifact rows reproduce the
    reference's committed values (data parity, no solve)."""
    import csv
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "accuracy", "accuracy_corner_f64.csv"
    )
    if not os.path.exists(path):
        pytest.skip("corner artifact not generated yet")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    seen = {}
    for r in rows:
        seen[(float(r["k"]), int(r["n_end"]))] = complex(
            float(r["uscat_real"]), float(r["uscat_imag"])
        )
    missing = set(REFERENCE_CORNER_ROWS) - set(seen)
    assert not missing, f"corner rows missing: {sorted(missing)}"
    for key, ref in REFERENCE_CORNER_ROWS.items():
        got = seen[key]
        assert abs(got - ref) < 1e-7, f"{key}: {got} vs {ref}"


# Converged rows of the reference's committed n_balls family
# (/root/reference/accuracy/accuracy_n_balls_a.csv; 2D lattice, k=1,
# CPU f64).  The committed repo artifact (accuracy/accuracy.csv,
# regenerated round 3 at GMRES tol 1e-13) matches every converged row
# (n_end >= 8) to <= 1.3e-9 — the iterative-solver forward-error floor
# vs the reference's dense LU; rows n_end <= 6 embed the reference's
# quadrature-RHS aliasing (see PARITY.md "jascome low-n deviation").
REFERENCE_N_BALLS_ROWS = {
    # (n_balls, n_end): reference uscat(0)
    # (accuracy_n_balls_a.csv rows 21, 42, 63, 82 there)
    (4, 90): -1.1072550619427564 + 0.35168577565058234j,
    (16, 90): -1.0480631533178784 - 0.27121926513494804j,
    (64, 90): -1.0537360056906624 + 0.02146423517307422j,
    (256, 53): -0.9986093441190892 - 0.0011085158520189268j,
}


def test_n_balls_artifact_matches_reference():
    """Committed n_balls family rows reproduce the reference's converged
    values (data parity, no solve)."""
    import csv
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "accuracy", "accuracy.csv"
    )
    seen = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            if r["mode"] == "n_balls" and r["dtype"] == "float64":
                seen[(int(r["n_balls"]), int(r["n_end"]))] = complex(
                    float(r["uscat_real"]), float(r["uscat_imag"])
                )
    missing = set(REFERENCE_N_BALLS_ROWS) - set(seen)
    assert not missing, f"family rows missing: {sorted(missing)}"
    for key, ref in REFERENCE_N_BALLS_ROWS.items():
        got = seen[key]
        assert abs(got - ref) < 2e-9, f"{key}: {got} vs {ref}"


def test_n_balls_1024_depth_and_convergence():
    """The beyond-reference 1024-sphere lattice rows (FFT matvec, CPU
    f64, GMRES tol 1e-13) are committed to deep self-convergence:
    the last two f64 rows at n_end >= 19 agree to
    <= 1e-8 relative.  Round 4 added the 4096-sphere f64 family via
    long-basis GMRES + the n_end ladder (tools/nballs_family4.py;
    restarted GMRES(192) had stagnated there in round 3)."""
    import csv
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "accuracy", "accuracy.csv"
    )
    fam = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            if r["mode"] == "n_balls" and r["dtype"] == "float64":
                fam.setdefault(int(r["n_balls"]), {})[int(r["n_end"])] = (
                    complex(float(r["uscat_real"]), float(r["uscat_imag"]))
                )
    ns = sorted(n for n in fam.get(1024, {}) if n >= 19)
    assert len(ns) >= 2, f"1024-sphere rows too shallow: {ns}"
    a, b = fam[1024][ns[-2]], fam[1024][ns[-1]]
    rel = abs(b - a) / abs(b)
    assert rel < 1e-8, f"1024 spheres: {ns[-2]}->{ns[-1]} rel {rel:.2e}"


def test_exact_truncated_system_n_end_1():
    """At n_end=1 (one harmonic per ball) the 2-ball 2D system is a 2x2
    linear system whose entries are analytic: diag = SD*H_0(k*rho),
    offdiag = SD*H_0(k*|c0-c1|)*J_0(k*rho), SD = i*(k*J_0'(k) - i*eta*J_0(k)).
    Our exact Graf translation must reproduce the hand solve to ~1e-14.

    (The reference's committed value at this row, -0.700937-1.081159j in
    accuracy_k_a.csv, embeds its triplet method's truncation error in the
    (S|R) element itself; ours is the exact truncated-Galerkin solution.
    Converged rows n>=4 agree with the reference to 6 d.p. — see
    test_golden_values and PARITY.md.)"""
    from scipy.special import hankel1, jv, jvp

    k = rho = eta = 1.0
    slc = 1j * jv(0, k * rho)
    dlc = 1j * k * jvp(0, k * rho)
    sd = dlc - 1j * eta * slc
    t = 4.0
    a_mat = np.array(
        [
            [sd * hankel1(0, k * rho), sd * hankel1(0, k * t) * jv(0, k * rho)],
            [sd * hankel1(0, k * t) * jv(0, k * rho), sd * hankel1(0, k * rho)],
        ]
    )
    f = -np.exp(1j * k * np.zeros(2)) * jv(0, k * rho) * np.sqrt(2 * np.pi)
    phi = np.linalg.solve(a_mat, f)
    expected = complex(np.sum(phi * sd * hankel1(0, 2 * k)) / np.sqrt(2 * np.pi))

    c, calc = _two_sphere_problem("a", 1)
    u0 = complex(tonp(calc.uscat(jnp.zeros((2, 1)))).reshape(-1)[0])
    assert abs(u0 - expected) < 1e-12, f"{u0} vs {expected}"


def test_convergence_in_n_end():
    vals = []
    for n_end in (4, 6, 8):
        c, calc = _two_sphere_problem("ba", n_end)
        vals.append(
            complex(tonp(calc.uscat(jnp.zeros((3, 1)))).reshape(-1)[0])
        )
    ref = -0.741332 - 0.669660j  # jascome_output_3d.csv converged
    errs = [abs(v - ref) for v in vals]
    assert errs[1] < errs[0] and errs[2] <= errs[1] * 1.5
    assert errs[2] < 1e-5


def test_boundary_condition_residual():
    # sound-soft: u_scat + u_in must vanish on each sphere surface
    c, calc = _two_sphere_problem("ba", 14)
    rng = np.random.default_rng(3)
    y = rng.normal(size=(3, 50))
    y /= np.linalg.norm(y, axis=0)
    for center in ([0.0, 2.0, 0.0], [0.0, -2.0, 0.0]):
        xs = jnp.asarray(y + tonp(center)[:, None] * 1.0000001)
        us = tonp(calc.uscat(xs))
        ui = tonp(calc.uin(xs))
        assert np.nanmax(np.abs(us + ui)) < 1e-6


def test_robin_bc_and_point_source():
    # Robin (alpha=1, beta=1) with eta coupling; then a point source
    c, calc = _two_sphere_problem("ba", 10, alpha=1.0, beta=1.0)
    u0 = complex(tonp(calc.uscat(jnp.zeros((3, 1)))).reshape(-1)[0])
    assert np.isfinite(u0.real) and np.isfinite(u0.imag)
    # BC residual: alpha (u+uin) + beta d/dn (u+uin) = 0; check via finite diff
    rng = np.random.default_rng(5)
    y = rng.normal(size=(3, 20))
    y /= np.linalg.norm(y, axis=0)
    ctr = np.array([0.0, 2.0, 0.0])[:, None]
    eps = 1e-5
    tot = []
    for shift in (1 + eps, 1 + 3 * eps):
        xs = jnp.asarray(ctr + y * shift)
        tot.append(
            tonp(calc.uscat(xs)).ravel() + tonp(calc.uin(xs)).ravel()
        )
    u_mid = 0.5 * (tot[0] + tot[1])
    dudn = (tot[1] - tot[0]) / (2 * eps)
    assert np.max(np.abs(u_mid + dudn)) < 1e-3

    # point source runs end to end
    k = tonp(1.0)
    src = jnp.asarray(np.array([5.0, 0.0, 0.0]))
    uin, uin_grad = point_source(k=k, source=src, n=0)
    c3 = create_from_branching_types("ba")
    centers = jnp.asarray(np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]))
    calc2 = biem(c3, centers=centers, radii=jnp.ones(2), k=k, n_end=6, uin=uin)
    u = complex(tonp(calc2.uscat(jnp.zeros((3, 1)))).reshape(-1)[0])
    assert np.isfinite(u.real)


def test_far_field_matches_near_field_limit():
    c, calc = _two_sphere_problem("ba", 10)
    xhat = np.array([0.3, 0.5, 0.8])
    xhat /= np.linalg.norm(xhat)
    r = 4000.0
    u_near = complex(
        tonp(calc.uscat(jnp.asarray(xhat[:, None] * r))).reshape(-1)[0]
    )
    u_inf = complex(
        tonp(calc.uscat(jnp.asarray(xhat[:, None]), far_field=True)).reshape(-1)[
            0
        ]
    )
    k = 1.0
    pred = u_inf * np.exp(1j * k * r) / r ** ((3 - 1) / 2)
    assert abs(u_near - pred) / abs(u_near) < 1e-3


def test_single_sphere_fast_path_matches_matrix():
    c = create_from_branching_types("ba")
    k = tonp(1.2)
    uin, _ = plane_wave(k=k, direction=jnp.asarray(np.array([1.0, 0.0, 0.0])))
    common = dict(
        centers=jnp.zeros((1, 3)), radii=jnp.ones(1) * 0.8, k=k, n_end=8, uin=uin
    )
    fast = biem(c, **common)
    full = biem(c, **common, force_matrix=True)
    assert fast.matrix is None and full.matrix is not None
    np.testing.assert_allclose(
        tonp(fast.density), tonp(full.density), rtol=1e-9
    )
    x = jnp.asarray(np.array([[2.0], [1.0], [0.3]]))
    np.testing.assert_allclose(
        tonp(fast.uscat(x)), tonp(full.uscat(x)), rtol=1e-9
    )


def test_nan_masking_inside_spheres():
    c, calc = _two_sphere_problem("ba", 6)
    x = jnp.asarray(np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 0.0]]))  # inside / outside
    u = tonp(calc.uscat(x))
    assert np.isnan(u[0].real) and np.isfinite(u[1].real)
    # per_ball keeps the B axis and masks the whole point
    u2 = tonp(calc.uscat(x, per_ball=True))
    assert u2.shape[-1] == 2 and np.isnan(u2[0]).all()


def test_batched_k_sweep_and_jit():
    c = create_from_branching_types("ba")
    ks = jnp.asarray(np.linspace(0.5, 1.5, 4))
    centers = jnp.broadcast_to(
        jnp.asarray(np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])), (4, 2, 3)
    )
    direction = jnp.broadcast_to(
        jnp.asarray(np.array([1.0, 0.0, 0.0]))[:, None], (3, 4)
    )
    uin, _ = plane_wave(k=ks, direction=direction)

    def run(ks_):
        uin_, _ = plane_wave(k=ks_, direction=direction)
        calc = biem(
            c,
            centers=centers,
            radii=jnp.ones((4, 2)),
            k=ks_,
            n_end=5,
            uin=uin_,
            eta=jnp.ones(4),
        )
        return calc.uscat(jnp.zeros((3, 1)))

    u = tonp(run(ks))
    assert u.shape == (1, 4)
    u_jit = tonp(jax.jit(run)(ks))
    np.testing.assert_allclose(u, u_jit, rtol=1e-10)
    # batch entries must equal independent scalar solves
    for i, kk in enumerate(tonp(ks)):
        uin_i, _ = plane_wave(
            k=jnp.asarray(kk), direction=jnp.asarray(np.array([1.0, 0.0, 0.0]))
        )
        calc_i = biem(
            c,
            centers=centers[0],
            radii=jnp.ones(2),
            k=jnp.asarray(kk),
            n_end=5,
            uin=uin_i,
        )
        u_i = tonp(calc_i.uscat(jnp.zeros((3, 1))))
        np.testing.assert_allclose(u[0, i], u_i[0], rtol=1e-9)


def test_memory_model_parity():
    # reference formula semantics (_biem.py:23-74)
    assert max_memory(c_ndim=3, n_end=6, n_balls=2) == 4 * 36**2
    assert max_memory(c_ndim=4, n_end=3, n_balls=1) == (5 * 27) ** 2 * (11 * 216) * 16
    n = max_n_end(c_ndim=3, memory_limit=10**9, n_balls=2)
    assert max_memory(c_ndim=3, n_end=n, n_balls=2) <= 10**9
    assert max_memory(c_ndim=3, n_end=n + 1, n_balls=2) > 10**9


def test_input_validation():
    c = create_from_branching_types("ba")
    with pytest.raises(ValueError, match="not the same"):
        biem(c, centers=jnp.zeros((1, 2, 3)), radii=jnp.ones(2), k=jnp.asarray(1.0), n_end=3)
    with pytest.raises(ValueError, match="last dimension of centers"):
        biem(c, centers=jnp.zeros((2, 4)), radii=jnp.ones(2), k=jnp.asarray(1.0), n_end=3)
    with pytest.raises(ValueError, match="eta must be real"):
        biem(
            c,
            centers=jnp.zeros((2, 3)),
            radii=jnp.ones(2),
            k=jnp.asarray(1.0),
            eta=jnp.asarray(1.0 + 1j),
            n_end=3,
        )
    with pytest.raises(ValueError, match="uin must be provided"):
        biem(
            c,
            centers=jnp.zeros((2, 3)),
            radii=jnp.ones(2),
            k=jnp.asarray(1.0),
            n_end=3,
            uin_grad=lambda x: x,
        )
    with pytest.warns(UserWarning, match="interior"):
        biem(
            c,
            centers=jnp.asarray([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]),
            radii=jnp.ones(2),
            k=jnp.asarray(1.0),
            eta=jnp.asarray(0.0),
            n_end=2,
        )


def test_result_is_pytree():
    c, calc = _two_sphere_problem("ba", 4)
    leaves = jax.tree_util.tree_leaves(calc)
    assert len(leaves) >= 5
    calc2 = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(calc), leaves
    )
    assert isinstance(calc2, BIEMResultCalculator)
    assert calc2.n_end == calc.n_end


def test_matfree_gmres_matches_direct():
    # Matrix-free offset-grouped GMRES (solver="matfree", concrete 2D
    # centers, no force_matrix) vs the dense direct solve, on a lattice
    # with duplicated offsets (exercises dedup grouping + the rank-1
    # parity mirror) under a Robin BC.
    c = create_from_branching_types("ba")
    g = (np.arange(2) - 0.5) * 4.0
    xx, yy = np.meshgrid(g, g)
    centers = jnp.asarray(np.stack([xx.ravel(), yy.ravel(), np.zeros(4)], axis=1))
    radii = jnp.ones(4)
    k = jnp.asarray(1.3)
    uin, uin_grad = plane_wave(k=k, direction=jnp.asarray([1.0, 0.0, 0.0]))
    kw = dict(
        centers=centers, radii=radii, k=k, n_end=8,
        uin=uin, uin_grad=uin_grad, alpha=1.0, beta=0.5, eta=1.0,
    )
    cal_d = biem(c, **kw, solver="direct")
    cal_m = biem(c, **kw, solver="matfree")
    assert cal_m.matrix is None  # the dense matrix was never formed
    dd = tonp(cal_d.density)
    dm = tonp(cal_m.density)
    assert np.abs(dm - dd).max() / np.abs(dd).max() < 1e-10
    # irregular geometry (no duplicate offsets; P = 1 groups)
    rng = np.random.default_rng(3)
    cen2 = jnp.asarray(rng.normal(size=(3, 3)) * np.array([6.0, 6.0, 3.0]))
    kw2 = dict(
        centers=cen2, radii=jnp.full(3, 0.7), k=k, n_end=8,
        uin=uin, alpha=1.0, beta=0.0, eta=1.0,
    )
    d_d = tonp(biem(c, **kw2, solver="direct").density)
    d_m = tonp(biem(c, **kw2, solver="matfree").density)
    assert np.abs(d_m - d_d).max() / np.abs(d_d).max() < 1e-10


def test_lattice_routing_detection():
    # Host-side lattice detector (biem/_lattice.py): accepts the CLI's
    # square lattices (reference cli.py:170-185) and a z=0 plane lattice
    # embedded in 3D; rejects the two-ball pair and irregular geometry.
    from biem_helmholtz_sphere_tpu.biem._lattice import lattice_routing
    from biem_helmholtz_sphere_tpu.cli._accuracy import (
        lattice_centers,
        pair_centers,
    )

    r = lattice_routing(lattice_centers(4, 2))
    assert r is not None
    axes, spacings, shape, cell2ball, ball2cell = r
    assert shape == (4, 4) and axes == [0, 1]
    np.testing.assert_allclose(spacings, [4.0, 4.0], rtol=1e-12)
    # ball -> cell -> ball roundtrip is the identity
    assert (cell2ball[ball2cell] == np.arange(16)).all()
    # exact reconstruction: centers[cell2ball[i*Ly+j]] == origin + (i, j)*s
    cen = lattice_centers(4, 2)
    grid = cen[cell2ball].reshape(4, 4, 2)
    np.testing.assert_allclose(np.diff(grid[:, :, 0], axis=0), 4.0, rtol=1e-12)
    np.testing.assert_allclose(np.diff(grid[:, :, 1], axis=1), 4.0, rtol=1e-12)

    r3 = lattice_routing(
        np.concatenate([lattice_centers(3, 2), np.zeros((9, 1))], axis=1)
    )
    assert r3 is not None and r3[2] == (3, 3)

    assert lattice_routing(pair_centers(3)) is None  # < 4 balls
    rng_ = np.random.default_rng(3)
    assert lattice_routing(rng_.normal(size=(5, 3)) * 6.0) is None
    # lattice with one sphere moved off-grid is NOT a lattice
    broken = lattice_centers(3, 2)
    broken[4, 0] += 0.37
    assert lattice_routing(broken) is None


def test_lattice_fft_matfree_matches_direct():
    # The FFT block-convolution matvec (biem/_lattice.py) vs the dense
    # direct solve on a 3x3 2D lattice — the geometry family of the
    # reference CLI's n_balls sweeps (reference cli.py:214).  Also checks
    # a batched-k solve through the same path.
    from biem_helmholtz_sphere_tpu.biem._lattice import lattice_routing
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    c = create_from_branching_types("a")
    centers = lattice_centers(3, 2)
    assert lattice_routing(centers) is not None
    radii = jnp.ones(9)
    k = jnp.asarray(1.1)
    uin, uin_grad = plane_wave(k=k, direction=jnp.asarray([1.0, 0.0]))
    kw = dict(
        centers=centers, radii=radii, k=k, n_end=6,
        uin=uin, uin_grad=uin_grad, alpha=1.0, beta=0.5, eta=1.0,
    )
    cal_d = biem(c, **kw, solver="direct")
    cal_m = biem(c, **kw, solver="matfree")
    assert cal_m.matrix is None
    dd = tonp(cal_d.density)
    dm = tonp(cal_m.density)
    assert np.abs(dm - dd).max() / np.abs(dd).max() < 1e-9

    # batched k rides the same compiled FFT matvec
    kb = jnp.asarray([0.9, 1.3])
    nb = 9
    uin_b, _ = plane_wave(
        k=kb, direction=np.broadcast_to(np.array([1.0, 0.0])[:, None], (2, 2))
    )
    kwb = dict(
        centers=np.broadcast_to(centers, (2, nb, 2)),
        radii=np.ones((2, nb)), k=kb, n_end=5, uin=uin_b, eta=tonp(kb * 0 + 1.0),
    )
    db = tonp(biem(c, **kwb, solver="direct").density)
    # batched geometry is not concrete-2D; solve each k via the lattice
    # path and compare rows
    for i, ki in enumerate([0.9, 1.3]):
        ui, _ = plane_wave(k=jnp.asarray(ki), direction=jnp.asarray([1.0, 0.0]))
        di = tonp(
            biem(
                c, centers=centers, radii=jnp.ones(nb), k=jnp.asarray(ki),
                n_end=5, uin=ui, solver="matfree",
            ).density
        )
        assert np.abs(di - db[i]).max() / np.abs(db[i]).max() < 1e-9


def test_auto_policy_prefers_lattice_matfree():
    # solver="auto" routes lattices of >= 64 spheres to the FFT
    # block-convolution matvec (no B^2 matrix), well before the dense
    # memory limit, and matches the dense GMRES solve; dedup-rich
    # mid-size geometries (8 <= B < 64, unique offsets <= pairs/2) get
    # the generic unique-offset matvec (measured 1.9x faster than dense
    # GMRES at the 16-ball bench config); tiny
    # systems keep the dense path.
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    c = create_from_branching_types("a")
    uin, _ = plane_wave(k=jnp.asarray(1.0), direction=jnp.asarray([1.0, 0.0]))
    cal = biem(
        c, centers=lattice_centers(8, 2), radii=jnp.ones(64),
        k=jnp.asarray(1.0), n_end=4, uin=uin,
    )
    assert cal.matrix is None  # lattice-matfree routed
    cal_g = biem(
        c, centers=lattice_centers(8, 2), radii=jnp.ones(64),
        k=jnp.asarray(1.0), n_end=4, uin=uin, solver="gmres",
    )
    da, dg = tonp(cal.density), tonp(cal_g.density)
    assert np.abs(da - dg).max() / np.abs(dg).max() < 1e-9
    cal16 = biem(
        c, centers=lattice_centers(4, 2), radii=jnp.ones(16),
        k=jnp.asarray(1.0), n_end=4, uin=uin,
    )
    # within lu_limit the exact direct solve is KEPT even for
    # dedup-rich mid-size lattices (round-4 policy, accuracy
    # preference; the matfree tier only takes over beyond it —
    # test_auto_policy_keeps_lu_below_limit covers the same bound)
    assert cal16.matrix is not None
    d16 = tonp(cal16.density)
    d16_m = tonp(
        biem(
            c, centers=lattice_centers(4, 2), radii=jnp.ones(16),
            k=jnp.asarray(1.0), n_end=4, uin=uin, solver="matfree",
        ).density
    )
    assert np.abs(d16 - d16_m).max() / np.abs(d16_m).max() < 1e-9
    cal2 = biem(
        c,
        centers=jnp.asarray(np.array([[0.0, 2.0], [0.0, -2.0]])),
        radii=jnp.ones(2),
        k=jnp.asarray(1.0), n_end=4, uin=uin,
    )
    assert cal2.matrix is not None  # tiny system keeps dense


def test_fused_eval_matches_general(rng):
    # The 3D "ba" fused evaluation (biem/_eval_fused.py) against the
    # materialized-harmonics general path: near field, far field,
    # per_ball, and the inside-sphere NaN mask.
    import importlib

    ev = importlib.import_module("biem_helmholtz_sphere_tpu.biem._eval")
    assert ev.is_ba_tree(create_from_branching_types("ba"))
    assert not ev.is_ba_tree(create_from_branching_types("caa"))

    _, calc = _two_sphere_problem("ba", 8, k=1.4)
    x = rng.normal(size=(3, 40)) * 5.0
    xhat = x / np.linalg.norm(x, axis=0)
    u_f = tonp(calc.uscat(jnp.asarray(x)))
    uf_far = tonp(calc.uscat(jnp.asarray(xhat), far_field=True, per_ball=True))
    orig = ev.is_ba_tree
    try:
        ev.is_ba_tree = lambda c: False
        u_g = tonp(calc.uscat(jnp.asarray(x)))
        ug_far = tonp(
            calc.uscat(jnp.asarray(xhat), far_field=True, per_ball=True)
        )
    finally:
        ev.is_ba_tree = orig
    scale = np.nanmax(np.abs(u_g))
    np.testing.assert_allclose(
        np.nan_to_num(u_f), np.nan_to_num(u_g), atol=scale * 1e-12
    )
    np.testing.assert_allclose(
        uf_far, ug_far, atol=np.abs(ug_far).max() * 1e-12
    )
    assert np.isnan(
        u_f[np.linalg.norm(x - np.array([[0.0], [2.0], [0.0]]), axis=0) < 1.0].real
    ).all()
    ui = tonp(calc.uscat(jnp.asarray([[0.0], [2.0], [0.0]])))
    assert np.isnan(ui.real).all()


def test_stable_f32_beyond_overflow():
    # float32 solves used to NaN from n_end ~ k t_min + 20 (h_n overflow
    # in assembly); the scale-compensated path (stable=None -> auto in
    # f32) keeps any n_end finite and convergent.
    c = create_from_branching_types("ba")
    centers = jnp.asarray(np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], np.float32))
    uin, _ = plane_wave(
        k=jnp.float32(1.0), direction=jnp.asarray(np.array([1.0, 0.0, 0.0], np.float32))
    )
    calc = biem(
        c, centers=centers, radii=jnp.ones(2, jnp.float32),
        k=jnp.float32(1.0), n_end=32, uin=uin,
    )
    u = tonp(calc.uscat(jnp.zeros((3, 1), jnp.float32))).ravel()[0]
    assert abs(u - (-0.741333 - 0.669657j)) < 2e-5

    c2 = create_from_branching_types("a")
    centers2 = jnp.asarray(np.array([[0.0, 2.0], [0.0, -2.0]], np.float32))
    uin2, _ = plane_wave(
        k=jnp.float32(1.0), direction=jnp.asarray(np.array([1.0, 0.0], np.float32))
    )
    calc2 = biem(
        c2, centers=centers2, radii=jnp.ones(2, jnp.float32),
        k=jnp.float32(1.0), n_end=128, uin=uin2,
    )
    u2 = tonp(calc2.uscat(jnp.zeros((2, 1), jnp.float32))).ravel()[0]
    assert abs(u2 - (-1.355933 - 0.657813j)) < 1e-5

    # single-sphere diagonal fast path, same overflow regime
    calc3 = biem(
        c, centers=jnp.zeros((1, 3), jnp.float32), radii=jnp.ones(1, jnp.float32),
        k=jnp.float32(1.0), n_end=48, uin=uin,
    )
    u3 = tonp(calc3.uscat(jnp.asarray(np.array([[3.0], [0.0], [0.0]], np.float32)))).ravel()[0]
    assert np.isfinite(u3)


def test_stable_true_matches_unscaled_f64():
    _, calc_p = _two_sphere_problem("ba", 8, k=1.3)
    _, calc_s = _two_sphere_problem("ba", 8, k=1.3, stable=True)
    ref = tonp(calc_p.density)
    got = tonp(calc_s.density)
    np.testing.assert_allclose(got, ref, atol=np.abs(ref).max() * 1e-10)


def test_stable_f64_beyond_f64_overflow():
    # 2D at n_end=512, k=1: |h_{2n}(kt)| needs exponents ~ e^3000 — even
    # float64 assembly overflows; the scaled path stays finite and
    # reproduces the converged golden value.
    _, calc = _two_sphere_problem("a", 512, k=1.0, stable=True)
    u = tonp(calc.uscat(jnp.zeros((2, 1)))).ravel()[0]
    assert abs(u - (-1.355933 - 0.657813j)) < 1e-6, u


def test_stable_scaled_matches_unscaled_caa():
    """The exponent-compensated general band scan (round 3) reproduces
    the unscaled (S|R) on a 'c'-rooted tree to machine eps — the tree
    family the scaled path refused before."""
    from biem_helmholtz_sphere_tpu.coords import from_cartesian
    from biem_helmholtz_sphere_tpu.translation._ops import translation_matrix
    from biem_helmholtz_sphere_tpu.translation._scaled import sr_scaled

    c = create_from_branching_types("caa")
    t = jnp.asarray([[0.4, 3.9, -0.7, 1.2], [1.0, -3.0, 0.4, 0.2]]).T
    t_sph = from_cartesian(c, t)
    k = jnp.asarray(1.3)
    ref = translation_matrix(c, t_sph, 6, k, kind="SR")
    mant, s_mat = sr_scaled(c, t_sph, 6, k)
    got = mant * jnp.exp(s_mat)
    err = np.abs(tonp(got - ref)).max() / np.abs(tonp(ref)).max()
    assert err < 1e-12, err


def test_stable_f32_4d_caa_beyond_overflow():
    # 'c'-rooted 4D tree in float32 past the h_n overflow wall: at
    # k=0.15, t=4.1 the band values |h_n(0.615)| pass 3.4e38 around
    # n ~ 21, so unscaled f32 assembly NaNs from n_end ~ 12; the scaled
    # general band scan (stable auto-on in f32) must stay finite and
    # track the f64 solution.  (Replaces the r2 raise-test: every tree
    # is scale-compensable since round 3.)
    c = create_from_branching_types("caa")
    n_end = 14
    centers64 = np.zeros((2, 4))
    centers64[0, 1] = 2.05
    centers64[1, 1] = -2.05
    dirn = np.zeros(4)
    dirn[0] = 1.0
    k64 = np.asarray(0.15)
    uin64, _ = plane_wave(k=k64, direction=jnp.asarray(dirn))
    truth = biem(
        c,
        centers=jnp.asarray(centers64),
        radii=jnp.ones(2),
        k=jnp.asarray(k64),
        n_end=n_end,
        uin=uin64,
    )
    u64 = tonp(truth.uscat(jnp.zeros((4, 1)))).ravel()[0]

    uin32, _ = plane_wave(
        k=jnp.float32(0.15), direction=jnp.asarray(dirn, jnp.float32)
    )
    calc = biem(
        c,
        centers=jnp.asarray(centers64, jnp.float32),
        radii=jnp.ones(2, jnp.float32),
        k=jnp.float32(0.15),
        n_end=n_end,
        uin=uin32,
    )
    u32 = tonp(calc.uscat(jnp.zeros((4, 1), jnp.float32))).ravel()[0]
    assert np.isfinite(u32.real) and np.isfinite(u32.imag)
    assert abs(u32 - u64) < 1e-4 * max(abs(u64), 1e-6), (u32, u64)


@pytest.mark.parametrize("btype", ["a", "ba", "caa"])
@pytest.mark.parametrize("ab", [(1.0, 0.0), (0.0, 1.0), (1.0, 0.5)])
def test_analytic_plane_wave_rhs_matches_quadrature(btype, ab):
    # plane_wave-tagged callables take the closed-form RHS path; wrapping
    # the closures (tag stripped) forces the quadrature projection.  The
    # two must agree to quadrature-truncation accuracy.
    alpha, beta = ab
    c = create_from_branching_types(btype)
    d = c.c_ndim
    centers = np.zeros((2, d))
    centers[0, 1] = 2.2
    centers[1, 1] = -1.9
    direction = np.zeros(d)
    direction[0] = 2.0
    direction[1] = -1.0
    k = jnp.asarray(1.3)
    uin, uin_grad = plane_wave(k=k, direction=jnp.asarray(direction))

    def solve(u, ug):
        return biem(
            c,
            centers=jnp.asarray(centers),
            radii=jnp.asarray([1.0, 0.7]),
            k=k,
            n_end=8,
            alpha=alpha,
            beta=beta,
            uin=u if alpha else None,
            uin_grad=ug if beta else None,
        )

    calc_a = solve(uin, uin_grad)
    calc_q = solve(
        lambda x, /: uin(x), lambda x, /: uin_grad(x)  # tags stripped
    )
    ref = tonp(calc_q.density)
    got = tonp(calc_a.density)
    np.testing.assert_allclose(got, ref, atol=np.abs(ref).max() * 1e-6)


def test_analytic_plane_wave_rhs_batched_k():
    # leading k batch axis broadcasts through the analytic RHS too
    c = create_from_branching_types("ba")
    ks = jnp.asarray(np.linspace(0.8, 1.4, 3))
    dirs = jnp.broadcast_to(
        jnp.asarray(np.array([1.0, 0.0, 0.0]))[:, None], (3, 3)
    )
    uin, _ = plane_wave(k=ks, direction=dirs)
    centers = jnp.asarray(np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]))
    calc = biem(
        c, centers=jnp.broadcast_to(centers, (3, 2, 3)),
        radii=jnp.ones((3, 2)), k=ks, n_end=6, uin=uin,
    )
    u = tonp(calc.uscat(jnp.zeros((3, 1)), expand_x=True))[0]  # [points, kbatch]
    # middle entry == unbatched solve at that k
    uin1, _ = plane_wave(
        k=ks[1], direction=jnp.asarray(np.array([1.0, 0.0, 0.0]))
    )
    calc1 = biem(
        c, centers=centers, radii=jnp.ones(2), k=ks[1], n_end=6, uin=uin1
    )
    u1 = tonp(calc1.uscat(jnp.zeros((3, 1))))
    np.testing.assert_allclose(u[1], u1, rtol=2e-6)


def test_lattice_64_sphere_converged_value():
    """8x8 lattice of 64 unit spheres in 2D, k=1: self-converged golden
    (stable to 11 digits for n_end in 19..64, accuracy/accuracy.csv).
    The same pipeline at 256 spheres reproduces the REFERENCE's
    committed converged value -0.9986093441-0.0011085159i
    (reference accuracy/accuracy_n_balls_a.csv:82) to 10 decimal
    places, cross-validating translation+assembly+solve+eval; this
    64-sphere pin keeps that regression surface in the fast suite."""
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    c = create_from_branching_types("a")
    centers = jnp.asarray(lattice_centers(8, 2))
    uin, _ = plane_wave(k=jnp.asarray(1.0), direction=jnp.asarray([1.0, 0.0]))
    calc = biem(
        c,
        centers=centers,
        radii=jnp.ones(64),
        k=jnp.asarray(1.0),
        n_end=19,
        uin=uin,
    )
    u0 = complex(tonp(calc.uscat(jnp.zeros((2, 1)))).reshape(-1)[0])
    ref = -1.0537360062 + 0.0214642340j
    assert abs(u0 - ref) < 1e-8, u0


def test_stable_matfree_nonuniform_radii():
    """stable matfree with NON-uniform radii (round 4): the ball-maximum
    exponent folding keeps the f32 unique-offset solve finite at
    overflow-regime n_end (h_31(k*4) overflows plain f32 assembly) and
    matching the f64 dense direct truth; previously stable was silently
    dropped there and the solve NaN'd."""
    c = create_from_branching_types("ba")
    g = (np.arange(2) - 0.5) * 4.0
    xx, yy = np.meshgrid(g, g)
    centers = np.stack([xx.ravel(), yy.ravel(), np.zeros(4)], axis=1)
    radii = np.array([1.0, 0.8, 0.9, 0.7])
    n_end = 32

    # f64 dense direct truth
    uin64, _ = plane_wave(k=jnp.float64(1.0), direction=np.array([1.0, 0.0, 0.0]))
    calc64 = biem(
        c, centers=centers, radii=radii, k=jnp.float64(1.0), n_end=n_end,
        uin=uin64, solver="direct",
    )
    u64 = complex(tonp(calc64.uscat(jnp.zeros((3, 1)))).reshape(-1)[0])

    # f32 explicit matfree (stable=None -> auto-on in f32)
    uin32, _ = plane_wave(
        k=jnp.float32(1.0), direction=np.array([1.0, 0.0, 0.0], np.float32)
    )
    calc32 = biem(
        c, centers=centers.astype(np.float32),
        radii=radii.astype(np.float32), k=jnp.float32(1.0), n_end=n_end,
        uin=uin32, solver="matfree",
    )
    assert calc32.matrix is None
    d32 = tonp(calc32.density)
    assert np.all(np.isfinite(d32)), "stable matfree NaN'd with varied radii"
    u32 = complex(tonp(calc32.uscat(jnp.zeros((3, 1), jnp.float32))).reshape(-1)[0])
    assert abs(u32 - u64) < 5e-4 * abs(u64), (u32, u64)


def test_stable_lattice_op_nonuniform_radii():
    """The lattice-FFT operator's stable build with non-uniform radii:
    mv must match the f64 dense stable matrix application (unit-level —
    the auto policy only routes B >= 64 here, too heavy for smoke)."""
    from biem_helmholtz_sphere_tpu.biem._core import _assemble, _check_biem_inputs
    from biem_helmholtz_sphere_tpu.biem._lattice import lattice_operator
    from biem_helmholtz_sphere_tpu.ops import cplx
    from biem_helmholtz_sphere_tpu.ops.cplx import C
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    c = create_from_branching_types("a")
    centers = lattice_centers(3, 2)
    radii = np.linspace(0.6, 1.0, 9)
    n_end = 12
    k = jnp.float64(1.0)
    cen, rad, kc, eta, al, be = _check_biem_inputs(
        c, centers, radii, k, None, 1.0, 0.0
    )
    op = lattice_operator(c, n_end, centers, rad, kc, eta, al, be, None,
                          stable=True)
    assert op is not None
    mv, diag, _pre = op
    m = _assemble(c, n_end, cen, rad, kc, eta, al, be, None, stable=True)
    n = 9 * (2 * n_end - 1)
    m2 = m.reshape((n, n))
    rng = np.random.default_rng(7)
    x = C.of(jnp.asarray(rng.normal(size=n) + 1j * rng.normal(size=n)))
    y_fft = tonp(mv(x))
    y_dense = tonp(cplx.matvec(m2, x))
    np.testing.assert_allclose(y_fft, y_dense, rtol=2e-9, atol=1e-12)


def test_solver_convergence_diagnostics():
    """GMRES routes surface (relres, iters) on the result (round 4):
    relres meets the solver tolerance; direct solves carry None."""
    c = create_from_branching_types("ba")
    centers = np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
    uin, _ = plane_wave(k=np.asarray(1.0), direction=np.asarray([1.0, 0.0, 0.0]))
    kw = dict(centers=centers, radii=np.ones(2), k=np.asarray(1.0), n_end=6,
              uin=uin)
    cal_d = biem(c, **kw, solver="direct")
    assert cal_d.relres is None and cal_d.iters is None
    cal_g = biem(c, **kw, solver="gmres")
    assert float(cal_g.relres) < 1e-11  # f64 default tol
    assert int(cal_g.iters) >= 1
    cal_m = biem(c, **kw, solver="matfree")
    assert float(cal_m.relres) < 1e-11
    assert int(cal_m.iters) >= 1

    # batched k: diagnostics are PER SYSTEM (round 5) — one hard
    # system must not inflate the easy systems' counts.
    # Nearly-touching spheres make the coupling (and the iteration
    # spread over k) strong: measured [9, 10, 12] at these settings.
    ks = np.array([0.2, 1.0, 6.0])
    uin_b, _ = plane_wave(
        k=jnp.asarray(ks),
        direction=np.broadcast_to(np.array([1.0, 0, 0])[:, None], (3, 3)),
    )
    cal_b = biem(
        c,
        centers=np.broadcast_to(centers / 2.0, (3, 2, 3)),
        radii=np.full((3, 2), 0.95),
        k=jnp.asarray(ks),
        n_end=10,
        uin=uin_b,
        solver="gmres",
    )
    it_b = np.asarray(cal_b.iters)
    rr_b = np.asarray(cal_b.relres)
    assert it_b.shape == (3,) and rr_b.shape == (3,)
    assert np.all(it_b >= 1) and np.all(rr_b < 1e-11)
    # k=6 needs strictly more Krylov steps than k=0.2 here; with the
    # old shared-max semantics all three entries were equal
    assert it_b[2] > it_b[0], it_b


def test_auto_policy_keeps_lu_below_limit():
    """The dedup-rich mid-size matfree tier must NOT
    preempt the exact direct solve for systems within the LU limit —
    auto on a 9-ball lattice at small n_end keeps calc.matrix and
    matches solver="matfree" to iterative tolerance."""
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    c = create_from_branching_types("a")
    centers = lattice_centers(3, 2)  # 9 balls, dedup-rich
    uin, _ = plane_wave(k=np.asarray(1.0), direction=np.asarray([1.0, 0.0]))
    kw = dict(centers=centers, radii=np.ones(9), k=np.asarray(1.0),
              n_end=6, uin=uin)
    cal = biem(c, **kw)  # auto; n_sys = 99 << lu_limit
    assert cal.matrix is not None, "auto demoted a small system to matfree"
    assert cal.relres is None  # direct solve, no iterative diagnostics
    d_m = tonp(biem(c, **kw, solver="matfree").density)
    d_a = tonp(cal.density)
    assert np.abs(d_m - d_a).max() / np.abs(d_a).max() < 1e-9


def test_ba_n_balls_family_coverage_and_truth():
    """Round 4: the 3D 'ba' n_balls family — the one
    reference-committed heatmap with no repo counterpart — now has
    committed rows: f32 accelerator rows to the feasible
    n_end per lattice, f64 CPU truth anchors at 4/16/64 balls.  The f32
    rows agree with the f64 truth at the same cell to the f32 solver
    floor (data parity, no solve)."""
    import csv
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "accuracy",
                        "accuracy.csv")
    f32, f64 = {}, {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            if r["mode"] == "n_balls" and r["branching_types"] == "ba":
                key = (int(r["n_balls"]), int(r["n_end"]))
                val = complex(float(r["uscat_real"]), float(r["uscat_imag"]))
                (f32 if r["dtype"] == "float32" else f64)[key] = val
    for nb, ne_min in ((4, 32), (16, 32), (64, 32), (256, 26), (1024, 19)):
        assert any(k[0] == nb and k[1] >= ne_min for k in f32), (
            f"ba f32 family too shallow at {nb} balls"
        )
    for nb in (4, 16, 64):
        assert any(k[0] == nb and k[1] >= 22 for k in f64), (
            f"ba f64 truth missing at {nb} balls"
        )
    shared = sorted(set(f32) & set(f64))
    assert shared, "no overlapping f32/f64 ba cells"
    worst = max(
        abs(f32[k] - f64[k]) for k in shared if k[1] >= 8
    )
    assert worst < 5e-4, f"f32 family off its f64 truth: {worst:.1e}"
