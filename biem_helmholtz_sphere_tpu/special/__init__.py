"""Special functions: the numerical foundation layer.

JAX replacement for the reference's layer 1 (jacobi-poly, scipy
special functions, numba kernels; SURVEY.md section 1 layer 1 and section
2.4): d-dimensional spherical Bessel/Hankel functions and orthonormal
Jacobi/Gegenbauer polynomial recurrences, all pure JAX (jit/vmap).
"""

from ._cyl import cyl_jh01
from ._family import family_jh, spherical_jh_all
from ._jacobi import (
    jacobi_mu0,
    jacobi_recurrence,
    orthonormal_jacobi_all,
    orthonormal_jacobi_table,
)
from ._quad import gauss_jacobi, uniform_circle
from ._shn1 import shn1, sjn

__all__ = [
    "cyl_jh01",
    "family_jh",
    "spherical_jh_all",
    "shn1",
    "sjn",
    "jacobi_mu0",
    "jacobi_recurrence",
    "orthonormal_jacobi_all",
    "orthonormal_jacobi_table",
    "gauss_jacobi",
    "uniform_circle",
]
