"""biem-helmholtz-sphere-tpu: boundary-integral Helmholtz solver on JAX.

A from-scratch JAX/XLA rebuild of the capability surface of
ultrasphere-dev/biem-helmholtz-sphere (acoustic scattering by
non-overlapping hyperspheres in any dimension d >= 2, discretized in
hyperspherical harmonics with addition-theorem coupling), designed
for accelerators: static shapes, batched matmul contractions,
jit/vmap-native batching, mesh sharding for sweeps.  It runs on NVIDIA
GPUs and, for tests, on the CPU.

Public API parity with the reference package
(src/biem_helmholtz_sphere/__init__.py:1-24): `biem`, `biem_u`,
`BIEMResultCalculator`, `plane_wave`, `point_source`, `max_memory`,
`max_n_end`, plus the rebuilt `ultrasphere`-ecosystem layers as
subpackages (`special`, `coords`, `harmonics`, `translation`).
"""

from .biem import (
    BIEMKwargs,
    BIEMResultCalculator,
    BIEMResultCalculatorProtocol,
    UinCallable,
    biem,
    biem_u,
    max_memory,
    max_n_end,
    plane_wave,
    point_source,
)

__version__ = "0.1.0"

__all__ = [
    "biem",
    "biem_u",
    "BIEMResultCalculator",
    "BIEMResultCalculatorProtocol",
    "BIEMKwargs",
    "UinCallable",
    "plane_wave",
    "point_source",
    "max_memory",
    "max_n_end",
    "__version__",
]
