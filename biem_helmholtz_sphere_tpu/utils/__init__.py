"""Shared utilities."""

from ._compat import btensorsolve, shift_nth_row_n_steps  # noqa: F401
from ._runtime import (  # noqa: F401
    F32_MATMUL_PRECISION,
    set_matmul_precision,
    setup_compile_cache,
    setup_runtime,
)

import logging
import time
from contextlib import contextmanager

log = logging.getLogger(__name__)


@contextmanager
def timed(label, sink=None):
    """Wall-clock a block (pairs with block_until_ready at call sites)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt
    log.debug("%s: %.4fs", label, dt)
