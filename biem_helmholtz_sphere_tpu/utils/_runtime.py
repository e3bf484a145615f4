"""Process-wide JAX settings shared by every entry point.

The command line, `bench.py`, `chip_smoke.py` and `__graft_entry__.py`
call these helpers instead of setting JAX options themselves, so the
float32 matmul precision and the compile-cache location are decided in
one place.
"""

import os

# Matmul precision for float32 operands: true float32.  Chosen on an
# H100 by the precision study in PERF.md.  One TF32 pass ("high") fails
# the boundary-residual and complex128-agreement gates of chip_smoke.py.
# The three-pass bf16 preset passes them and is faster, but a dot
# algorithm preset set as the process default applies to every dot:
# it computes float64 operands in float32 as well.  A legacy precision
# name applies to 32-bit operands only, so float64/complex128 work is
# unaffected by this setting.
F32_MATMUL_PRECISION = "highest"

# Compile-cache fallback: fixed inside the checkout (the path is part of
# the cache key, so a moving directory never hits) and gitignored.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def set_matmul_precision():
    """Pin the default matmul precision for float32 work."""
    import jax

    jax.config.update("jax_default_matmul_precision", F32_MATMUL_PRECISION)


def setup_compile_cache():
    """Enable JAX's persistent compilation cache; return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here; otherwise the cache goes to
    `<checkout>/.jax_cache`.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def setup_runtime():
    """Both of the above: what every entry point calls before JAX work."""
    set_matmul_precision()
    return setup_compile_cache()
