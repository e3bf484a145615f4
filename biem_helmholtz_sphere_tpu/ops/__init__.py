"""Low-level ops: real-pair complex arithmetic."""

from . import cplx
from .cplx import C

__all__ = ["cplx", "C"]
