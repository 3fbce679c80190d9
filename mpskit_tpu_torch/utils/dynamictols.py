"""Dynamic inner-solver tolerances (counterpart of
mpskit_tpu/utils/dynamictols.py)."""

from __future__ import annotations

import math

from ..config import Defaults


def updatetol(epsilon: float, iter: int,
              tol_factor: float = Defaults.tol_factor,
              tol_min: float = Defaults.tol_min,
              tol_max: float = Defaults.tol_max) -> float:
    """tol = clamp(eps * factor / sqrt(iter), tol_min, tol_max), on the host."""
    tol = epsilon * tol_factor / math.sqrt(max(iter, 1))
    return min(max(tol, tol_min), tol_max)
