"""Projection operators and linear combinations (counterpart of
mpskit_tpu/operators/projection.py).

`ProjectionOperator(psi)` is |psi><psi| (the penalty term of excited-state
searches); `LinearCombination` is sum_i c_i O_i."""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class ProjectionOperator:
    ket: Any  # a FiniteMPS


@dataclasses.dataclass(frozen=True)
class LinearCombination:
    opps: Tuple[Any, ...]
    coeffs: Tuple[complex, ...]
