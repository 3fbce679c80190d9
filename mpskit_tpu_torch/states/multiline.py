"""Multiline MPS (counterpart of mpskit_tpu/states/multiline.py): a
periodic stack of InfiniteMPS rows, the boundary ansatz of a multi-row
2D partition function."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .infinitemps import InfiniteMPS


@dataclasses.dataclass(frozen=True)
class MPSMultiline:
    rows: Tuple[InfiniteMPS, ...]

    @property
    def nrows(self) -> int:
        return len(self.rows)

    @property
    def period(self) -> int:
        return self.rows[0].period

    def row(self, r) -> InfiniteMPS:
        return self.rows[r % self.nrows]

    @staticmethod
    def from_mps(psi: InfiniteMPS, nrows: int = 1) -> "MPSMultiline":
        return MPSMultiline(tuple([psi] * nrows))
