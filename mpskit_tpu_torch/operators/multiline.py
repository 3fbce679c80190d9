"""Multiline (multi-row) MPOs for 2D partition functions (counterpart of
mpskit_tpu/operators/multiline.py): a periodic stack of MPO rows, each a
DenseMPO or an FSM MPOHamiltonian; row r acts on boundary row r. The
boundary drivers read every row through its stacked site tensors."""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from .mpo import DenseMPO, MPOHamiltonian


@dataclasses.dataclass(frozen=True)
class MPOMultiline:
    rows: Tuple[Union[DenseMPO, MPOHamiltonian], ...]

    @property
    def nrows(self) -> int:
        return len(self.rows)

    @property
    def period(self) -> int:
        return self.rows[0].period

    def row(self, r):
        return self.rows[r % self.nrows]

    @staticmethod
    def from_mpo(mpo, nrows: int = 1) -> "MPOMultiline":
        return MPOMultiline(tuple([mpo] * nrows))
