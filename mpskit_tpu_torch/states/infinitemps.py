"""Uniform (infinite) matrix product states in mixed canonical form
(counterpart of mpskit_tpu/states/infinitemps.py): AL/AR/AC/C over a
periodic unit cell stacked on a leading axis, with constructors that
gauge-fix raw tensors through the fixed-point iteration of
states/gauging.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Defaults
from .gauging import uniform_leftorth, uniform_rightorth


@dataclasses.dataclass(frozen=True)
class InfiniteMPS:
    """AL, AR, AC: (L, D, d, D); C: (L, D, D) with C[i] the bond matrix to
    the right of site i; C[L-1] is the bond between unit cells."""

    AL: torch.Tensor
    AR: torch.Tensor
    AC: torch.Tensor
    C: torch.Tensor

    @property
    def period(self) -> int:
        return self.AL.shape[0]

    def __len__(self) -> int:
        return self.period

    @property
    def D(self) -> int:
        return self.AL.shape[1]

    @property
    def physicaldim(self) -> int:
        return self.AL.shape[2]

    @property
    def dtype(self):
        return self.AL.dtype

    @property
    def device(self):
        return self.AL.device

    @staticmethod
    def from_A(A, tol: float = Defaults.tolgauge) -> "InfiniteMPS":
        """Gauge-fix raw unit-cell tensors A (L, D, d, D)."""
        C0 = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
        AL, _, _ = uniform_leftorth(A, C0, tol)
        return InfiniteMPS.from_AL(AL, tol=tol)

    @staticmethod
    def from_AL(AL, C0=None, tol: float = Defaults.tolgauge) -> "InfiniteMPS":
        """Complete the mixed gauge from left-isometric tensors."""
        if C0 is None:
            C0 = torch.eye(AL.shape[1], dtype=AL.dtype, device=AL.device)
        AR, C, _ = uniform_rightorth(AL, C0, tol)
        AC = torch.einsum("ilpm,imr->ilpr", AL, C)
        return InfiniteMPS(AL, AR, AC, C)

    @staticmethod
    def random(L: int, d: int, D: int, dtype=torch.complex128,
               device="cuda", generator: torch.Generator = None
               ) -> "InfiniteMPS":
        """Gauge-fixed random uniform MPS, on the card unless `device` says
        otherwise. `generator` must live on `device` (None: the global
        generator)."""
        shape = (L, D, d, D)
        if dtype.is_complex:
            rdt = torch.empty((), dtype=dtype).real.dtype
            re = torch.randn(shape, generator=generator, dtype=rdt,
                             device=device)
            im = torch.randn(shape, generator=generator, dtype=rdt,
                             device=device)
            A = torch.complex(re, im)
        else:
            A = torch.randn(shape, generator=generator, dtype=dtype,
                            device=device)
        return InfiniteMPS.from_A(A)

    def repeat(self, n: int) -> "InfiniteMPS":
        """Tile the unit cell n times."""
        return InfiniteMPS(self.AL.repeat(n, 1, 1, 1),
                           self.AR.repeat(n, 1, 1, 1),
                           self.AC.repeat(n, 1, 1, 1),
                           self.C.repeat(n, 1, 1))

    # mixed-gauge fixed points, [bra, ket] index convention
    def rho_right(self, i):
        """Right cap at the bond right of site i (fixed point of the AL
        transfer from the right): rho[m, n] = sum_k conj(C)[m,k] C[n,k]."""
        Ci = self.C[i % self.period]
        return torch.einsum("mk,nk->mn", Ci.conj(), Ci)

    def rho_left(self, i):
        """Left cap at the bond right of site i (fixed point of the AR
        transfer from the left): rho[m, n] = sum_k conj(C)[k,m] C[k,n]."""
        Ci = self.C[i % self.period]
        return torch.einsum("km,kn->mn", Ci.conj(), Ci)

    def rho_rights(self):
        return torch.einsum("imk,ink->imn", self.C.conj(), self.C)

    def rho_lefts(self):
        return torch.einsum("ikm,ikn->imn", self.C.conj(), self.C)

    # the eight fixed points of the four gauge combinations of the
    # unit-cell transfer matrix, closed forms in C; `i` is the site the
    # boundary attaches to (left caps on the bond left of site i, right
    # caps on the bond right of it)
    def _eye(self):
        return torch.eye(self.D, dtype=self.dtype, device=self.device)

    def l_LL(self, i: int = 0):
        """Left fixed point of the AL-AL transfer: identity."""
        return self._eye()

    def l_RR(self, i: int = 0):
        """Left fixed point of the AR-AR transfer: C^dag C at the left bond."""
        return self.rho_left(i - 1)

    def l_RL(self, i: int = 0):
        """Left fixed point of the mixed transfer, AR ket and AL bra: C."""
        return self.C[(i - 1) % self.period]

    def l_LR(self, i: int = 0):
        """Left fixed point of the mixed transfer, AL ket and AR bra: C^dag."""
        return self.C[(i - 1) % self.period].mH

    def r_RR(self, i: int = -1):
        """Right fixed point of the AR-AR transfer: identity."""
        return self._eye()

    def r_LL(self, i: int = -1):
        """Right fixed point of the AL-AL transfer: C C^dag at the right
        bond."""
        return self.rho_right(i)

    def r_RL(self, i: int = -1):
        """Right fixed point of the mixed transfer, AR ket and AL bra:
        conj(C) (the pairing einsum('xy,xy->') is transpose-free)."""
        return self.C[i % self.period].conj()

    def r_LR(self, i: int = -1):
        """Right fixed point of the mixed transfer, AL ket and AR bra: C^T."""
        return self.C[i % self.period].mT
