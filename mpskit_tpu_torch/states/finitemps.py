"""Finite matrix product states (counterpart of
mpskit_tpu/states/finitemps.py).

The state is three stacked tensors of uniform shape plus a center index:

- ``ALs (L, D, d, D)``: left-orthonormal tensors, valid for sites < center
- ``ARs (L, D, d, D)``: right-orthonormal tensors, valid for sites > center
- ``AC (D, d, D)``: the center tensor

All virtual bonds are padded to one static D; the padding beyond the
physical bond ranks near the chain ends is exact zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tensors.ops import leftorth, rightorth


def physical_bond_dims(L: int, d: int, D: int) -> np.ndarray:
    """Maximal physical rank of bond i (left of site i), i = 0..L."""
    return np.array([min(d**i, d ** (L - i), D) for i in range(L + 1)])


def support_mask(L: int, d: int, D: int) -> np.ndarray:
    """(L, D, d, D) boolean mask of the physically supported entries of a
    padded finite MPS; multiplying the gauged tensors by it after every
    decomposition keeps the padding exactly zero."""
    dims = physical_bond_dims(L, d, D)
    mask = np.zeros((L, D, d, D), bool)
    for i in range(L):
        mask[i, : dims[i], :, : dims[i + 1]] = True
    return mask


@dataclasses.dataclass(frozen=True)
class FiniteMPS:
    ALs: torch.Tensor  # (L, D, d, D)
    ARs: torch.Tensor  # (L, D, d, D)
    AC: torch.Tensor   # (D, d, D)
    center: int

    @property
    def length(self) -> int:
        return self.ALs.shape[0]

    def __len__(self) -> int:
        return self.length

    @property
    def D(self) -> int:
        return self.ALs.shape[1]

    @property
    def physicaldim(self) -> int:
        return self.ALs.shape[2]

    @property
    def dtype(self):
        return self.AC.dtype

    @property
    def device(self):
        return self.AC.device

    @staticmethod
    def from_tensors(As, normalize: bool = True) -> "FiniteMPS":
        """A right-canonical FiniteMPS (center = 0) from raw stacked site
        tensors As (L, D, d, D) whose padding is exact zeros."""
        L, D = As.shape[0], As.shape[1]
        ARs = torch.empty_like(As)
        # sweep right-to-left: A <- A @ C, then split C', AR. The carry is
        # normalized per step (raw norms multiply up to ~|A|^L and overflow
        # float32 beyond ~20 sites); the true norm is kept in log space.
        C = torch.eye(D, dtype=As.dtype, device=As.device)
        lognrm = torch.zeros((), dtype=torch.float64, device=As.device)
        for i in range(L - 1, -1, -1):
            C, ARs[i] = rightorth(torch.einsum("lpm,mr->lpr", As[i], C))
            nrm = torch.clamp(torch.linalg.vector_norm(C), min=1e-30)
            C = C / nrm
            lognrm = lognrm + torch.log(nrm)
        AC = torch.einsum("lm,mpr->lpr", C, ARs[0])
        if normalize:
            AC = AC / torch.clamp(torch.linalg.vector_norm(AC), min=1e-30)
        else:
            AC = AC * torch.exp(lognrm).to(AC.dtype)
        return FiniteMPS(torch.zeros_like(ARs), ARs, AC, 0)

    @staticmethod
    def random(L: int, d: int, D: int, dtype=torch.complex128,
               device="cpu", generator: torch.Generator = None) -> "FiniteMPS":
        """Random finite MPS with exactly-zero padding outside the physical
        bond ranks. `generator` must live on `device` (None: the global
        generator)."""
        shape = (L, D, d, D)
        if dtype.is_complex:
            rdt = torch.empty((), dtype=dtype).real.dtype
            re = torch.randn(shape, generator=generator, dtype=rdt,
                             device=device)
            im = torch.randn(shape, generator=generator, dtype=rdt,
                             device=device)
            As = torch.complex(re, im)
        else:
            As = torch.randn(shape, generator=generator, dtype=dtype,
                             device=device)
        As = As * torch.as_tensor(support_mask(L, d, D), device=device)
        return FiniteMPS.from_tensors(As)

    def normalize(self) -> "FiniteMPS":
        n = torch.linalg.vector_norm(self.AC)
        return dataclasses.replace(self, AC=self.AC / torch.clamp(n, min=1e-30))

    def norm(self):
        return torch.linalg.vector_norm(self.AC)

    def move_center(self, i: int) -> "FiniteMPS":
        """Shift the orthogonality center to site i (host loop of QR steps).
        Returns a new state; the tensors of self are not modified."""
        ALs, ARs, AC, c = self.ALs, self.ARs, self.AC, self.center
        if c < i:
            ALs = ALs.clone()
        if c > i:
            ARs = ARs.clone()
        while c < i:
            ALs[c], C = leftorth(AC)
            AC = torch.einsum("lm,mpr->lpr", C, ARs[c + 1])
            c += 1
        while c > i:
            C, ARs[c] = rightorth(AC)
            AC = torch.einsum("lpm,mr->lpr", ALs[c - 1], C)
            c -= 1
        return FiniteMPS(ALs, ARs, AC, c)
