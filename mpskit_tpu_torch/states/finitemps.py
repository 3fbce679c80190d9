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
    def from_dense(vec, d: int, D: int, dtype=None,
                   device="cuda") -> "FiniteMPS":
        """A FiniteMPS from a dense state vector of length d^L: an SVD chain
        on the host (numpy, construction time) truncated to the physical
        bond ranks capped at D, padded to the static D and canonicalized
        on `device` (the card unless the caller asks for the CPU). `dtype`
        is a numpy dtype (None keeps the vector's)."""
        vec = np.asarray(vec)
        if dtype is not None:
            vec = vec.astype(dtype)
        n = vec.size
        L = int(round(np.log(n) / np.log(d)))
        if d ** L != n:
            raise ValueError(f"vector length {n} is not a power of d={d}")
        dims = physical_bond_dims(L, d, D)
        As = np.zeros((L, D, d, D), vec.dtype)
        carry, kprev = vec.reshape(1, n), 1
        for i in range(L - 1):
            U, S, Vh = np.linalg.svd(carry.reshape(kprev * d, -1),
                                     full_matrices=False)
            k = min(int(dims[i + 1]), S.shape[0])
            As[i, :kprev, :, :k] = U[:, :k].reshape(kprev, d, k)
            carry, kprev = (S[:k, None] * Vh[:k]).reshape(k, -1), k
        As[L - 1, :kprev, :, :1] = carry.reshape(kprev, d, 1)
        return FiniteMPS.from_tensors(torch.from_numpy(As).to(device))

    @staticmethod
    def random(L: int, d: int, D: int, dtype=torch.complex128,
               device="cuda", generator: torch.Generator = None) -> "FiniteMPS":
        """Random finite MPS with exactly-zero padding outside the physical
        bond ranks, on the card unless `device` says otherwise. `generator`
        must live on `device` (None: the global generator)."""
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

    def bond_matrix(self):
        """C to the right of the center site: AC = AL . C."""
        _, C = leftorth(self.AC)
        return C

    def __add__(self, other: "FiniteMPS") -> "FiniteMPS":
        """State addition by the direct sum of the virtual bonds:
        block-diagonal bulk tensors, the two boundary row and column blocks
        joined on the padded index 0, re-gauged (not normalized). The
        result has bond dimension D1 + D2."""
        L, d = self.length, self.physicaldim
        if other.length != L or other.physicaldim != d:
            raise ValueError("adding states of different lengths or "
                             "physical dimensions")
        D1, Dn = self.D, self.D + other.D
        a = self.move_center(0)
        b = other.move_center(0)
        dt = torch.promote_types(self.dtype, other.dtype)
        out = torch.zeros((L, Dn, d, Dn), dtype=dt, device=self.device)
        out[0, 0, :, :D1] = a.AC[0]
        out[0, 0, :, D1:] = b.AC[0]
        out[1:, :D1, :, :D1] = a.ARs[1:]
        out[1:, D1:, :, D1:] = b.ARs[1:]
        if L > 1:
            # right boundary: fold the second block's boundary column (its
            # index 0, global D1) onto the first's
            out[L - 1, :, :, 0] += out[L - 1, :, :, D1]
            out[L - 1, :, :, D1] = 0
        return FiniteMPS.from_tensors(out, normalize=False)

    def __mul__(self, a):
        return dataclasses.replace(self, AC=self.AC * a)

    __rmul__ = __mul__

    def dot(self, other: "FiniteMPS"):
        """<self | other> (0-dim tensor); the two states may have different
        bond dimensions."""
        a = self.move_center(0)
        b = other.move_center(0)
        dt = torch.promote_types(self.dtype, other.dtype)
        # only the (0, 0) entry of the padded left boundary is physical
        v = torch.zeros((self.D, other.D), dtype=dt, device=self.device)
        v[0, 0] = 1.0
        for i in range(self.length):
            Ta = (a.AC if i == 0 else a.ARs[i]).to(dt)
            Tb = (b.AC if i == 0 else b.ARs[i]).to(dt)
            v = torch.einsum("xy,xsm,ysn->mn", v, Ta.conj(), Tb)
        return v[0, 0]
