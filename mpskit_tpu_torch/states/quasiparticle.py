"""Tangent-space quasiparticle states (counterpart of
mpskit_tpu/states/quasiparticle.py).

A left-gauged QP carries its ground states, the left null spaces VL_i of
AL_i (AL^dag VL = 0), the variational blocks X_i and a momentum; the site
excitation tensor is B_i = VL_i X_i, so AL^dag B = 0 holds by
construction. A right-gauged QP mirrors it: B_i = X_i VR_i. The finite
QPs do the same on a padded FiniteMPS, their null spaces taken within the
physically supported block of each site and `mask` marking the supported
X entries. The X blocks are stacked tensors, the vectors of the Krylov
eigensolvers.

The null spaces fix their basis only up to a unitary on the complement,
so the VLs here and the JAX package's differ; `interop` carries the JAX
ones across where a test compares elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tensors.ops import leftorth, rightorth
from .finitemps import FiniteMPS, physical_bond_dims
from .infinitemps import InfiniteMPS


def null_spaces(ALs):
    """VLs (L, D, d, D(d-1)) for stacked left-isometric tensors (L, D, d,
    D): the complement of each site's columns from one complete QR."""
    L, D, d, r = ALs.shape
    Q, _ = torch.linalg.qr(ALs.reshape(L, D * d, r), mode="complete")
    return Q[:, :, r:].reshape(L, D, d, D * d - r)


def right_null_spaces(ARs):
    """VRs (L, D(d-1), d, D) for stacked right-isometric tensors."""
    L, l, d, D = ARs.shape
    Q, _ = torch.linalg.qr(ARs.reshape(L, l, d * D).mH, mode="complete")
    return Q[:, :, l:].mH.reshape(L, d * D - l, d, D)


def _randn(shape, dtype, device, generator):
    """Standard normal entries, complex ones with independent real and
    imaginary parts (as the JAX package draws them)."""
    if dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class LeftGaugedQP:
    """Infinite quasiparticle state; `momentum` is the phase per site,
    `trivial` whether left_gs is right_gs (a non-topological
    excitation)."""

    Xs: torch.Tensor        # (L, D(d-1), D)
    VLs: torch.Tensor       # (L, D, d, D(d-1))
    left_gs: InfiniteMPS
    right_gs: InfiniteMPS
    momentum: float
    trivial: bool

    @property
    def period(self) -> int:
        return self.Xs.shape[0]

    def __len__(self):
        return self.period

    def bs(self):
        """Site excitation tensors B_i = VL_i X_i, (L, D, d, D)."""
        return torch.einsum("ilpk,ikr->ilpr", self.VLs, self.Xs)

    @staticmethod
    def random(psi: InfiniteMPS, momentum: float = 0.0,
               right_gs: Optional[InfiniteMPS] = None,
               generator: torch.Generator = None) -> "LeftGaugedQP":
        """Normalized random X blocks on psi's device; `generator` must
        live there (None: the global generator)."""
        right = right_gs if right_gs is not None else psi
        VLs = null_spaces(psi.AL)
        L, _, _, Dn = VLs.shape
        Xs = _randn((L, Dn, psi.D), psi.dtype, psi.device, generator)
        Xs = Xs / torch.linalg.vector_norm(Xs)
        return LeftGaugedQP(Xs, VLs, psi, right, float(momentum),
                            right_gs is None)


@dataclasses.dataclass(frozen=True)
class RightGaugedQP:
    """Infinite quasiparticle in the right gauge: B_i = X_i VR_i with VR_i
    the right null space of AR_i, so B_i AR_i^dag = 0. Made from a
    LeftGaugedQP by `states.qp_gauge.left_to_right_gauge`."""

    Xs: torch.Tensor        # (L, D, D(d-1))
    VRs: torch.Tensor       # (L, D(d-1), d, D)
    left_gs: InfiniteMPS
    right_gs: InfiniteMPS
    momentum: float
    trivial: bool

    @property
    def period(self) -> int:
        return self.Xs.shape[0]

    def __len__(self):
        return self.period

    def bs(self):
        """Site excitation tensors B_i = X_i VR_i, (L, D, d, D)."""
        return torch.einsum("ilk,ikpr->ilpr", self.Xs, self.VRs)


def finite_null_spaces(ALs, D: int, d: int):
    """Rank-aware null spaces of a padded finite MPS: per site the
    complement is taken within the physically supported (bl*d, br) block
    of AL (complete QR), zero-padded to a static width. Returns (VLs (L, D,
    d, Dn), mask (L, Dn, D) bool)."""
    L = ALs.shape[0]
    dims = physical_bond_dims(L, d, D)
    widths = [int(dims[i]) * d - int(dims[i + 1]) for i in range(L)]
    Dn = max(widths + [1])
    VLs = torch.zeros((L, D, d, Dn), dtype=ALs.dtype, device=ALs.device)
    mask = torch.zeros((L, Dn, D), dtype=torch.bool, device=ALs.device)
    for i in range(L):
        bl, br, wi = int(dims[i]), int(dims[i + 1]), widths[i]
        if wi > 0:
            M = ALs[i, :bl, :, :br].reshape(bl * d, br)
            Q, _ = torch.linalg.qr(M, mode="complete")
            VLs[i, :bl, :, :wi] = Q[:, br:].reshape(bl, d, wi)
            mask[i, :wi, :br] = True
    return VLs, mask


def finite_right_null_spaces(ARs, D: int, d: int):
    """Rank-aware right null spaces of a padded finite MPS, within the
    supported (bl, d*br) block of AR. Returns (VRs (L, Dn, d, D), mask (L,
    D, Dn) bool) with mask marking the supported entries of the right-gauge
    parameters X (D, Dn)."""
    L = ARs.shape[0]
    dims = physical_bond_dims(L, d, D)
    widths = [d * int(dims[i + 1]) - int(dims[i]) for i in range(L)]
    Dn = max(widths + [1])
    VRs = torch.zeros((L, Dn, d, D), dtype=ARs.dtype, device=ARs.device)
    mask = torch.zeros((L, D, Dn), dtype=torch.bool, device=ARs.device)
    for i in range(L):
        bl, br, wi = int(dims[i]), int(dims[i + 1]), widths[i]
        if wi > 0:
            M = ARs[i, :bl, :, :br].reshape(bl, d * br)
            Q, _ = torch.linalg.qr(M.mH, mode="complete")
            VRs[i, :wi, :, :br] = Q[:, bl:].mH.reshape(wi, d, br)
            mask[i, :bl, :wi] = True
    return VRs, mask


@dataclasses.dataclass(frozen=True)
class FiniteQP:
    """Finite-chain quasiparticle: B_i = VL_i X_i; left of B every site is
    AL, right of it AR. `mask` marks the physically supported X entries."""

    Xs: torch.Tensor    # (L, Dn, D)
    VLs: torch.Tensor   # (L, D, d, Dn)
    ALs: torch.Tensor   # ground-state left gauge, every site
    ARs: torch.Tensor   # ground-state right gauge, every site
    mask: torch.Tensor  # (L, Dn, D) bool

    @property
    def length(self):
        return self.Xs.shape[0]

    def bs(self):
        return torch.einsum("ilpk,ikr->ilpr", self.VLs,
                            self.Xs * self.mask.to(self.Xs.dtype))

    @staticmethod
    def random(psi: FiniteMPS, generator: torch.Generator = None
               ) -> "FiniteQP":
        ALs, ARs = full_gauges(psi)
        VLs, mask = finite_null_spaces(ALs, psi.D, psi.physicaldim)
        L, _, _, Dn = VLs.shape
        Xs = _randn((L, Dn, psi.D), psi.dtype, psi.device, generator)
        Xs = Xs * mask.to(Xs.dtype)
        Xs = Xs / torch.linalg.vector_norm(Xs)
        return FiniteQP(Xs, VLs, ALs, ARs, mask)


@dataclasses.dataclass(frozen=True)
class FiniteQPRight:
    """Finite-chain quasiparticle in the right gauge: B_i = X_i VR_i with
    B_i AR_i^dag = 0; the same embedding sum_n |AL..B_n..AR> as FiniteQP."""

    Xs: torch.Tensor    # (L, D, Dn)
    VRs: torch.Tensor   # (L, Dn, d, D)
    ALs: torch.Tensor
    ARs: torch.Tensor
    mask: torch.Tensor  # (L, D, Dn) bool

    @property
    def length(self):
        return self.Xs.shape[0]

    def bs(self):
        return torch.einsum("ilk,ikpr->ilpr",
                            self.Xs * self.mask.to(self.Xs.dtype), self.VRs)


def qp_to_finitemps(qp) -> FiniteMPS:
    """The finite quasiparticle as a plain FiniteMPS of bond dimension 2D:
    site tensors [[AL_n, B_n], [0, AR_n]], entering in the AL block and
    leaving in the AR block (not normalized)."""
    L = qp.length
    D, d = qp.ALs.shape[1], qp.ALs.shape[2]
    Bs = qp.bs()
    out = torch.zeros((L, 2 * D, d, 2 * D), dtype=qp.ALs.dtype,
                      device=qp.ALs.device)
    out[:, :D, :, :D] = qp.ALs
    out[:, :D, :, D:] = Bs
    out[:, D:, :, D:] = qp.ARs
    # left boundary: the physical bond index 0 lives in the AL block
    out[0, D:] = 0
    # right boundary: the walk ends in the AR block, whose physical
    # boundary index D + 0 is remapped to global index 0
    last = torch.zeros_like(out[L - 1])
    last[:, :, 0] = out[L - 1, :, :, D]
    out[L - 1] = last
    return FiniteMPS.from_tensors(out, normalize=False)


def full_gauges(psi: FiniteMPS):
    """(ALs, ARs) with every site's left- and right-gauged tensor valid."""
    L = psi.length
    pl = psi.move_center(L - 1)
    ALs = pl.ALs.clone()
    ALs[L - 1], _ = leftorth(pl.AC)
    pr = psi.move_center(0)
    ARs = pr.ARs.clone()
    _, ARs[0] = rightorth(pr.AC)
    return ALs, ARs
