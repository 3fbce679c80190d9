"""The reference-name surface (counterpart of mpskit_tpu/compat.py): the
names of MPSKit.jl's exports whose home in the port carries another name.

A "space" of the reference is an integer dimension here, so the
`*_virtualspace` / `physicalspace` accessors return ints (for padded
finite states, the supported rank of the padded static-D bond).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .environments.finite import finite_environments
from .environments.infinite_ham import hamiltonian_environments
from .environments.infinite_mpo import mpo_environments
from .operators.mpo import DenseMPO, MPOHamiltonian
from .states.finitemps import FiniteMPS, physical_bond_dims
from .states.gauging import uniform_leftorth, uniform_rightorth  # noqa: F401
from .states.infinitemps import InfiniteMPS
from .states.multiline import MPSMultiline
from .transfermatrix.transfer import (  # noqa: F401
    transfer_left, transfer_left_mpo, transfer_right, transfer_right_mpo,
)
from .utils.periodic import PeriodicArray, PeriodicVector  # noqa: F401

# every MPS, MPO and bond tensor is a torch.Tensor with the documented
# index conventions (A[l, p, r], W[a, b, s, t], C[l, r])
MPSTensor = torch.Tensor
MPSBondTensor = torch.Tensor
MPOTensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransferMatrix:
    """Lazy single-site (or stacked multi-site) transfer operator.

    `ket` / `bra` are site tensors (D, d, D) or stacks (L, D, d, D),
    applied left to right, with an optional MPO middle `W` (w, w, d, d)
    or stack (L, w, w, d, d). Calling it applies the operator to an
    environment-shaped tensor from the left; `flip()` reverses the
    direction. Sugar over `transfer_left` / `transfer_right` (and their
    MPO forms), which the hot paths call directly."""

    ket: torch.Tensor
    bra: torch.Tensor
    W: torch.Tensor = None
    flipped: bool = False

    def flip(self) -> "TransferMatrix":
        return dataclasses.replace(self, flipped=not self.flipped)

    def _sites(self):
        ket = self.ket[None] if self.ket.ndim == 3 else self.ket
        bra = self.bra[None] if self.bra.ndim == 3 else self.bra
        if self.W is None:
            Ws = [None] * ket.shape[0]
        else:
            Ws = self.W[None] if self.W.ndim == 4 else self.W
        return ket, bra, Ws

    def __call__(self, v):
        ket, bra, Ws = self._sites()
        order = range(ket.shape[0])
        if self.flipped:
            for i in reversed(order):
                v = (transfer_right(v, ket[i], bra[i]) if Ws[i] is None
                     else transfer_right_mpo(v, Ws[i], ket[i], bra[i]))
            return v
        for i in order:
            v = (transfer_left(v, ket[i], bra[i]) if Ws[i] is None
                 else transfer_left_mpo(v, Ws[i], ket[i], bra[i]))
        return v

    def __mul__(self, other: "TransferMatrix") -> "TransferMatrix":
        """Stack two transfers of one direction: self acts first, then
        other (the operator composition order of the reference's
        ProductTransferMatrix)."""
        if self.flipped != other.flipped or (
                (self.W is None) != (other.W is None)):
            raise ValueError("stacked transfers need one direction and "
                             "both or neither with an MPO middle")

        def cat(a, b):
            return torch.cat([a[None] if a.ndim in (3, 4) else a,
                              b[None] if b.ndim in (3, 4) else b])

        W = None if self.W is None else cat(self.W, other.W)
        return TransferMatrix(cat(self.ket, other.ket),
                              cat(self.bra, other.bra), W, self.flipped)


def environments(psi, O, **kwargs):
    """The environments of <psi| O |psi>: a FiniteEnv for a finite state,
    the geometric-series InfiniteHamEnv for an InfiniteMPS and an
    MPOHamiltonian, the dominant-eigenvector InfiniteMPOEnv for an
    InfiniteMPS or MPSMultiline and a DenseMPO."""
    if isinstance(psi, FiniteMPS):
        return finite_environments(psi, O, **kwargs)
    if isinstance(psi, InfiniteMPS) and isinstance(O, MPOHamiltonian):
        return hamiltonian_environments(psi, O, **kwargs)
    if isinstance(psi, (InfiniteMPS, MPSMultiline)) and isinstance(
            O, DenseMPO):
        return mpo_environments(psi, O, **kwargs)
    raise TypeError(
        f"no environments for ({type(psi).__name__}, {type(O).__name__});"
        " build the specific one from mpskit_tpu_torch.environments")


def leftenv(envs, i: int, psi=None):
    """GL at site i; psi is accepted for the reference's signature (the
    environments here are immutable, never stale)."""
    return envs.leftenv(i)


def rightenv(envs, i: int, psi=None):
    """GR at site i."""
    return envs.rightenv(i)


def add_util_leg(op) -> torch.Tensor:
    """A one-site operator (d_out, d_in) as an MPO site tensor W[a, b, s,
    t] with trivial (dimension-1) virtual legs."""
    op = torch.as_tensor(op)
    if op.ndim != 2:
        raise ValueError(f"add_util_leg takes a (d, d) operator, got shape "
                         f"{tuple(op.shape)}")
    return op[None, None]


def max_Ds(psi: FiniteMPS) -> np.ndarray:
    """The largest possible virtual dimension of each of the L+1 bonds,
    capped at the state's static D: the supported rank of each padded
    bond."""
    return physical_bond_dims(psi.length, psi.physicaldim, psi.D)


def left_virtualspace(psi, i: int = 0) -> int:
    """Dimension of the virtual space left of site i."""
    if isinstance(psi, FiniteMPS):
        return int(max_Ds(psi)[i])
    return int(psi.D)


def right_virtualspace(psi, i: int = -1) -> int:
    """Dimension of the virtual space right of site i."""
    if isinstance(psi, FiniteMPS):
        return int(max_Ds(psi)[i % psi.length + 1])
    return int(psi.D)


def physicalspace(psi, i: int = 0) -> int:
    """Physical dimension at site i."""
    return int(psi.physicaldim)


def effective_excitation_hamiltonian(H, qp, envs=None, right_envs=None,
                                     env_tol: float = 1e-10):
    """(H_eff - E_gs) applied to a LeftGaugedQP: a new QP with the updated
    X blocks, the operator that the QP eigensolve iterates."""
    from .algorithms.excitations import (
        _qp_matvec_infinite, _renorm_energies_infinite,
    )
    from .config import matmul_precision

    with matmul_precision():
        if envs is None:
            envs = hamiltonian_environments(qp.left_gs, H)
        if right_envs is None and qp.right_gs is not qp.left_gs:
            right_envs = hamiltonian_environments(qp.right_gs, H)
        Es = _renorm_energies_infinite(qp.left_gs, H, envs)
        if right_envs is not None:
            Es = (Es + _renorm_energies_infinite(qp.right_gs, H,
                                                 right_envs)) / 2
        GRs = (envs if right_envs is None else right_envs).GRs
        Xs = _qp_matvec_infinite(qp.Xs, qp, H, envs.GLs, GRs, Es, env_tol)
    return dataclasses.replace(qp, Xs=Xs)
