"""Dense (statmech) MPO environments of infinite states (counterpart of
mpskit_tpu/environments/infinite_mpo.py): the left and right environments
are the dominant eigenvectors of the MPO-channel transfer operator of one
unit cell, by restarted Arnoldi, propagated through the cell and
normalized so that <C | GL . GR | C> = 1 at every bond.

The JAX package scans through the cell; here the cell is a host loop that
writes each site's environment to its seat. The anyonic boundaries
(symmetry/fibonacci.py) confine the Arnoldi space to a static sector mask
of the environments (`env_mask`) and select the dominant real eigenpair
(`select_real`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..linalg.arnoldi import dominant_eigs, dominant_eigs_real
from ..states.infinitemps import InfiniteMPS
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo

@dataclasses.dataclass(frozen=True)
class InfiniteMPOEnv:
    """GLs[i] the environment left of site i, GRs[i] the one right of it,
    both (L, w, D, D) device tensors; lambda_cell the dominant transfer
    eigenvalue of one unit cell and resid the worse relative residual of
    the two Arnoldi solves, host numbers."""

    GLs: torch.Tensor
    GRs: torch.Tensor
    lambda_cell: complex
    resid: float = 0.0

    def leftenv(self, i):
        return self.GLs[i]

    def rightenv(self, i):
        return self.GRs[i]


def stack_O(O, L: int, dtype, device):
    """The (L, w, w, d, d) device tensor of an MPO's site tensors (a
    DenseMPO or an FSM MPOHamiltonian row, read through `site(i)`; a
    stacked tensor passes through), cast to `dtype` (a real dtype keeps
    the real part, as `astype` does in the JAX package)."""
    if isinstance(O, torch.Tensor):
        return O
    arr = np.stack([np.asarray(O.site(i)) for i in range(L)])
    if not dtype.is_complex and np.iscomplexobj(arr):
        arr = arr.real
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def cell_transfer_left(Os, A_ket, A_bra, M=None):
    """v -> v pushed left to right through the cell's MPO channel; with a
    (w, D, D) mask M, M * T(M * v)."""
    def mv(v):
        if M is not None:
            v = v * M
        for i in range(Os.shape[0]):
            v = transfer_left_mpo(v, Os[i], A_ket[i], A_bra[i])
        return v if M is None else v * M
    return mv


def cell_transfer_right(Os, A_ket, A_bra, M=None):
    """v -> v pushed right to left through the cell's MPO channel; with a
    (w, D, D) mask M, M * T(M * v)."""
    def mv(v):
        if M is not None:
            v = v * M
        for i in range(Os.shape[0] - 1, -1, -1):
            v = transfer_right_mpo(v, Os[i], A_ket[i], A_bra[i])
        return v if M is None else v * M
    return mv


def mpo_environments(psi_ket: InfiniteMPS, O, psi_bra: InfiniteMPS = None,
                     GL0=None, GR0=None, tol: float = 1e-12,
                     krylovdim: int = 30, env_mask=None,
                     select_real: bool = False) -> InfiniteMPOEnv:
    """Mixed dominant fixed points of the channel transfer operator <bra|
    O |ket> (psi_bra defaults to psi_ket), seeded by GL0 / GR0 (the
    previous fixed points) or by ones + identity. O is a DenseMPO, an FSM
    MPOHamiltonian row or an already stacked (L, w, w, d, d) tensor.

    env_mask, a (w, D, D) boolean array or tensor (the static sector
    alignment (MPO level, bra, ket) of an anyonic boundary), confines the
    Arnoldi space to the mask, so that a near-degenerate sector rotation
    cannot replace the aligned fixed point. select_real takes the dominant
    (near-)real eigenpair (`dominant_eigs_real`) in place of the largest
    in magnitude, for channels whose spurious complex rotation modes sit
    above the physical fixed point."""
    if psi_bra is None:
        psi_bra = psi_ket
    L, D = psi_ket.period, psi_ket.D
    dtype, device = psi_ket.dtype, psi_ket.device
    Os = stack_O(O, L, dtype, device)
    w = Os.shape[1]
    M = (None if env_mask is None
         else torch.as_tensor(env_mask, device=device).to(dtype))

    def seed(G0):
        if G0 is None:
            G0 = (torch.ones((w, D, D), dtype=dtype, device=device)
                  + torch.eye(D, dtype=dtype, device=device)[None])
        return G0 if M is None else G0 * M

    solver = dominant_eigs_real if select_real else dominant_eigs
    resL = solver(cell_transfer_left(Os, psi_ket.AL, psi_bra.AL, M),
                  seed(GL0), krylovdim, 100, tol)
    resR = solver(cell_transfer_right(Os, psi_ket.AR, psi_bra.AR, M),
                  seed(GR0), krylovdim, 100, tol)

    # per-site environments through the cell (unnormalized growth; the
    # cell eigenvalue is divided out once around)
    GLs = torch.empty((L, w, D, D), dtype=dtype, device=device)
    GRs = torch.empty((L, w, D, D), dtype=dtype, device=device)
    v = resL.eigenvector
    for i in range(L):
        GLs[i] = v
        v = transfer_left_mpo(v, Os[i], psi_ket.AL[i], psi_bra.AL[i])
    v = resR.eigenvector
    for i in range(L - 1, -1, -1):
        GRs[i] = v
        v = transfer_right_mpo(v, Os[i], psi_ket.AR[i], psi_bra.AR[i])

    # normalize <C_i | GL_{i+1} GR_i | C_i> = 1 at every bond
    GL_next = torch.roll(GLs, -1, dims=0)
    t = torch.einsum("iaxy,iyn->iaxn", GL_next, psi_ket.C)
    t = torch.einsum("iaxn,iarn->ixr", t, GRs)
    vals = torch.einsum("ixr,ixr->i", psi_bra.C.conj(), t)
    GRs = GRs / vals[:, None, None, None]
    return InfiniteMPOEnv(GLs, GRs, resL.eigenvalue,
                          max(float(np.real(resL.residual)),
                              float(np.real(resR.residual))))


def mpo_transfer_leading(psi: InfiniteMPS, O):
    """Dominant eigenvalue (per unit cell) of the <psi|O|psi> channel."""
    return mpo_environments(psi, O).lambda_cell
