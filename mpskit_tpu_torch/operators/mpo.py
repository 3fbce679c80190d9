"""Finite-state-machine MPO Hamiltonians (counterpart of
mpskit_tpu/operators/mpo.py).

The FSM is one dense stacked array ``W[i, a, b, s, t]`` (site, left FSM
level, right FSM level, phys-out, phys-in), built and analysed on the host
in numpy; `environments.finite.stack_W` moves it to the device on use.

Conventions: upper-triangular FSM, level 0 = "identity to the left",
level w-1 = "identity to the right"; W[0,0] = W[w-1,w-1] = 1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def decompose_localmpo(O: np.ndarray, tol: float = 1e-12) -> List[np.ndarray]:
    """SVD-chain decomposition of an n-site operator into MPO tensors.

    O has shape (d,)*2n ordered [s1..sn, t1..tn] (outputs then inputs), or
    (d, d) for one site. Returns tensors T_i of shape (k_{i-1}, d, d, k_i)
    with k_0 = k_n = 1, such that contracting the chain reproduces O."""
    O = np.asarray(O)
    if O.ndim == 2:
        dn = O.shape[0]
        return [O.reshape(1, dn, dn, 1)]
    n = O.ndim // 2
    d = O.shape[0]
    # reorder to (s1, t1, s2, t2, ...)
    perm = [i // 2 + (i % 2) * n for i in range(2 * n)]
    carry = O.transpose(perm).reshape(d * d, -1)
    tensors = []
    kprev = 1
    for _ in range(n - 1):
        U, S, Vh = np.linalg.svd(carry.reshape(kprev * d * d, -1),
                                 full_matrices=False)
        rank = max(int(np.sum(S > tol * max(S[0], 1e-30))), 1)
        U, S, Vh = U[:, :rank], S[:rank], Vh[:rank, :]
        tensors.append(U.reshape(kprev, d, d, rank))
        carry = (S[:, None] * Vh).reshape(rank * d * d, -1)
        kprev = rank
    tensors.append(carry.reshape(kprev, d, d, 1))
    return tensors


# classification of FSM diagonal blocks (used by the infinite environment
# solves of a later slice; kept so the metadata matches the JAX package)
DIAG_ZERO = 0
DIAG_IDENTITY = 1
DIAG_SCALAR = 2
DIAG_GENERAL = 3


@dataclasses.dataclass(frozen=True)
class MPOHamiltonian:
    """Upper-triangular FSM MPO Hamiltonian.

    W: (period, w, w, d, d) host numpy array, W[i, a, b, s, t]; the other
    fields are host metadata derived from it by `_analyze`."""

    W: np.ndarray
    nonzero_mask: Tuple[Tuple[bool, ...], ...]  # (w, w), any-site union
    diag_class: Tuple[int, ...]                 # per level, product over cell
    diag_scalar: Tuple[complex, ...]            # scalar value for DIAG_SCALAR

    @property
    def period(self) -> int:
        return self.W.shape[0]

    @property
    def odim(self) -> int:
        return self.W.shape[1]

    @property
    def physicaldim(self) -> int:
        return self.W.shape[3]

    @property
    def dtype(self):
        return self.W.dtype

    @staticmethod
    def _analyze(W: np.ndarray) -> "MPOHamiltonian":
        """Build the structure metadata from a concrete FSM array."""
        W = np.asarray(W)
        L, w = W.shape[0], W.shape[1]
        d = W.shape[3]
        eye = np.eye(d)
        nz = np.zeros((w, w), bool)
        for a in range(w):
            for b in range(w):
                nz[a][b] = np.max(np.abs(W[:, a, b])) > 1e-14
        diag_class = []
        diag_scalar = []
        for a in range(w):
            # product of diagonal scalars across the unit cell
            kind = DIAG_IDENTITY
            coeff = 1.0 + 0.0j
            for i in range(L):
                blk = W[i, a, a]
                if np.max(np.abs(blk)) <= 1e-14:
                    kind = DIAG_ZERO
                    break
                c = np.trace(blk) / d
                if np.max(np.abs(blk - c * eye)) <= 1e-14 * max(1.0, abs(c)):
                    coeff *= c
                else:
                    kind = DIAG_GENERAL
                    break
            if kind == DIAG_IDENTITY and abs(coeff - 1.0) > 1e-14:
                kind = DIAG_SCALAR
            diag_class.append(kind)
            diag_scalar.append(complex(coeff)
                               if kind in (DIAG_IDENTITY, DIAG_SCALAR)
                               else 0.0j)
        return MPOHamiltonian(
            W,
            tuple(tuple(bool(x) for x in row) for row in nz),
            tuple(diag_class),
            tuple(diag_scalar),
        )

    @staticmethod
    def from_dense_W(W) -> "MPOHamiltonian":
        """From a raw (L, w, w, d, d) FSM array."""
        return MPOHamiltonian._analyze(np.asarray(W))

    @staticmethod
    def from_local(O, period: int = 1, dtype=None) -> "MPOHamiltonian":
        """From an n-site local operator O of shape (d,)*2n, summed over all
        length-n windows fully inside the chain."""
        O = np.asarray(O)
        if dtype is not None:
            O = O.astype(dtype)
        tensors = decompose_localmpo(O)
        n = len(tensors)
        d = tensors[0].shape[1]
        ks = [t.shape[3] for t in tensors[:-1]]  # interior bond ranks
        w = 2 + sum(ks)
        W = np.zeros((1, w, w, d, d), O.dtype)
        W[0, 0, 0] = np.eye(d)
        W[0, w - 1, w - 1] = np.eye(d)
        if n == 1:
            W[0, 0, w - 1] += tensors[0][0, :, :, 0]
        else:
            offsets = [1]
            for k in ks[:-1]:
                offsets.append(offsets[-1] + k)
            for j in range(ks[0]):
                W[0, 0, offsets[0] + j] = tensors[0][0, :, :, j]
            for i in range(1, n - 1):
                for jj in range(ks[i - 1]):
                    for mm in range(ks[i]):
                        W[0, offsets[i - 1] + jj, offsets[i] + mm] = \
                            tensors[i][jj, :, :, mm]
            for jj in range(ks[-1]):
                W[0, offsets[-1] + jj, w - 1] = tensors[-1][jj, :, :, 0]
        return MPOHamiltonian._analyze(np.tile(W, (period, 1, 1, 1, 1)))

    def __add__(self, other):
        if np.isscalar(other):
            # per-site energy shift on the (0, end) block
            Wn = self.W.copy()
            for i in range(self.period):
                Wn[i, 0, -1] += other * np.eye(self.physicaldim)
            return MPOHamiltonian._analyze(Wn)
        if isinstance(other, MPOHamiltonian):
            assert (self.period == other.period
                    and self.physicaldim == other.physicaldim)
            L, w1, _, d, _ = self.W.shape
            w2 = other.odim
            w = w1 + w2 - 2
            Wn = np.zeros((L, w, w, d, d),
                          np.result_type(self.W.dtype, other.W.dtype))

            # H1's middle levels -> 1..w1-2, H2's -> w1-1..w-2
            def m1(a):
                return 0 if a == 0 else (w - 1 if a == w1 - 1 else a)

            def m2(a):
                return 0 if a == 0 else (w - 1 if a == w2 - 1 else a + w1 - 2)

            for i in range(L):
                for a in range(w1):
                    for b in range(w1):
                        Wn[i, m1(a), m1(b)] += self.W[i, a, b]
                for a in range(w2):
                    for b in range(w2):
                        # don't double-count the two shared identity blocks
                        if (a, b) in ((0, 0), (w2 - 1, w2 - 1)):
                            continue
                        Wn[i, m2(a), m2(b)] += other.W[i, a, b]
            return MPOHamiltonian._analyze(Wn)
        return NotImplemented

    __radd__ = __add__

    def __mul__(self, a):
        """Scalar multiplication: every FSM path passes exactly one transition
        into the final level, so scaling the last column scales H."""
        Wn = self.W.copy()
        Wn[:, :-1, -1] *= a
        return MPOHamiltonian._analyze(Wn)

    __rmul__ = __mul__

    def to_matrix(self, L: int) -> np.ndarray:
        """Full d^L x d^L Hamiltonian matrix for exact-diagonalization
        checks. Host-side, small L only."""
        w, d = self.odim, self.physicaldim
        E = np.zeros((w, 1, 1), self.W.dtype)
        E[0, 0, 0] = 1.0
        for i in range(L):
            dim = E.shape[1]
            E = np.einsum("aST,abst->bSsTt", E, self.W[i % self.period]).reshape(
                w, dim * d, dim * d)
        return E[-1]
