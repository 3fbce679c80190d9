"""Finite-state-machine MPO Hamiltonians (counterpart of
mpskit_tpu/operators/mpo.py).

The FSM is one dense stacked array ``W[i, a, b, s, t]`` (site, left FSM
level, right FSM level, phys-out, phys-in), built and analysed on the host
in numpy; `environments.finite.stack_W` moves it to the device on use.
`DenseMPO` (the evolution operators of `algorithms/timeevmpo.py`, the
statmech transfer MPOs of `models/statmech.py`) is host numpy too, with
its conversions to and from an InfiniteMPS (`mpo_to_mps`, `mps_to_mpo`).

Conventions: upper-triangular FSM, level 0 = "identity to the left",
level w-1 = "identity to the right"; W[0,0] = W[w-1,w-1] = 1.
"""

from __future__ import annotations

import dataclasses
import math
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


# classification of FSM diagonal blocks (picks the solve of each FSM level
# in environments/infinite_ham.py)
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
    # per-site auxiliary abelian charges fused onto the physical legs (set
    # by add_physical_charge)
    aux_charges: Tuple[int, ...] = ()

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

    def site(self, i) -> np.ndarray:
        """Host FSM tensor (w, w, d, d) of site i (periodic); a unit cell's
        device stack is `environments.finite.stack_W`."""
        return self.W[i % self.period]

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

    @staticmethod
    def from_fsm(entries: dict, w: int, d: int, period: int = 1,
                 dtype=np.complex128) -> "MPOHamiltonian":
        """From a dict {(site, a, b): matrix or scalar}; a scalar means
        scalar * identity."""
        W = np.zeros((period, w, w, d, d), dtype)
        for (i, a, b), v in entries.items():
            W[i, a, b] = v * np.eye(d) if np.isscalar(v) else np.asarray(v)
        return MPOHamiltonian._analyze(W)

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

    def __sub__(self, other):
        return self + (other * (-1.0) if isinstance(other, MPOHamiltonian)
                       else -other)

    def __matmul__(self, other: "MPOHamiltonian") -> "MPOHamiltonian":
        """MPO product H1 @ H2 (H2 applied first): the FSM tensor product
        with fused levels (self's level major), not re-compressed, so
        that its numbers are exactly the products of the two FSMs'."""
        if (self.period != other.period
                or self.physicaldim != other.physicaldim):
            raise ValueError("H1 @ H2 needs equal periods and physical "
                             "dimensions")
        L, w1, _, d, _ = self.W.shape
        w2 = other.odim
        Wn = np.einsum("iabst,icdtu->iacbdsu", self.W, other.W).reshape(
            L, w1 * w2, w1 * w2, d, d)
        return MPOHamiltonian._analyze(Wn)

    def repeat(self, n: int) -> "MPOHamiltonian":
        """The unit cell tiled n times."""
        return MPOHamiltonian._analyze(np.tile(self.W, (n, 1, 1, 1, 1)))

    def conj(self) -> "MPOHamiltonian":
        """The Hermitian conjugate: each W[a, b] block conjugate-transposed."""
        return MPOHamiltonian._analyze(
            np.conj(np.transpose(self.W, (0, 1, 2, 4, 3))))

    def remove_orphans(self) -> "MPOHamiltonian":
        """Dead-branch elimination: zero, until nothing changes, the FSM
        levels that are dead starts (an all-zero row at a site kills the
        column that feeds it at the previous site) or dead ends (an
        all-zero column kills the row it feeds at the next site), then
        drop the levels that are dead at every site."""
        W = np.array(self.W)
        tol = 1e-14
        while True:
            L, w = W.shape[0], W.shape[1]
            dead_start = np.ones(w, bool)
            dead_end = np.ones(w, bool)
            for loc in range(L):
                for i in range(w):
                    if np.max(np.abs(W[loc, i, :])) <= tol:
                        W[(loc - 1) % L, :, i] = 0.0
                    else:
                        dead_start[i] = False
                    if np.max(np.abs(W[loc, :, i])) <= tol:
                        W[(loc + 1) % L, i, :] = 0.0
                    else:
                        dead_end[i] = False
            removable = dead_start | dead_end
            if not removable.any():
                break
            keep = np.nonzero(~removable)[0]
            W = W[:, keep][:, :, keep]
        return MPOHamiltonian._analyze(W)

    def add_physical_charge(self, charges) -> "MPOHamiltonian":
        """Fuse a one-dimensional abelian auxiliary charge onto the
        physical leg of each site. Every auxiliary space is
        one-dimensional, so the FSM numbers stay; the cell grows to the
        least common multiple of the two periods and `aux_charges` records
        the charge of each site, for the symmetric-state constructors."""
        charges = tuple(int(c) for c in charges)
        L, Lc = self.period, len(charges)
        period = L * Lc // math.gcd(L, Lc)
        out = MPOHamiltonian._analyze(
            np.tile(self.W, (period // L, 1, 1, 1, 1)))
        return dataclasses.replace(
            out, aux_charges=tuple(charges[i % Lc] for i in range(period)))

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

    def to_densempo(self, L: int, tol: float = 1e-12) -> "DenseMPO":
        """The finite chain of L sites as a DenseMPO with SVD-compressed
        bonds: the FSM embedded densely (the boundary vectors absorbed into
        the edge tensors) and every virtual bond truncated below `tol`,
        which strips the FSM's zero blocks and shrinks the ragged edge
        bonds."""
        data = [np.array(self.site(i)) for i in range(L)]
        data[0] = data[0][:1]          # left boundary selects level 0
        data[-1] = data[-1][:, -1:]    # right boundary selects level w-1
        return DenseMPO(tuple(data)).compress(tol)


@dataclasses.dataclass(frozen=True)
class DenseMPO:
    """Dense MPO, the evolution operators' form: per-site host numpy tensors
    O[i][a, b, s, t] (left, right virtual level, phys-out, phys-in). Finite
    MPOs with ragged edge bonds keep their own shape per site; the device
    copy is made on use (`operators.apply`)."""

    Os: Tuple[np.ndarray, ...]

    @property
    def period(self) -> int:
        return len(self.Os)

    def site(self, i) -> np.ndarray:
        return self.Os[i % self.period]

    @staticmethod
    def from_array(O, period: int = 1) -> "DenseMPO":
        """O: one (w, w, d, d) site tensor repeated `period` times, or a
        list of them."""
        if isinstance(O, (list, tuple)):
            return DenseMPO(tuple(np.asarray(o) for o in O))
        return DenseMPO(tuple([np.asarray(O)] * period))

    def stacked_uniform(self, dtype=None) -> np.ndarray:
        """(L, w, w, d, d) array with ragged edge virtual legs zero-padded
        to one width (valid entries at the leading indices; finite boundary
        vectors select index 0 on both ends)."""
        wmax = max(max(o.shape[0], o.shape[1]) for o in self.Os)
        d = self.Os[0].shape[2]
        out = np.zeros((len(self.Os), wmax, wmax, d, d),
                       dtype or self.Os[0].dtype)
        for i, o in enumerate(self.Os):
            out[i, : o.shape[0], : o.shape[1]] = o
        return out

    def compress(self, tol: float = 1e-12) -> "DenseMPO":
        """SVD compression of the virtual bonds: a left-to-right pass
        truncating each right bond below `tol` (relative to its largest
        singular value), then a right-to-left pass on the left bonds.
        Returns a DenseMPO with (possibly ragged) reduced bonds."""
        data = [np.asarray(o) for o in self.Os]
        L = len(data)

        def trunc_svd(M):
            U, S, Vh = np.linalg.svd(M, full_matrices=False)
            r = max(int(np.sum(S > tol * max(S[0], 1e-300))), 1)
            return U[:, :r], S[:r], Vh[:r]

        # left to right: compress the right leg, push S Vh into the next
        for i in range(L):
            a, b, ds, dt = data[i].shape
            M = data[i].transpose(0, 2, 3, 1).reshape(a * ds * dt, b)
            U, S, Vh = trunc_svd(M)
            data[i] = U.reshape(a, ds, dt, -1).transpose(0, 3, 1, 2)
            nxt = (i + 1) % L
            data[nxt] = np.einsum("rb,bcst->rcst", S[:, None] * Vh,
                                  data[nxt])
        # right to left: compress the left leg, push U S into the previous
        for i in range(L - 1, -1, -1):
            a, b, ds, dt = data[i].shape
            U, S, Vh = trunc_svd(data[i].reshape(a, b * ds * dt))
            data[i] = Vh.reshape(-1, b, ds, dt)
            prv = (i - 1) % L
            data[prv] = np.einsum("abst,br->arst", data[prv],
                                  U * S[None, :])
        return DenseMPO(tuple(data))

    def __matmul__(self, other: "DenseMPO") -> "DenseMPO":
        """(self @ other)|psi> = self(other|psi>): site-wise product with the
        virtual legs fused (self's level major)."""
        assert self.period == other.period
        out = []
        for O1, O2 in zip(self.Os, other.Os):
            d = O1.shape[2]
            out.append(np.einsum("abst,cdtu->acbdsu", O1, O2).reshape(
                O1.shape[0] * O2.shape[0], O1.shape[1] * O2.shape[1], d, d))
        return DenseMPO(tuple(out))


def mpo_to_mps(O: DenseMPO, device="cuda"):
    """The InfiniteMPS of a DenseMPO's site tensors with the two physical
    legs of W[a, b, s, t] fused into one p = (s, t) leg, gauge-fixed on
    `device` (the card unless the caller asks for the CPU). Only the state
    (ray) is kept; `mps_to_mpo` is the inverse."""
    import torch

    from ..states.infinitemps import InfiniteMPS

    As = []
    for i in range(O.period):
        a, b, s, t = O.site(i).shape
        As.append(np.transpose(O.site(i), (0, 2, 3, 1)).reshape(a, s * t, b))
    return InfiniteMPS.from_A(torch.from_numpy(np.stack(As)).to(device))


def mps_to_mpo(psi, d: int) -> DenseMPO:
    """The host DenseMPO whose site tensors are psi's left-gauged tensors
    with the fused physical leg split back into (phys-out, phys-in)."""
    Os = []
    for i in range(psi.period):
        A = psi.AL[i].cpu().resolve_conj().numpy()
        D1, p, D2 = A.shape
        assert p == d * d, "physical leg is not a fused d*d MPO leg"
        Os.append(np.ascontiguousarray(
            np.transpose(A.reshape(D1, d, d, D2), (0, 3, 1, 2))))
    return DenseMPO(tuple(Os))
