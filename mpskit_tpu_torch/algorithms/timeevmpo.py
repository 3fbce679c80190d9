"""Time-evolution MPOs (counterpart of mpskit_tpu/algorithms/timeevmpo.py):
`make_time_mpo(H, dt, alg)` with the WI / WII / TaylorCluster approximants
of exp(-i H dt) in MPO form, as host numpy `DenseMPO`s.

The WI and TaylorCluster builders are the JAX package's host numpy
arithmetic as it is. For WII every FSM block is a (d, d) matrix, and the
per-block-pair exponential that the JAX package takes over a 4-tuple of
matrices is taken here over one stacked (4, d, d) tensor, on the CPU in
complex128, by `expm_multiply_arnoldi`.
"""

from __future__ import annotations

import dataclasses
import itertools
from math import factorial

import numpy as np
import torch

from ..linalg.expm import _pade_expm, expm_multiply_arnoldi
from ..operators.mpo import DenseMPO, MPOHamiltonian


@dataclasses.dataclass(frozen=True)
class WII:
    tol: float = 1e-12
    maxiter: int = 100


@dataclasses.dataclass(frozen=True)
class TaylorCluster:
    N: int = 1


def WI() -> TaylorCluster:
    """First-order approximant: WI = TaylorCluster(N=1)."""
    return TaylorCluster(N=1)


def make_time_mpo(H: MPOHamiltonian, dt, alg) -> DenseMPO:
    if isinstance(alg, TaylorCluster):
        return _taylor_mpo(H, dt, alg.N)
    if isinstance(alg, WII):
        return _wii_mpo(H, dt, alg)
    raise TypeError(type(alg))


def _taylor_mpo(H: MPOHamiltonian, dt, N: int) -> DenseMPO:
    """First-order W^I: U = [[1 + tau D, sqrt(tau) C], [sqrt(tau) B, A]]
    where the FSM is [[1, C, D], [0, A, B], [0, 0, 1]] and tau = -i dt."""
    if N != 1:
        return _taylor_mpo_general(H, dt, N)
    W = np.asarray(H.W)
    L, w, _, d, _ = W.shape
    tau = -1j * dt
    sq = np.sqrt(complex(tau))
    wn = w - 1
    out = []
    for i in range(L):
        U = np.zeros((wn, wn, d, d), complex)
        U[0, 0] = np.eye(d) + tau * W[i, 0, w - 1]
        for k in range(1, w - 1):
            U[0, k] = sq * W[i, 0, k]           # C
            U[k, 0] = sq * W[i, k, w - 1]       # B
            for m in range(1, w - 1):
                U[k, m] = W[i, k, m]            # A
        out.append(U)
    return DenseMPO(tuple(out))


def _taylor_mpo_general(H: MPOHamiltonian, dt, N: int) -> DenseMPO:
    """TaylorCluster{N}: the N-th order cluster expansion of exp(tau H) in
    MPO form (arXiv:1901.05824), on the host over the N-fold composite FSM
    (w^N levels): (1) composite product MPO, (2) next-order embedding, (3)
    loopback of boundary composite levels into the start level, (4)
    merging of permutation-equivalent rows/columns, (5) approximate
    compression of interior levels carrying end-markers, (6) orphan
    removal. Every step is dense arithmetic on the stacked (w^N, w^N, d, d)
    block array: absent entries are exact zero blocks."""
    W = np.asarray(H.W).astype(complex)
    L, w, _, d, _ = W.shape
    tau = complex(-1j * dt)
    last = w - 1          # identity-right level
    tuples = list(itertools.product(range(w), repeat=N))
    idx = {t: i for i, t in enumerate(tuples)}
    nW = w ** N

    def prod_elem(loc, ta, tb):
        out = np.eye(d, dtype=complex)
        for j, k in zip(ta, tb):
            out = out @ W[loc, j, k]
        return out

    Us = []
    for loc in range(L):
        M = np.zeros((nW, nW, d, d), complex)
        for a in tuples:
            for b in tuples:
                M[idx[a], idx[b]] = prod_elem(loc, a, b)

        # (2) embed the next Taylor order (no = 1): for eligible (a, b),
        # add every interleaving of one extra (identity-left -> end-marker)
        # leg, weighted by tau * N! / ((N+1)! * n1 * n3)
        no = 1
        corr = np.zeros_like(M)
        for a in tuples:
            if all(x in (0, last) for x in a) and any(x == last for x in a):
                continue
            n1 = sum(x == 0 for x in a) + no
            e_as = [a[:p] + (0,) + a[p:] for p in range(N + 1)]
            for b in tuples:
                if not all(x > 0 for x in b):
                    continue
                n3 = sum(x == last for x in b) + no
                coeff = tau ** no * factorial(N) / (
                    factorial(N + no) * n1 * n3)
                acc = np.zeros((d, d), complex)
                for e_a in e_as:
                    for p in range(N + 1):
                        e_b = b[:p] + (last,) + b[p:]
                        acc += prod_elem(loc, e_a, e_b)
                corr[idx[a], idx[b]] += coeff * acc
        M += corr

        # (3) loopback: composite levels made only of {identity-left,
        # end-marker} fold back into the start level with weight
        # tau^order (N-order)!/N!
        for a in itertools.product((0, last), repeat=N):
            if all(x == 0 for x in a):
                continue
            order = sum(x == last for x in a)
            c = idx[a]
            coeff = tau ** order * factorial(N - order) / factorial(N)
            M[:c, 0] += M[:c, c] * coeff
            M[c, :] = 0.0
            M[:, c] = 0.0

        # (4a) merge permutation-equivalent rows: identity-left legs sort
        # to the back; representatives absorb the others
        for c in tuples:
            s_c = tuple(sorted(c, key=lambda x: 1 if x != 0 else 2))
            n1 = sum(x == 0 for x in c)
            n3 = sum(x == last for x in c)
            if n1 >= n3 and c != s_c:
                M[idx[s_c], :] += M[idx[c], :]
                M[idx[c], :] = 0.0
                M[:, idx[c]] = 0.0

        # (4b) merge permutation-equivalent columns: end-marker legs sort
        # to the back
        for c in tuples:
            s_c = tuple(sorted(c, key=lambda x: 1 if x != last else 2))
            n1 = sum(x == 0 for x in c)
            n3 = sum(x == last for x in c)
            if n3 > n1 and c != s_c:
                M[:, idx[s_c]] += M[:, idx[c]]
                M[:, idx[c]] = 0.0
                M[idx[c], :] = 0.0

        # (5) approximate compression: interior levels carrying n
        # end-markers fold onto the level with those markers replaced by
        # identity-left, with weight tau^n (N-n)!/N!
        for c in tuples:
            n = sum(x == last for x in c)
            if not (all(x > 0 for x in c) and n > 0):
                continue
            transformed = tuple(0 if x == last else x for x in c)
            coeff = tau ** n * factorial(N - n) / factorial(N)
            M[:, idx[transformed]] += M[:, idx[c]] * coeff
            M[:, idx[c]] = 0.0
            M[idx[c], :] = 0.0

        Us.append(M)

    # (6) orphan removal: keep only levels reachable from the start level
    # AND co-reachable to it (the evolution MPO begins and ends at level
    # 0). The union adjacency over sites over-approximates per-site
    # reachability: it can keep an extra level, never drop a needed one.
    adj = sum(np.abs(U).reshape(nW, nW, -1).sum(-1) for U in Us) > 1e-300

    def closure(adjm):
        seen = {0}
        frontier = [0]
        while frontier:
            j = frontier.pop()
            for k in np.nonzero(adjm[j])[0]:
                if k not in seen:
                    seen.add(int(k))
                    frontier.append(int(k))
        return seen

    keep = np.array(sorted(closure(adj) & closure(adj.T)))
    return DenseMPO(tuple(U[np.ix_(keep, keep)] for U in Us))


def _wii_mpo(H: MPOHamiltonian, dt, alg: WII) -> DenseMPO:
    """W^II (arXiv:1901.05824): per middle-block pair (j, k), integrate the
    linear ODE on x = (xD, xC, xB, xA), stacked (4, d, d), generated by
    left-composition with the onsite block D and the couplings C_k / B_j /
    A_jk, evaluated at 1. The Krylov dimension min(4 d^2, 40) spans the
    whole 4 d^2-dimensional space for d <= 3, so the result is exact to
    rounding."""
    W = torch.from_numpy(np.asarray(H.W).astype(np.complex128))
    L, w, _, d, _ = W.shape
    delta = complex(-1j * dt)
    sq = complex(np.sqrt(delta))

    out = []
    for i in range(L):
        D = W[i, 0, w - 1]
        U = np.zeros((w - 1, w - 1, d, d), complex)
        for j in range(1, w - 1):
            for k in range(1, w - 1):
                C, B, A = W[i, 0, k], W[i, j, w - 1], W[i, j, k]

                def mv(x, C=C, B=B, A=A):
                    x1, x2, x3, x4 = x
                    return torch.stack([
                        delta * (x1 @ D),
                        delta * (x2 @ D) + sq * (x1 @ C),
                        delta * (x3 @ D) + sq * (x1 @ B),
                        delta * (x4 @ D) + x1 @ A + sq * (x2 @ B)
                        + sq * (x3 @ C)])

                init = torch.zeros((4, d, d), dtype=torch.complex128)
                init[0] = torch.eye(d, dtype=torch.complex128)
                y = expm_multiply_arnoldi(mv, init, 1.0,
                                          m=min(4 * d * d, 40)).numpy()
                if j == 1 and k == 1:
                    U[0, 0] = y[0]
                U[0, k], U[j, 0], U[j, k] = y[1], y[2], y[3]
        if w == 2:  # no middle blocks: pure onsite evolution
            U[0, 0] = _pade_expm(delta * D.numpy())
        out.append(U)
    return DenseMPO(tuple(out))
