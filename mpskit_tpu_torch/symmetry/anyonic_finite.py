"""Anyonic chains in the sector-resolved ("true anyonic") frame of the
PyTorch port (counterpart of mpskit_tpu/symmetry/anyonic_finite.py):
two-site DMRG over height-basis MPS whose bond i carries the fusion-path
charge h_i, with dynamic per-sector bond allocation, and its infinite
two-site IDMRG.

Why two sites: a one-site masked update freezes (the height is both the
physical index and the bond sector, and a one-site H_eff restricted to
the masked manifold keeps only height-diagonal terms). A two-site window
re-creates its middle bond in the split, so the height and its sector
change together.

Why the flat contractions are exact on the masked manifold: left
isometries are exactly flat (each row (l, p1) belongs to the single middle
sector p1), and right tensors are per-block isometric; their cross-sector
Gram blocks never enter a physical contraction, because bra and ket share
the physical height at every site. The two-site eigenvalue is the exact
variational energy.

The split (`anyon_split`) is an independent SVD of each middle-sector ROW
block over all of its admissible columns (rows of different middle
sectors are disjoint, columns are shared), the global top-D Schmidt
values choosing the allocation; the truncation error is exact.

On the card: the (row, column) index tensors of each sector block and the
two-site window masks are built once per (left, right) label pair and
cached on the device, keyed by the labels' bytes; each block is SVD'd on
the device (`gesvd`), and the singular values of all blocks are read to
the host once per bond for the global choice. The eigensolves are
`eigsh_smallest` on mask * ac2_apply(...), started from the masked
two-site tensor. Everything works for multiplicity categories too
(`MultiplicityCategory`): the physical index is q = (h, mu), dimension
n m per site, and the bond labels remain heights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .category import FusionCategory, quantum_entropy, quantum_schmidt
from .fibonacci import _generator


# ---------------------------------------------------------------------------
# category introspection: FusionCategory is the m = 1 case of the
# multiplicity layer; the physical index is q = h m + mu


def _cat_nm(cat) -> Tuple[int, int, np.ndarray]:
    """(n_sectors, max_multiplicity, N) of a FusionCategory (m = 1) or a
    MultiplicityCategory (m = N.max())."""
    m = int(getattr(cat, "mmax", 1))
    return cat.n, m, np.asarray(cat.N, int)


# ---------------------------------------------------------------------------
# static bond-sector allocation (host numpy)


def anyon_bond_labels_finite(cat: FusionCategory, x: int, D: int, L: int,
                             left: int = 0,
                             right: int | None = None) -> List[np.ndarray]:
    """Per-bond sector labels of the L+1 bonds of a finite chain of L
    anyons x: bond i carries the fusion-path charge after i anyons, with
    slot counts proportional to the path weight fwd * bwd, capped at
    min(paths, D). Bond 0 is the boundary charge `left` (one live slot);
    bond L is pinned to `right` (default: the lowest-quantum-dimension
    sector reachable in L steps). Dead slots carry -1. Path counts weight
    each step by the vertex multiplicity N[a, x, b]."""
    n, _, N = _cat_nm(cat)
    fwd = [dict() for _ in range(L + 1)]
    fwd[0][left] = 1.0
    for i in range(L):
        for a, cnt in fwd[i].items():
            for b in cat.fuse(a, x):
                fwd[i + 1][b] = fwd[i + 1].get(b, 0.0) + cnt * N[a, x, b]
    if right is None:
        right = min(fwd[L], key=lambda a: (cat.qdim[a], a))
    right = int(right)
    if right not in fwd[L]:
        raise ValueError(f"sector {right} unreachable in {L} steps from "
                         f"{left}")
    bwd = [dict() for _ in range(L + 1)]
    bwd[L][right] = 1.0
    for i in range(L - 1, -1, -1):
        for a in range(n):
            tot = 0.0
            for b in cat.fuse(a, x):
                tot += bwd[i + 1].get(b, 0.0) * N[a, x, b]
            if tot:
                bwd[i][a] = tot

    labels = []
    for i in range(L + 1):
        live = sorted(set(fwd[i]) & set(bwd[i]))
        bound = {q: min(fwd[i][q], bwd[i][q]) for q in live}
        lab = np.full(D, -1, int)
        if not bound:
            raise ValueError(f"no admissible sectors at bond {i}")
        if sum(bound.values()) <= D:
            alloc = {q: int(b) for q, b in bound.items()}
        else:
            weights = {q: fwd[i][q] * bwd[i][q] for q in bound}
            totw = sum(weights.values())
            alloc = {q: min(int(bound[q]),
                            max(1, int(np.floor(D * weights[q] / totw))))
                     for q in bound}
            while sum(alloc.values()) > D:
                q = min((c for c in alloc if alloc[c] > 0),
                        key=lambda c: weights[c])
                alloc[q] -= 1
            order = sorted(bound, key=lambda q: -weights[q])
            guard = 0
            while sum(alloc.values()) < D and guard < 10 * D:
                guard += 1
                grew = False
                for q in order:
                    if alloc.get(q, 0) < bound[q] and sum(alloc.values()) < D:
                        alloc[q] += 1
                        grew = True
                if not grew:
                    break
        pos = 0
        for q in sorted(alloc, key=lambda q: (-alloc[q], q)):
            k = alloc[q]
            lab[pos: pos + k] = q
            pos += k
        labels.append(lab)
    return labels


def anyon_masks_finite(cat: FusionCategory, x: int,
                       labels: List[np.ndarray]) -> np.ndarray:
    """(L, D, n m, D) boolean site masks: A_j[l, q=(h, mu), r] is
    admissible iff the left slot is live, mu < N[label(l), x, h], and the
    right slot carries exactly h."""
    L = len(labels) - 1
    D = labels[0].shape[0]
    n, m, N = _cat_nm(cat)
    hq = np.repeat(np.arange(n), m)                 # q -> h
    mq = np.tile(np.arange(m), n)                   # q -> mu
    masks = np.zeros((L, D, n * m, D), bool)
    for j in range(L):
        cl, cr = labels[j], labels[j + 1]
        okl = cl >= 0
        adm = np.zeros((D, n * m), bool)            # mu < N[cl[l], x, h]
        adm[okl] = mq[None, :] < N[cl[okl]][:, x][:, hq]
        masks[j] = adm[:, :, None] & (hq[None, :, None]
                                      == cr[None, None, :]) & \
            (cr >= 0)[None, None, :]
    return masks


def anyon_theta_mask(cat: FusionCategory, x: int, cl: np.ndarray,
                     cr: np.ndarray) -> np.ndarray:
    """(D, n m, n m, D) two-site window mask: mu1 < N[label(l), x, h1],
    mu2 < N[h1, x, h2], and the right slot carries exactly h2."""
    D = cl.shape[0]
    n, m, N = _cat_nm(cat)
    hq = np.repeat(np.arange(n), m)
    mq = np.tile(np.arange(m), n)
    okl = cl >= 0
    adm1 = np.zeros((D, n * m), bool)               # (l, q1)
    adm1[okl] = mq[None, :] < N[cl[okl]][:, x][:, hq]
    adm2 = mq[None, :] < N[hq][:, x][:, hq]         # (q1, q2)
    right = (hq[:, None] == cr[None, :]) & (cr >= 0)[None, :]  # (q2, r)
    return (adm1[:, :, None, None] & adm2[None, :, :, None]
            & right[None, None, :, :])


# ---------------------------------------------------------------------------
# device caches, keyed by the labels' bytes

_CACHE: Dict[tuple, object] = {}
_CACHE_MAX = 4096


def _cached(key, build):
    out = _CACHE.get(key)
    if out is None:
        if len(_CACHE) >= _CACHE_MAX:
            _CACHE.clear()
        out = _CACHE[key] = build()
    return out


def _cat_key(cat, x):
    return (cat.name, np.asarray(cat.N).tobytes(), int(x))


def _theta_mask_dev(cat, x, cl, cr, dtype, device):
    """`anyon_theta_mask` as a tensor of `dtype` on `device`, built once
    per label pair."""
    key = ("theta", _cat_key(cat, x), np.asarray(cl).tobytes(),
           np.asarray(cr).tobytes(), dtype, str(device))
    return _cached(key, lambda: torch.as_tensor(
        anyon_theta_mask(cat, x, cl, cr), device=device).to(dtype))


def _split_plan(cat, x, D, cl, cr, device):
    """[(q, rows, cols)] of every middle-sector row block: rows (l, q1 =
    (q, mu1)) with mu1 < N[label(l), x, q], columns the block's admissible
    (q2, r); index tensors on `device`, built once per label pair."""
    def build():
        n, m, N = _cat_nm(cat)
        d = n * m
        live_l = np.where(cl >= 0)[0]
        plan = []
        for q in range(n):
            ri = np.array([l * d + q * m + mu for l in live_l
                           for mu in range(N[cl[l], x, q])], np.int64)
            if len(ri) == 0:
                continue
            ci = np.array([(h2 * m + mu2) * D + r
                           for h2 in cat.fuse(q, x)
                           for mu2 in range(N[q, x, h2])
                           for r in np.where(cr == h2)[0]], np.int64)
            if len(ci) == 0:
                continue
            plan.append((q, torch.as_tensor(ri, device=device),
                         torch.as_tensor(ci, device=device)))
        return plan

    key = ("split", _cat_key(cat, x), int(D), np.asarray(cl).tobytes(),
           np.asarray(cr).tobytes(), str(device))
    return _cached(key, build)


# ---------------------------------------------------------------------------
# the sector-resolved two-site split


def _svd(M):
    return torch.linalg.svd(M, full_matrices=False,
                            driver="gesvd" if M.is_cuda else None)


def _anyon_split(theta, cl, cr, cat, x: int, D: int):
    """`anyon_split` with the Schmidt values also on the host (the one read
    of the bond): (AL, S, AR, labels_mid, err, S_host)."""
    from ..utils.sync import to_host_array

    n, m, _ = _cat_nm(cat)
    d = n * m
    dtype, device = theta.dtype, theta.device
    rdtype = theta.real.dtype if theta.is_complex() else dtype
    M = theta.reshape(D * d, d * D)
    plan = _split_plan(cat, x, D, np.asarray(cl), np.asarray(cr), device)
    svds = []
    for q, ri, ci in plan:
        U, s, Vh = _svd(M[ri][:, ci])
        svds.append((q, ri, ci, U, s, Vh))
    total2 = torch.vdot(M.reshape(-1), M.reshape(-1)).real
    host = to_host_array(total2, *[s for *_, s, _ in svds]).real
    total2 = float(host[0])
    blocks, pos = {}, 1
    for q, ri, ci, U, s, Vh in svds:
        s_h = host[pos: pos + s.shape[0]]
        pos += s.shape[0]
        keep = int(np.sum(s_h > 1e-14 * max(1.0, s_h[0] if len(s_h)
                                             else 0.0)))
        if keep:
            blocks[q] = (ri, ci, U, s, Vh, s_h[:keep])
    allvals = sorted(((float(sv), q, k) for q, blk in blocks.items()
                      for k, sv in enumerate(blk[5])), reverse=True)
    counts: Dict[int, int] = {}
    for _, q, _ in allvals[:D]:
        counts[q] = counts.get(q, 0) + 1
    labels_mid = np.full(D, -1, int)
    AL = torch.zeros((D * d, D), dtype=dtype, device=device)
    AR = torch.zeros((D, d * D), dtype=dtype, device=device)
    S = torch.zeros(D, dtype=rdtype, device=device)
    S_host = np.zeros(D)
    pos, kept2 = 0, 0.0
    for q in sorted(counts, key=lambda q: (-counts[q], q)):
        k = counts[q]
        ri, ci, U, s, Vh, s_h = blocks[q]
        cols = torch.arange(pos, pos + k, device=device)
        labels_mid[pos: pos + k] = q
        AL[ri[:, None], cols[None, :]] = U[:, :k]
        AR[cols[:, None], ci[None, :]] = Vh[:k]
        S[pos: pos + k] = s[:k]
        S_host[pos: pos + k] = s_h[:k]
        kept2 += float(np.sum(s_h[:k] ** 2))
        pos += k
    err = float(np.sqrt(max(total2 - kept2, 0.0) / max(total2, 1e-300)))
    nrm = max(float(np.sqrt(kept2)), 1e-30)
    return (AL.reshape(D, d, D), S / nrm, AR.reshape(D, d, D), labels_mid,
            err, S_host / nrm)


def anyon_split(theta, cl: np.ndarray, cr: np.ndarray,
                cat: FusionCategory, x: int, D: int):
    """Split a masked two-site tensor theta (D, n m, n m, D) at its middle
    bond: an SVD of each middle-sector ROW block (rows (l, q1 = (h1, mu1))
    with h1 = q and mu1 < N[label(l), x, q]; columns the block's
    admissible (q2, r)), then the global top-D Schmidt values across
    sectors (kept above 1e-14 max(1, s0) per block, sectors ordered by
    (-count, q)).

    Returns (AL (D, d, D) flat-left-isometric, S (D,), AR (D, d, D)
    per-block right-isometric, labels_mid (D,) host ints, err host float)
    with AL, S, AR on theta's device. The truncation error is exact (the
    row blocks span orthogonal subspaces)."""
    return _anyon_split(theta, cl, cr, cat, x, D)[:5]


# ---------------------------------------------------------------------------
# state container


@dataclasses.dataclass(frozen=True)
class AnyonicFiniteMPS:
    """Finite MPS of a chain of anyons `anyon` in `cat`, in the
    sector-resolved frame: the dense padded FiniteMPS and static per-bond
    sector labels (labels[i] the path charge of bond i; -1 a dead slot).
    Boundary charges are fixed by construction (bonds 0 and L have one
    live sector each), so no pinning penalties are needed."""

    state: object                        # FiniteMPS
    cat: FusionCategory
    anyon: int
    labels: Tuple[np.ndarray, ...]       # L+1 arrays of shape (D,)
    schmidt_values: Tuple[np.ndarray, ...] | None = None   # bonds 1..L-1

    @property
    def masks(self) -> np.ndarray:
        return anyon_masks_finite(self.cat, self.anyon, list(self.labels))

    @staticmethod
    def random(cat: FusionCategory, anyon: int, D: int, L: int,
               left: int = 0, right: int | None = None, dtype=torch.float64,
               device="cuda", generator: torch.Generator = None
               ) -> "AnyonicFiniteMPS":
        """Masked random start in right-canonical form, on the card unless
        `device` says otherwise. A numpy seed is drawn from `generator` (on
        `device`; None: seeded 0), and the right tensors are
        row-orthonormalized per left sector on the host in the working
        precision (a flat LQ would mix sectors)."""
        from ..states.finitemps import FiniteMPS

        labels = anyon_bond_labels_finite(cat, anyon, D, L, left, right)
        masks = anyon_masks_finite(cat, anyon, labels)
        n, m, _ = _cat_nm(cat)
        d = n * m
        gen = _generator(generator, device)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 device=device).item())
        rng = np.random.default_rng(seed)
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        ARs = np.zeros((L, D, d, D), npdt)
        for j in range(L):
            A = rng.normal(size=(D, d, D)).astype(npdt)
            if np.issubdtype(npdt, np.complexfloating):
                A = A + 1j * rng.normal(size=(D, d, D)).astype(npdt)
            A = A * masks[j]
            M = A.reshape(D, d * D)
            for q in sorted(set(labels[j][labels[j] >= 0].tolist())):
                rows = np.where(labels[j] == q)[0]
                U, s, Vh = np.linalg.svd(M[rows], full_matrices=False)
                r = int(np.sum(s > 1e-12 * max(1.0, s[0] if len(s) else 0)))
                newb = np.zeros_like(M[rows])
                newb[:r] = Vh[:r]
                M[rows] = newb
            # the SVD leaves rounding off the mask
            ARs[j] = M.reshape(D, d, D) * masks[j]
        AC = (rng.normal(size=(D, d, D)) * masks[0]).astype(npdt)
        AC /= max(np.linalg.norm(AC), 1e-30)
        psi = FiniteMPS(torch.zeros((L, D, d, D), dtype=dtype, device=device),
                        torch.as_tensor(ARs, device=device),
                        torch.as_tensor(AC, device=device), 0)
        return AnyonicFiniteMPS(psi, cat, int(anyon),
                                tuple(np.asarray(lab) for lab in labels))

    def schmidt(self, bond: int) -> Dict[int, np.ndarray]:
        """{sector: probabilities} of bond `bond` (1..L-1) under the
        quantum trace, from the last sweep's Schmidt values."""
        S, lab = self._live_bond(bond)
        return quantum_schmidt(self.cat, lab, np.diag(S))

    def entropy(self, bond: int) -> float:
        """Quantum-trace entanglement entropy of bond `bond`."""
        S, lab = self._live_bond(bond)
        return quantum_entropy(self.cat, lab, np.diag(S))

    def _live_bond(self, bond: int):
        S = self._bond_S(bond)
        lab = np.asarray(self.labels[bond], int)
        live = lab >= 0
        return S[live], lab[live]

    def _bond_S(self, bond: int) -> np.ndarray:
        if self.schmidt_values is None:
            raise ValueError("run find_groundstate_anyonic_dmrg2 first")
        if not (1 <= bond <= len(self.labels) - 2):
            raise ValueError(f"interior bonds are 1..{len(self.labels)-2}")
        return np.asarray(self.schmidt_values[bond - 1])


# ---------------------------------------------------------------------------
# the solvers


def _bond_solver(alg, inner_tol):
    from ..algorithms.derivatives import ac2_apply
    from ..linalg.lanczos import eigsh_smallest

    def solve(GL, W1, W2, GR, theta0, mask):
        res = eigsh_smallest(lambda v: mask * ac2_apply(GL, W1, W2, GR, v),
                             theta0 * mask, alg.krylovdim,
                             alg.eig_maxrestarts, inner_tol)
        return res.eigenvector, res.eigenvalue
    return solve


def find_groundstate_anyonic_dmrg2(spsi: AnyonicFiniteMPS, H, alg=None):
    """Sector-resolved two-site DMRG of a finite anyonic chain: each bond's
    eigensolve runs on the card with the window mask inside the Krylov
    matvec (P H_eff P, the manifold restriction), and each split is
    `anyon_split` with dynamic sector allocation. H is the plain
    height-basis chain MPO (e.g. `models.golden_chain()`); the masks pin
    the boundary charges. Returns (AnyonicFiniteMPS, envs, eps), eps the
    change of the energy over the last sweep."""
    from ..algorithms.dmrg2 import DMRG2
    from ..config import VERBOSE_ITER, matmul_precision
    from ..environments.finite import (
        FiniteEnv, compute_left_envs, compute_right_envs, left_boundary,
        right_boundary, stack_W,
    )
    from ..states.finitemps import FiniteMPS
    from ..transfermatrix.transfer import (
        transfer_left_mpo, transfer_right_mpo,
    )
    from ..utils.dynamictols import updatetol
    from ..utils.logging import IterLog

    if alg is None:
        alg = DMRG2()
    cat, x = spsi.cat, spsi.anyon
    psi = spsi.state
    L, D = psi.length, psi.D
    dtype, device = psi.dtype, psi.device
    labels = [np.asarray(lab, int).copy() for lab in spsi.labels]
    Ws = stack_W(H, L, dtype, device)
    w = Ws.shape[1]

    def mask(i):
        return _theta_mask_dev(cat, x, labels[i], labels[i + 2], dtype,
                               device)

    log = IterLog("DMRG2(anyonic)", alg.verbosity)
    eps, lam_prev, lam = 1.0, None, 0.0
    Svals = [None] * (L - 1)
    ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
    with matmul_precision():
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))
        GLs = torch.empty_like(GRs)
        GLs[0] = left_boundary(w, D, dtype, device)
        for it in range(1, alg.maxiter + 1):
            solve = _bond_solver(alg, updatetol(eps, it))
            for i in range(L - 1):                     # left to right
                theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[i + 1])
                theta, lam = solve(GLs[i], Ws[i], Ws[i + 1], GRs[i + 2],
                                   theta, mask(i))
                AL, S, AR, labels[i + 1], _, Svals[i] = _anyon_split(
                    theta, labels[i], labels[i + 2], cat, x, D)
                ALs[i] = AL
                AC = S.to(dtype)[:, None, None] * AR
                GLs[i + 1] = transfer_left_mpo(GLs[i], Ws[i], AL, AL)
            for i in range(L - 2, -1, -1):             # right to left
                theta = torch.einsum("lpm,mqr->lpqr", ALs[i], AC)
                theta, lam = solve(GLs[i], Ws[i], Ws[i + 1], GRs[i + 2],
                                   theta, mask(i))
                AL, S, AR, labels[i + 1], _, Svals[i] = _anyon_split(
                    theta, labels[i], labels[i + 2], cat, x, D)
                ARs[i + 1] = AR
                AC = AL * S.to(dtype)[None, None, :]
                GRs[i + 1] = transfer_right_mpo(GRs[i + 2], Ws[i + 1], AR, AR)
            lam_f = float(np.real(lam))
            eps = abs(lam_f - lam_prev) if lam_prev is not None else 1.0
            lam_prev = lam_f
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam_f, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(alg.maxiter, lam_prev or 0.0, eps)
        psi = FiniteMPS(ALs, ARs, AC, 0)
        GLs = compute_left_envs(ALs, Ws, left_boundary(w, D, dtype, device))
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))
    out = AnyonicFiniteMPS(psi, cat, x, tuple(labels), tuple(Svals))
    return out, FiniteEnv(GLs, GRs), eps


def find_groundstate_anyonic_idmrg2(spsi, H, alg=None):
    """Sector-resolved two-site IDMRG of an infinite anyonic chain
    (`AnyonicInfiniteMPS`, a cell of at least 2): the masked counterpart of
    `find_groundstate_idmrg2` with the middle-bond split replaced by
    `anyon_split`, so every bond's sector allocation is re-derived from
    the two-site wavefunction each pass (which the one-site masked VUMPS
    cannot do). The environments grow by one cell per pass with the
    identity level re-regularized (`idmrg._reg_left` / `_reg_right`).

    Returns (AnyonicInfiniteMPS, envs, dC), dC the change of the last
    bond's Schmidt values over the last pass. The final state keeps the
    per-block gauges (a flat re-gauge would mix sectors)."""
    from ..algorithms.dmrg2 import DMRG2
    from ..algorithms.idmrg import _reg_left, _reg_right
    from ..config import VERBOSE_ITER, matmul_precision
    from ..environments.finite import stack_W
    from ..environments.infinite_ham import hamiltonian_environments
    from ..states.infinitemps import InfiniteMPS
    from ..transfermatrix.transfer import (
        transfer_left_mpo, transfer_right_mpo,
    )
    from ..utils.dynamictols import updatetol
    from ..utils.logging import IterLog
    from .anyonic import AnyonicInfiniteMPS

    if alg is None:
        alg = DMRG2()
    cat, x = spsi.cat, spsi.anyon
    psi = spsi.state
    L, D = psi.period, psi.D
    dtype, device = psi.dtype, psi.device
    if L < 2:
        raise ValueError("two-site IDMRG needs a unit cell of at least 2 "
                         "sites")
    labels = [np.asarray(lab, int).copy() for lab in spsi.labels]
    log = IterLog("IDMRG2(anyonic)", alg.verbosity)
    dC, lam = 1.0, 0.0
    with matmul_precision():
        envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, L, dtype, device)
        GLs = [envs.GLs[i] for i in range(L)]
        GRs = [envs.GRs[i] for i in range(L)]
        ALs = [psi.AL[i] for i in range(L)]
        ARs = [psi.AR[i] for i in range(L)]
        AC = psi.AC[0]
        Ss, S_prev = [None] * L, None

        def mask(i, j):
            return _theta_mask_dev(cat, x, labels[(i - 1) % L], labels[j],
                                   dtype, device)

        for it in range(1, alg.maxiter + 1):
            solve = _bond_solver(alg, updatetol(dC, it))
            GL = GLs[0]
            GL_new = [None] * L
            for i in range(L):                         # left to right
                j = (i + 1) % L
                theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[j])
                theta, lam = solve(GL, Ws[i], Ws[j], GRs[j], theta,
                                   mask(i, j))
                AL, S, AR, labels[i], _, _ = _anyon_split(
                    theta, labels[(i - 1) % L], labels[j], cat, x, D)
                ALs[i] = AL
                Sj = S.to(dtype)
                GL = _reg_left(transfer_left_mpo(GL, Ws[i], AL, AL),
                               torch.diag(Sj))
                GL_new[j] = GL
                AC = Sj[:, None, None] * AR
            GLs = GL_new
            GR = GRs[0]
            GR_new = [None] * L
            for i in range(L - 1, -1, -1):             # right to left
                j = (i + 1) % L
                theta = torch.einsum("lpm,mqr->lpqr", ALs[i], AC)
                theta, lam = solve(GLs[i], Ws[i], Ws[j], GR, theta,
                                   mask(i, j))
                AL, S, AR, labels[i], _, Ss[i] = _anyon_split(
                    theta, labels[(i - 1) % L], labels[j], cat, x, D)
                ARs[j] = AR
                Sj = S.to(dtype)
                GR = _reg_right(transfer_right_mpo(GR, Ws[j], AR, AR),
                                torch.diag(Sj))
                GR_new[i] = GR
                AC = AL * Sj[None, None, :]
            GRs = GR_new
            dC = (float(np.linalg.norm(Ss[L - 1] - S_prev))
                  if S_prev is not None else 1.0)
            S_prev = Ss[L - 1].copy()
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, float(np.real(lam)), dC)
            if dC < alg.tol:
                break
        else:
            log.cancel(alg.maxiter, 0.0, dC)

        Cs = torch.stack([torch.diag(torch.as_tensor(
            Ss[i], device=device).to(dtype)) for i in range(L)])
        AL_st, AR_st = torch.stack(ALs), torch.stack(ARs)
        AC_st = torch.einsum("impq,iqr->impr", AL_st, Cs)
        psi = InfiniteMPS(AL_st, AR_st, AC_st, Cs)
        envs = hamiltonian_environments(psi, H)
    out = AnyonicInfiniteMPS(psi, cat, x,
                             tuple(tuple(int(v) for v in row)
                                   for row in labels))
    return out, envs, dC
