"""Sign-fixed QR/LQ, the MPS gauge moves, null spaces and the truncated
SVD (counterpart of mpskit_tpu/tensors/ops.py).

Conventions: MPS site tensor ``A[l, p, r]``, bond matrix ``C[l, r]``. All
decompositions keep static shapes: a rank-deficient panel keeps its full
width and carries zeros, and a truncation zeroes singular values instead
of dropping them.

`svd_truncated` splits float32 and complex64 matrices on the card through
the Gram matrix (`_svd_via_gram`, the JAX package's TPU route, here in
twice the input's precision) and every other matrix with
`torch.linalg.svd` (see `svd_truncated`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.trace import count, span


def qr_pos(M):
    """Thin QR with the diagonal of R made real-positive (QRpos).
    Returns Q (..., m, k), R (..., k, n) with k = min(m, n); leading axes
    are a batch (each matrix gets its own phases)."""
    with span("qr"):
        Q, R = torch.linalg.qr(M, mode="reduced")
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        ad = d.abs()
        # the |d| > 1e-30 guard keeps zero pivots (the padded,
        # rank-deficient edge panels) at phase 1 instead of 0/0
        phase = torch.where(ad > 1e-30, d / torch.clamp(ad, min=1e-30),
                            torch.ones_like(d))
        return Q * phase.unsqueeze(-2), R * phase.conj().unsqueeze(-1)


def lq_pos(M):
    """Thin LQ with the diagonal of L real-positive: M = L @ Q (batched
    like qr_pos, whose `qr` span it is: the adjoints are views)."""
    Qh, Rh = qr_pos(M.mT.conj())
    return Rh.mT.conj(), Qh.mT.conj()


def cholesky_qr2(M, jitter: float = None):
    """CholeskyQR2: matmul-shaped thin QR for (near-)full-rank panels, R with
    a real positive diagonal. The Gram matrix is Tikhonov-regularized at
    `jitter` * ||M||_F^2, so use it only on full-rank panels."""
    n = M.shape[1]
    if jitter is None:
        single = M.dtype in (torch.float32, torch.complex64)
        jitter = 3e-5 if single else 1e-12
    with span("qr"):
        eps = jitter * torch.linalg.vector_norm(M) ** 2
        eye = torch.eye(n, dtype=M.dtype, device=M.device)
        G = M.mT.conj() @ M + eps * eye
        R1 = torch.linalg.cholesky(G, upper=True)
        Q1 = torch.linalg.solve_triangular(R1, M, upper=True, left=False)
        G2 = Q1.mT.conj() @ Q1 + jitter * eye
        R2 = torch.linalg.cholesky(G2, upper=True)
        Q = torch.linalg.solve_triangular(R2, Q1, upper=True, left=False)
        return Q, R2 @ R1


def leftorth_hybrid(A, full_rank: bool):
    """leftorth with CholeskyQR2 on full-rank bulk panels and Householder
    (qr_pos) otherwise; `full_rank` is a host bool."""
    l, p, r = A.shape
    Q, R = (cholesky_qr2 if full_rank else qr_pos)(A.reshape(l * p, r))
    return Q.reshape(l, p, r), R


def rightorth_hybrid(A, full_rank: bool):
    l, p, r = A.shape
    M = A.reshape(l, p * r).mT.conj()
    Q, R = (cholesky_qr2 if full_rank else qr_pos)(M)
    return R.mT.conj(), Q.mT.conj().reshape(l, p, r)


def orth_in(orth, A, dtype, *args):
    """orth(A, *args) (a gauge move such as leftorth or rightorth) computed
    in `dtype` (None: A's own) and returned in A's dtype."""
    if dtype is None:
        return orth(A, *args)
    return tuple(x.to(A.dtype) for x in orth(A.to(dtype), *args))


def leftorth(A):
    """MPS tensor (l, p, r) -> (AL, C): A = AL @ C with AL left-isometric,
    padded back to A's shape when l*p < r."""
    l, p, r = A.shape
    Q, R = qr_pos(A.reshape(l * p, r))
    k = Q.shape[1]
    if k < r:
        Q = torch.nn.functional.pad(Q, (0, r - k))
        R = torch.nn.functional.pad(R, (0, 0, 0, r - k))
    return Q.reshape(l, p, r), R


def rightorth(A):
    """MPS tensor (l, p, r) -> (C, AR): A = C @ AR with AR right-isometric."""
    l, p, r = A.shape
    L, Q = lq_pos(A.reshape(l, p * r))
    k = Q.shape[0]
    if k < l:
        Q = torch.nn.functional.pad(Q, (0, 0, 0, l - k))
        L = torch.nn.functional.pad(L, (0, l - k))
    return L, Q.reshape(l, p, r)


def leftnull(A):
    """Orthonormal basis of the complement of the columns of A reshaped
    (l*p, r): VL (l, p, l*p - r) with VL^dag A = 0 and VL^dag VL = 1."""
    l, p, r = A.shape
    Q, _ = torch.linalg.qr(A.reshape(l * p, r), mode="complete")
    return Q[:, r:].reshape(l, p, l * p - r)


def rightnull(A):
    """Row-space complement of A reshaped (l, p*r): VR (p*r - l, p, r) with
    A VR^dag = 0 and VR VR^dag = 1."""
    l, p, r = A.shape
    Q, _ = torch.linalg.qr(A.reshape(l, p * r).mH, mode="complete")
    return Q[:, l:].mH.reshape(p * r - l, p, r)


@dataclasses.dataclass(frozen=True)
class TruncationScheme:
    """Static truncation policy (same fields as the JAX package's).

    dim: keep at most `dim` singular values.
    err: also drop the smallest values while the discarded 2-norm fraction
         stays below `err`.
    below: drop singular values below `below` (absolute)."""

    dim: Optional[int] = None
    err: Optional[float] = None
    below: Optional[float] = None


def truncdim(d: int) -> TruncationScheme:
    return TruncationScheme(dim=d)


def truncerr(e: float, dim: Optional[int] = None) -> TruncationScheme:
    return TruncationScheme(err=e, dim=dim)


def truncbelow(e: float, dim: Optional[int] = None) -> TruncationScheme:
    return TruncationScheme(below=e, dim=dim)


def notrunc() -> TruncationScheme:
    return TruncationScheme()


def _svd_via_gram(M, k: int):
    """The k largest singular triplets of M (m, n) from the Hermitian
    eigendecomposition of its smaller Gram matrix, formed in twice M's
    precision: (U (m, k'), S (k',), Vh (k', n), discarded_sq) in M's dtype,
    k' = min(k, m, n), discarded_sq the sum of the other n - k' values of
    S^2, summed in the wider type before the cut.

    The products of float32 entries are exact in float64, so the Gram
    matrix carries only its summation error, and S is resolved down to
    about sqrt(n eps64) S0 (~1e-7 of S0 at n = 768). Only the kept columns
    v and M v / s are formed, and Householder QR (`qr_pos`)
    re-orthonormalizes each side: a column with s well above the floor
    keeps its direction, one with s near zero (the padding of a
    rank-deficient theta) comes out orthonormal instead of 0 / 0."""
    m, n = M.shape
    if n > m:
        # M^H = U' S V'^H, so M = V' S U'^H
        Ut, S, Vht, discarded_sq = _svd_via_gram(M.mH, k)
        return Vht.mH, S, Ut.mH, discarded_sq
    wide = torch.complex128 if M.is_complex() else torch.float64
    M2 = M.to(wide)
    lam, V = torch.linalg.eigh(M2.mH @ M2)
    lam = torch.clamp(lam.flip(0), min=0.0)   # descending
    k = min(k, n)
    # cuSOLVER's `syevd` can return the vectors of a large cluster of zero
    # eigenvalues (the null space of a padded theta) far from orthonormal
    # (7e-2 on an H100); QR leaves the accurate ones as they are
    V, _ = qr_pos(V[:, n - k:].flip(1))
    S = torch.sqrt(lam[:k])
    # below about sqrt(eps64) S0 the values are the Gram matrix's rounding
    floor = torch.clamp(S[:1] * 1e-8, min=torch.finfo(lam.dtype).tiny)
    U, _ = qr_pos((M2 @ V) / torch.maximum(S, floor))
    rdtype = M.real.dtype
    return (U.to(M.dtype), S.to(rdtype), V.mH.to(M.dtype),
            torch.sum(lam[k:]).to(rdtype))


def svd_truncated(M, Dmax: int, trunc: TruncationScheme = TruncationScheme()):
    """SVD of M (m, n) cut or zero-padded to the static width Dmax.

    Returns (U (m, Dmax), S (Dmax,), Vh (Dmax, n), err): the scheme's cut
    is zeros in S and in the matching columns of U and rows of Vh; err is
    the discarded 2-norm fraction sqrt(sum of discarded S^2) / norm, a
    0-dim tensor (no host sync).

    Two routes, chosen by M's device and dtype alone (the `svd` span's
    `kind`):

    - `gram`, float32 and complex64 on the card: `_svd_via_gram`, `eigh`
      of the float64 / complex128 Gram matrix and QR of the kept columns,
      counted by `trace.count("svd_gram")`. On the 768 x 768 float32
      thetas of a spin-1 DMRG2 sweep on an H100, cuSOLVER's QR-based
      `gesvd` took 35-82 ms a split, the card mostly idle behind its
      host-driven bidiagonalization, and the Gram route 9.4-11.1 ms, with
      S, U S Vh and the vectors closer to float64 `gesvd`'s than float32
      `gesvd`'s were. It resolves S to about 1e-7 of S0, the rounding
      floor of a float32 theta itself. The Jacobi `gesvdj`, torch's default below 1024 x 1024, left float32
      vectors 7.9e-4 from orthonormal and put a float32 DMRG2 energy 4.7e-3
      below the float64 one (PERF.md).
    - `gesvd`, every other call: `torch.linalg.svd`, cuSOLVER's `gesvd` on
      the card and LAPACK on the CPU. float64 and complex128 keep it, since
      the Gram route would resolve only about sqrt(eps) of their S0."""
    gram = M.is_cuda and M.dtype in (torch.float32, torch.complex64)
    with span("svd", "gram" if gram else "gesvd"):
        if gram:
            count("svd_gram")
            U, S, Vh, discarded_sq = _svd_via_gram(M, Dmax)
        else:
            U, S, Vh = torch.linalg.svd(M, full_matrices=False,
                                        driver="gesvd" if M.is_cuda else None)
            discarded_sq = torch.sum(S[Dmax:] ** 2)
            U, S, Vh = U[:, :Dmax], S[:Dmax], Vh[:Dmax]
        k = S.shape[0]
        if k < Dmax:
            U = torch.nn.functional.pad(U, (0, Dmax - k))
            Vh = torch.nn.functional.pad(Vh, (0, 0, 0, Dmax - k))
            S = torch.nn.functional.pad(S, (0, Dmax - k))

        keep = torch.ones(Dmax, dtype=torch.bool, device=S.device)
        if trunc.dim is not None and trunc.dim < Dmax:
            keep[trunc.dim:] = False
        if trunc.below is not None:
            keep = keep & (S > trunc.below)
        sq = S ** 2
        total = torch.sum(sq) + discarded_sq
        if trunc.err is not None:
            # tail[i] = sum_{j >= i} S[j]^2 on the descending S: drop the
            # smallest values while the discarded weight stays below err^2
            tail = torch.flip(torch.cumsum(torch.flip(sq, (0,)), 0), (0,))
            keep = keep & ((tail + discarded_sq) > trunc.err ** 2 * total)

        maskf = keep.to(S.dtype)
        disc = discarded_sq + torch.sum(sq * (1.0 - maskf))
        err = torch.sqrt(torch.clamp(disc, min=0.0)
                         / torch.clamp(total, min=1e-30))
        return (U * maskf.to(U.dtype), S * maskf,
                Vh * maskf[:, None].to(Vh.dtype), err)


def isometry(m: int, n: int, dtype=torch.complex128, device="cuda"):
    """The (m, n) isometry embedding C^n into C^m (n <= m), on the card
    unless `device` says otherwise."""
    return torch.eye(m, n, dtype=dtype, device=device)


def safe_xlogx(x):
    """x * log(x) with 0 log 0 = 0."""
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, 1.0)), 0.0)
