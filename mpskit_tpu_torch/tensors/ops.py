"""Sign-fixed QR/LQ and the MPS gauge moves (counterpart of the parts of
mpskit_tpu/tensors/ops.py on the DMRG path).

Conventions: MPS site tensor ``A[l, p, r]``, bond matrix ``C[l, r]``. All
decompositions keep static shapes: a rank-deficient panel keeps its full
width and carries zeros.
"""

from __future__ import annotations

import torch


def qr_pos(M):
    """Thin QR with the diagonal of R made real-positive (QRpos).
    Returns Q (m, k), R (k, n) with k = min(m, n)."""
    Q, R = torch.linalg.qr(M, mode="reduced")
    d = torch.diagonal(R)
    ad = d.abs()
    # the |d| > 1e-30 guard keeps zero pivots (the padded, rank-deficient
    # edge panels) at phase 1 instead of 0/0
    phase = torch.where(ad > 1e-30, d / torch.clamp(ad, min=1e-30),
                        torch.ones_like(d))
    return Q * phase[None, :], R * phase.conj()[:, None]


def lq_pos(M):
    """Thin LQ with the diagonal of L real-positive: M = L @ Q."""
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
