"""Stacked Krylov basis (counterpart of mpskit_tpu/linalg/basis.py): a
basis of m vectors of one shape is one (m, *shape) tensor, so every
projection is a single matrix-vector product."""

from __future__ import annotations

import torch


def basis_zeros(x, m: int):
    return torch.zeros((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def basis_inner_all(V, w):
    """c[k] = <V[k], w> for all k at once. Zero (unfilled) slots give 0.

    A complex basis enters as the conjugate-transposed operand of one
    product, which cuBLAS reads conjugated in place: `V.conj() @ w` would
    first write a conjugated copy of the whole basis (two per Lanczos
    step, 44 ms of a 431 ms TDVP step's device time on an H100)."""
    m = V.shape[0]
    V2 = V.reshape(m, -1)
    if V.is_complex():
        return (w.reshape(1, -1) @ V2.mH).reshape(m)
    return V2 @ w.reshape(-1)


def basis_combine(V, c):
    """x = sum_k c[k] V[k]."""
    return torch.tensordot(c.to(V.dtype), V, dims=1)
