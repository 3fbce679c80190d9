"""Effective-Hamiltonian applications (counterpart of
mpskit_tpu/algorithms/derivatives.py).

`ac_apply` and `c_apply` are plain einsums, left to cuBLAS as the JAX
package leaves them to XLA. `ac_apply_fast` is the inexact matvec of the
first Lanczos restart; for float32 on the card it is the hand-written bf16
kernel K1 (kernels/csrc/ac_apply_bf16.cu)."""

from __future__ import annotations

import torch

from ..kernels.ac_apply import ac_apply_bf16


def ac_apply(GL, W, GR, x):
    """H_eff^{AC}(x)[l, s, r] = GL[a,l,y] W[a,b,s,t] x[y,t,n] GR[b,r,n]."""
    t = torch.einsum("axy,ytn->axtn", GL, x)          # w d D^3
    t = torch.einsum("axtn,abst->bxsn", t, W)         # w^2 d^2 D^2
    return torch.einsum("bxsn,brn->xsr", t, GR)       # w d D^3


def ac_apply_fast(GL, W, GR, x):
    """Inexact ac_apply for the first Krylov restart of a site solve.

    Dispatch by device and dtype, as the JAX docstring defines it: a
    float32 tensor on the card goes through the bf16 kernel K1 (bf16
    operands, f32 accumulation, ~3e-3 relative error), which launches or
    raises. On the CPU, and for float64 or complex tensors, the fast and
    the exact matvec coincide and this is `ac_apply`."""
    if x.is_cuda and x.dtype == torch.float32:
        # the kernel takes contiguous operands; einsum outputs (the
        # environment carried through a sweep, the center tensor) may be
        # permuted views, and a copy costs ~1e-3 of a matvec
        return ac_apply_bf16(GL.contiguous(), W.contiguous(),
                             GR.contiguous(), x.contiguous())
    return ac_apply(GL, W, GR, x)


def c_apply(GL, GR, x):
    """H_eff^{C}(x)[l, r] = GL[a,l,y] x[y,n] GR[a,r,n]."""
    t = torch.einsum("axy,yn->axn", GL, x)
    return torch.einsum("axn,arn->xr", t, GR)
