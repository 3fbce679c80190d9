"""Effective-Hamiltonian applications (counterpart of
mpskit_tpu/algorithms/derivatives.py).

The exact one-site and zero-site products, `ac_apply` and `c_apply`, are
three and two GEMMs on operands laid out so that each GEMM reads them in
place, with no permuted copy: GL as (x, a, y), W as ((s, b), (a, t)) and
GR as (r, b, n), each contiguous (`ac_operands`, `c_operands`). GL, W and
GR stay the same for every matvec of a site solve, so the Krylov drivers
lay them out once a solve and pass them as `prepared`; a one-shot call
lays them out itself. `ac2_apply` is plain einsums, left to cuBLAS as the
JAX package leaves them to XLA. `ac_apply_fast` is the inexact matvec of
the first Lanczos restart; for float32 on the card it is the hand-written
bf16 kernel K1 (kernels/csrc/ac_apply_bf16.cu)."""

from __future__ import annotations

import torch

from ..kernels.ac_apply import ac_apply_bf16
from ..utils.trace import count, span


def ac_operands(GL, W, GR):
    """(GLp, Wm, GRp): GL[a,x,y] as GLp[x,a,y], W[a,b,s,t] as
    Wm[(s,b),(a,t)] and GR[b,r,n] as GRp[r,b,n], each contiguous, for
    `ac_apply(..., prepared=)`. Any input strides."""
    w, v, s, t = W.shape
    return (GL.transpose(0, 1).contiguous(),
            W.permute(2, 1, 0, 3).reshape(s * v, w * t).contiguous(),
            GR.transpose(0, 1).contiguous())


def c_operands(GL, GR):
    """(GLp, GRp) as in `ac_operands`, for `c_apply(..., prepared=)`."""
    return GL.transpose(0, 1).contiguous(), GR.transpose(0, 1).contiguous()


def _ac_gemms(GLp, Wm, GRp, x):
    X, w, Y = GLp.shape
    R, v, N = GRp.shape
    s = Wm.shape[0] // v
    t1 = (GLp.view(X * w, Y) @ x.reshape(Y, -1)).view(X, -1, N)  # w d D^3
    # (x, (s,b), n): one GEMM per x, Wm at batch stride 0 (w^2 d^2 D^2);
    # on the H100 faster than one (D^2 x wd) . (wd x wd) GEMM would be
    t2 = torch.matmul(Wm, t1)
    return (t2.view(X * s, v * N) @ GRp.view(R, v * N).T).view(X, s, R)


def _c_gemms(GLp, GRp, x):
    X, w, Y = GLp.shape
    R = GRp.shape[0]
    t = GLp.view(X * w, Y) @ x
    return t.view(X, -1) @ GRp.view(R, -1).T


def ac_apply(GL, W, GR, x, prepared=None):
    """H_eff^{AC}(x)[l, s, r] = GL[a,l,y] W[a,b,s,t] x[y,t,n] GR[b,r,n].
    prepared: `ac_operands(GL, W, GR)`, laid out once for many calls."""
    if prepared is not None:
        return ac_prepared(*prepared, x)
    GLp, Wm, GRp = ac_operands(GL, W, GR)
    with span("matvec", "exact"):
        return _ac_gemms(GLp, Wm, GRp, x)


def ac_prepared(GLp, Wm, GRp, x):
    """`ac_apply` on operands laid out by `ac_operands` (a `graphs.Bound`
    binds them positionally)."""
    count("matvec_prepared")
    with span("matvec", "exact"):
        return _ac_gemms(GLp, Wm, GRp, x)


def ac_apply_fast(GL, W, GR, x):
    """Inexact ac_apply for the first Krylov restart of a site solve.

    Dispatch by device and dtype, as the JAX docstring defines it: a
    float32 tensor on the card goes through the bf16 kernel K1 (bf16
    operands, f32 accumulation, ~3e-3 relative error), which launches or
    raises; the kernel's wrapper opens the span, its kind naming K1's path.
    On the CPU, and for float64 or complex tensors, the fast and the exact
    matvec coincide and this is `ac_apply` (and its span)."""
    if x.is_cuda and x.dtype == torch.float32:
        # the kernel takes contiguous operands; einsum outputs (the
        # environment carried through a sweep, the center tensor) may be
        # permuted views, and a copy costs ~1e-3 of a matvec
        return ac_apply_bf16(GL.contiguous(), W.contiguous(),
                             GR.contiguous(), x.contiguous())
    return ac_apply(GL, W, GR, x)


def c_apply(GL, GR, x, prepared=None):
    """H_eff^{C}(x)[l, r] = GL[a,l,y] x[y,n] GR[a,r,n].
    prepared: `c_operands(GL, GR)`."""
    if prepared is not None:
        return c_prepared(*prepared, x)
    GLp, GRp = c_operands(GL, GR)
    with span("matvec", "zero-site"):
        return _c_gemms(GLp, GRp, x)


def c_prepared(GLp, GRp, x):
    """`c_apply` on operands laid out by `c_operands`."""
    count("matvec_prepared")
    with span("matvec", "zero-site"):
        return _c_gemms(GLp, GRp, x)


def ac2_apply(GL, W1, W2, GR, x):
    """Two-site derivative: x[l, s1, s2, r] ->
    GL[a,l,y] W1[a,b,s1,t1] W2[b,c,s2,t2] x[y,t1,t2,n] GR[c,r,n]."""
    with span("matvec", "two-site"):
        t = torch.einsum("axy,yuvn->axuvn", GL, x)          # w d^2 D^3
        t = torch.einsum("axuvn,absu->bxsvn", t, W1)        # w^2 d^3 D^2
        t = torch.einsum("bxsvn,bcqv->cxsqn", t, W2)        # w^2 d^3 D^2
        return torch.einsum("cxsqn,crn->xsqr", t, GR)       # w d^2 D^3
