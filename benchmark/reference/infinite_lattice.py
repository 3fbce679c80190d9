"""Plain reference of a lattice configuration on an infinite cylinder,
written from the physics and not from the program: the energy per site of
a uniform matrix-product state whose unit cell is one column of the
lattice, read from its tensors in whatever gauge they come. Plain torch in
float64 (complex128 for a complex state); it imports nothing of the
program (nor of the other reference files: the bond list of two columns,
from reference/lattice.py, and the site's operators are passed in).

The cell's transfer operator carries a bond matrix X[x, y] (bra, ket)
through the column's sites. Its left and right fixed points, found by
power iteration from the identity, stand for the half-infinite cylinder
on either side of a window of two columns. Every bond of the cylinder
ends in the column of its later site and spans at most two columns, so
the energy per column is that of the bonds that end in the window's
second column, and the energy per site is that over the width. The
window's MPO counts down to each bond's far end as lattice.py's does.
Conventions as in reference/mps.py: A[l, s, r], E[x, a, y] (bra bond,
MPO level, ket bond), W[a, b, s, t]."""

from __future__ import annotations

import numpy as np
import torch


def window_mpo(window_bonds, width: int, pair, ops: dict) -> np.ndarray:
    """Ws (2 width, w, w, d, d): the per-site MPO, over a window of two
    columns (sites 0 .. 2 width - 1), of the bonds (i, j, c) of
    `window_bonds` whose later site j lies in the second column (each
    bond that ends in one column of the cylinder, once) times the `pair`
    terms (the configuration's "pair"). A bond is opened at site i on
    level (k, j - i - 1) of pair term k and closed at site j with B;
    w = 2 + (number of pair terms) times the longest span."""
    W = width
    I = ops["I"]
    d = I.shape[0]
    bl = [(i, j, c) for i, j, c in window_bonds if j >= W]
    R = max(j - i for i, j, _ in bl)
    w = 2 + len(pair) * R
    Ws = np.zeros((2 * W, w, w, d, d), np.complex128)
    Ws[:, 0, 0] = Ws[:, w - 1, w - 1] = I
    for k, term in enumerate(pair):
        A, B = (ops[o] for o in term["ops"])
        base = 1 + k * R
        Ws[:, base, w - 1] = B
        for m in range(1, R):
            Ws[:, base + m, base + m - 1] = I
        for i, j, c in bl:
            Ws[i, 0, base + j - i - 1] += c * float(term["coef"]) * A
    return Ws if Ws.imag.any() else Ws.real.copy()


def _cell_left(X, As):
    for A in As:
        X = torch.einsum("xtz,xtq->qz", torch.einsum("xy,ytz->xtz", X, A),
                         A.conj())
    return X


def _cell_right(X, As):
    for A in reversed(As):
        X = torch.einsum("ytx,qtx->qy", torch.einsum("ytz,xz->ytx", A, X),
                         A.conj())
    return X


def fixed_point(step, X, tol: float, maxiter: int):
    """The dominant fixed point of `step` by power iteration from X, each
    iterate scaled to unit Frobenius norm, until one moves less than tol.
    Raises if none does within maxiter."""
    X = X / torch.linalg.matrix_norm(X)
    for _ in range(maxiter):
        Y = step(X)
        Y = Y / torch.linalg.matrix_norm(Y)
        if float(torch.linalg.matrix_norm(Y - X)) < tol:
            return Y
        X = Y
    raise RuntimeError(f"power iteration did not reach {tol} in {maxiter} "
                       "steps")


def isometry_error(As) -> float:
    """How far the cell's tensors are from left isometries: the largest
    over the sites of ||sum_s A_s^dag A_s - 1||_F / ||1||_F, in float64
    (complex128 for a complex tensor)."""
    out = 0.0
    for A in As:
        A = A.to(torch.complex128 if A.is_complex() else torch.float64)
        D = A.shape[2]
        G = torch.einsum("lsr,lsq->rq", A.conj(), A)
        eye = torch.eye(D, dtype=G.dtype, device=G.device)
        out = max(out, float(torch.linalg.matrix_norm(G - eye)) / D ** 0.5)
    return out


def _left(E, A, W):
    T = torch.einsum("xay,ytz->xatz", E, A)
    T = torch.einsum("xatz,abst->xbsz", T, W)
    return torch.einsum("xbsz,xsq->qbz", T, A.conj())


def energy(As, window_bonds, pair, ops: dict, tol: float = 1e-13,
           maxiter: int = 20000) -> float:
    """Energy per site of the uniform state with unit cell As (one column,
    W tensors A[l, s, r] in any gauge) under the bonds of two columns
    `window_bonds` (reference/lattice.py's `bonds` of 2 W sites) with the
    `pair` interaction: <H_column> / <1> over the window between the
    cell's transfer fixed points, over W."""
    Ws = window_mpo(window_bonds, len(As), pair, ops)
    cplx = any(A.is_complex() for A in As) or np.iscomplexobj(Ws)
    dtype = torch.complex128 if cplx else torch.float64
    device = As[0].device
    As = [A.to(dtype) for A in As]
    Ws = torch.as_tensor(Ws, dtype=dtype, device=device)
    D, w = As[0].shape[0], Ws.shape[1]
    eye = torch.eye(D, dtype=dtype, device=device)
    XL = fixed_point(lambda X: _cell_left(X, As), eye, tol, maxiter)
    XR = fixed_point(lambda X: _cell_right(X, As), eye, tol, maxiter)
    E = torch.zeros((D, w, D), dtype=dtype, device=device)
    E[:, 0] = XL
    for A, W in zip(As + As, Ws):
        E = _left(E, A, W)
    num = torch.einsum("xy,xy->", E[:, w - 1], XR)
    den = torch.einsum("xy,xy->", E[:, 0], XR)
    return float((num / den).real) / len(As)
