"""Plain reference of a lattice configuration, written from the physics and
not from the program: the bonds of a lattice wrapped into an open chain,
one MPO tensor per site of the sum of a pair interaction over them, and
the energy and variance of a finite matrix-product state under it. Plain
torch and numpy in float64; it imports nothing of the program (nor of
the other reference files: the site's operators are passed in).

A configuration names its site, a "lattice" ({"kind": "square_cylinder",
"width": W}: site (x, y) is site i = W x + y of the chain, periodic in y,
open in x), its "bonds" as (dx, dy) offsets with coefficients, and the
"pair" interaction, terms c A_i B_j of every bond (i < j).

The MPO counts down to each bond's far end: site i opens every bond
(i, j) with its coefficient on level (k, j - i - 1) of the pair term k,
each level (k, m) steps to (k, m - 1) through a site, and level (k, 0)
closes with B. So each site has its own tensor, and the bonds that would
leave the chain are never opened. Conventions as in reference/mps.py:
A[l, s, r], E[x, a, y] (bra bond, MPO level, ket bond), W[a, b, s, t]."""

from __future__ import annotations

import math

import numpy as np
import torch


def _coef(entry: dict, values: dict) -> float:
    return float(entry.get("coef", 1.0)) * math.prod(
        float(values[p]) for p in entry.get("times", []))


def bonds(cfg: dict, L: int, params: dict | None = None) -> list:
    """(i, j, c) with i < j for every bond of the configuration's lattice
    on L sites (whole columns), c the bond's coefficient."""
    lat = cfg["lattice"]
    if lat["kind"] != "square_cylinder":
        raise ValueError(f"unknown lattice kind {lat['kind']!r}")
    W = int(lat["width"])
    if L % W:
        raise ValueError(f"{L} sites are not whole columns of {W}")
    values = {**cfg.get("params", {}), **(params or {})}
    out = []
    for x in range(L // W):
        for y in range(W):
            for b in cfg["bonds"]:
                dx, dy = b["offset"]
                if not 0 <= x + dx < L // W:
                    continue
                i, j = W * x + y, W * (x + dx) + (y + dy) % W
                out.append((min(i, j), max(i, j), _coef(b, values)))
    return out


def mpo(cfg: dict, L: int, ops: dict,
        params: dict | None = None) -> np.ndarray:
    """Ws (L, w, w, d, d): site i's tensor of H = sum over bonds (i, j) of
    c sum_k c_k A_k(i) B_k(j), with w = 2 + (number of pair terms) times
    the longest bond's span in the chain; `ops` names the site's operators
    (reference/mps.py, site_operators). Real when every entry is."""
    I = ops["I"]
    d = I.shape[0]
    bl = bonds(cfg, L, params)
    pair = cfg["pair"]
    R = max(j - i for i, j, _ in bl)
    w = 2 + len(pair) * R
    Ws = np.zeros((L, w, w, d, d), np.complex128)
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


def _left(E, A, W):
    T = torch.einsum("xay,ytz->xatz", E, A)
    T = torch.einsum("xatz,abst->xbsz", T, W)
    return torch.einsum("xbsz,xsq->qbz", T, A.conj())


def norm2(As) -> float:
    E = torch.ones((1, 1), dtype=As[0].dtype, device=As[0].device)
    for A in As:
        E = torch.einsum("xtz,xtq->qz", torch.einsum("xy,ytz->xtz", E, A),
                         A.conj())
    return float(E[0, 0].real)


def energy(As, Ws) -> float:
    """<psi|H|psi> / <psi|psi>, Ws one tensor per site."""
    w = Ws[0].shape[0]
    E = torch.zeros((1, w, 1), dtype=As[0].dtype, device=As[0].device)
    E[0, 0, 0] = 1
    for A, W in zip(As, Ws):
        E = _left(E, A, W)
    return float(E[0, w - 1, 0].real) / norm2(As)


def _left_h2(E, A, W, block_bytes: int):
    """E[x, a, c, y] of <psi|H H|psi> carried one site, in blocks of the
    ket's right bond so that the intermediates stay near `block_bytes`."""
    Dl, _, Dr = A.shape
    w = W.shape[0]
    per_column = Dl * w * w * A.shape[1] * A.element_size()
    n = max(1, min(Dr, block_bytes // per_column))
    out = torch.empty((Dr, w, w, Dr), dtype=E.dtype, device=E.device)
    for z in range(0, Dr, n):
        T = torch.einsum("xacy,ytz->xactz", E, A[:, :, z:z + n])
        T = torch.einsum("xactz,ceut->xaeuz", T, W)
        T = torch.einsum("xaeuz,absu->xbesz", T, W)
        out[..., z:z + n] = torch.einsum("xbesz,xsq->qbez", T, A.conj())
    return out


def variance(As, Ws, block_bytes: int = 2 ** 30) -> float:
    """<psi|H^2|psi> / <psi|psi> - (<psi|H|psi> / <psi|psi>)^2, with H^2 as
    two MPO layers; the environments (D, w, w, D) are pushed in blocks."""
    w = Ws[0].shape[0]
    E = torch.zeros((1, w, w, 1), dtype=As[0].dtype, device=As[0].device)
    E[0, 0, 0, 0] = 1
    for A, W in zip(As, Ws):
        E = _left_h2(E, A, W, block_bytes)
    h2 = float(E[0, w - 1, w - 1, 0].real) / norm2(As)
    return h2 - energy(As, Ws) ** 2
