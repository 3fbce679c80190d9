"""Plain reference of a lattice of spin-1/2 fermions (a configuration whose
"site" is {"kind": "spinful_fermion"}), written from the physics and not
from the program: the site's operators, the bonds of a square cylinder
wrapped into an open chain, one MPO tensor per site of the hopping over
those bonds plus an on-site term, and the energy and variance of a finite
matrix-product state under it. Plain torch and numpy in float64; it
imports nothing of the program (nor of the other reference files).

Modes are ordered along the chain, and inside a site the up mode before
the down mode. A site's basis is |n_up n_dn> with index 2 n_up + n_dn. By
Jordan-Wigner over that order, with a the single-mode annihilator and Z
its parity diag(1, -1), c_up = a (x) 1 and c_dn = Z (x) a on the site,
and a mode on site i carries the parity P = Z (x) Z of every site before
i. So for i < j

    c_is^dag c_js = (c_s^dag P)_i P_(i+1) ... P_(j-1) (c_s)_j,
    c_js^dag c_is = (P c_s)_i P_(i+1) ... P_(j-1) (c_s^dag)_j.

The MPO counts down to each bond's far end: site i opens every bond
(i, j) with its coefficient on level (k, j - i - 1) of hop term k, each
level (k, m) steps to (k, m - 1) through a site's P, and level (k, 0)
closes with the term's second operator. So each site has its own tensor,
and the bonds that would leave the chain are never opened. The on-site
terms sit on the (0, w - 1) block. Conventions: A[l, s, r], E[x, a, y]
(bra bond, MPO level, ket bond), W[a, b, s, t]."""

from __future__ import annotations

import math

import numpy as np
import torch


def site_operators() -> dict:
    """The spinful site's operators as float64 numpy arrays (d = 4):
    c_up, c_dn, their adjoints cdag_up, cdag_dn, n_up, n_dn, n = n_up +
    n_dn, the parity P and the identity I."""
    a = np.array([[0.0, 1.0], [0.0, 0.0]])   # |1> -> |0>
    Z = np.diag([1.0, -1.0])
    I2 = np.eye(2)
    ops = {"c_up": np.kron(a, I2), "c_dn": np.kron(Z, a),
           "P": np.kron(Z, Z), "I": np.eye(4)}
    for s in ("up", "dn"):
        ops[f"cdag_{s}"] = ops[f"c_{s}"].T.copy()
        ops[f"n_{s}"] = ops[f"cdag_{s}"] @ ops[f"c_{s}"]
    ops["n"] = ops["n_up"] + ops["n_dn"]
    return ops


def hop_terms(ops: dict) -> list:
    """(A, B) of each term A_i P ... P B_j of sum_s (c_is^dag c_js + h.c.)
    on a bond i < j."""
    P = ops["P"]
    return [t for s in ("up", "dn")
            for t in ((ops[f"cdag_{s}"] @ P, ops[f"c_{s}"]),
                      (P @ ops[f"c_{s}"], ops[f"cdag_{s}"]))]


def _coef(entry: dict, values: dict) -> float:
    return float(entry.get("coef", 1.0)) * math.prod(
        float(values[p]) for p in entry.get("times", []))


def bonds(cfg: dict, L: int, params: dict | None = None) -> list:
    """(i, j, c) with i < j for every bond of the configuration's square
    cylinder on L sites (whole columns of W: site (x, y) is site W x + y,
    y periodic, x open), c the bond's hopping coefficient."""
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


def onsite(cfg: dict, ops: dict, params: dict | None = None) -> np.ndarray:
    """The sum of the configuration's "onsite" terms, each its coefficient
    times the product of the operators it names."""
    values = {**cfg.get("params", {}), **(params or {})}
    out = np.zeros_like(ops["I"])
    for term in cfg["onsite"]:
        out += _coef(term, values) * np.linalg.multi_dot(
            [ops["I"]] + [ops[o] for o in term["ops"]])
    return out


def mpo(cfg: dict, L: int, params: dict | None = None) -> np.ndarray:
    """Ws (L, w, w, 4, 4): site i's tensor of H = sum over bonds (i, j) of
    c sum_s (c_is^dag c_js + h.c.) plus the on-site terms on every site,
    with w = 2 + 4 times the longest bond's span in the chain."""
    ops = site_operators()
    I, P = ops["I"], ops["P"]
    bl = bonds(cfg, L, params)
    terms = hop_terms(ops)
    R = max(j - i for i, j, _ in bl)
    w = 2 + len(terms) * R
    Ws = np.zeros((L, w, w, 4, 4))
    Ws[:, 0, 0] = Ws[:, w - 1, w - 1] = I
    Ws[:, 0, w - 1] = onsite(cfg, ops, params)
    for k, (A, B) in enumerate(terms):
        base = 1 + k * R
        Ws[:, base, w - 1] = B
        for m in range(1, R):
            Ws[:, base + m, base + m - 1] = P
        for i, j, c in bl:
            Ws[i, 0, base + j - i - 1] += c * A
    return Ws


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
