"""Plain reference of the benchmark's checks, written from the physics and
not from the program: the MPO of a configuration's nearest-neighbour
terms, and the energy, variance, overlap and one-site TDVP step of a
finite matrix-product state. Plain
torch.einsum in float64 / complex128; it imports nothing of the program.

A state is a list of site tensors A[l, s, r] (left bond, physical index,
right bond); an environment E[x, a, y] holds the bra bond x, the MPO bond
a and the ket bond y. W[a, b, s, t] maps the physical index t (ket) to s
(bra); the open chain enters on MPO state 0 and leaves on state w - 1."""

from __future__ import annotations

import math

import numpy as np
import torch


def site_operators(site: dict) -> dict:
    """Named local operators of a configuration's site: Pauli matrices
    ({"kind": "pauli"}) or spin-s matrices in the S_z basis m = s, ..., -s
    ({"kind": "spin", "s": s}), as complex128 numpy arrays."""
    if site["kind"] == "pauli":
        ops = {"X": [[0, 1], [1, 0]], "Y": [[0, -1j], [1j, 0]],
               "Z": [[1, 0], [0, -1]], "I": [[1, 0], [0, 1]]}
        return {k: np.array(v, np.complex128) for k, v in ops.items()}
    if site["kind"] == "spin":
        s = float(site["s"])
        d = int(round(2 * s + 1))
        m = s - np.arange(d)
        Sp = np.zeros((d, d), np.complex128)
        for k in range(d - 1):
            Sp[k, k + 1] = math.sqrt(s * (s + 1) - m[k + 1] * (m[k + 1] + 1))
        Sm = Sp.T.copy()
        return {"Sz": np.diag(m).astype(np.complex128), "Sp": Sp, "Sm": Sm,
                "Sx": (Sp + Sm) / 2, "Sy": (Sp - Sm) / 2j,
                "I": np.eye(d, dtype=np.complex128)}
    raise ValueError(f"unknown site kind {site['kind']!r}")


def mpo(config: dict, params: dict | None = None) -> np.ndarray:
    """W (w, w, d, d) of H = sum_i sum_terms coef * ops, one-site terms on
    every site and two-site terms on every bond; w = 2 + the number of
    two-site terms. A term's coefficient is its "coef" times the product of
    the parameters it names under "times" (the configuration's "params",
    updated by `params`). Real when every entry is."""
    values = {**config.get("params", {}), **(params or {})}
    ops = site_operators(config["site"])
    d = ops["I"].shape[0]
    two = [t for t in config["terms"] if len(t["ops"]) == 2]
    w = 2 + len(two)
    W = np.zeros((w, w, d, d), np.complex128)
    W[0, 0] = W[w - 1, w - 1] = ops["I"]
    for t in config["terms"]:
        c = float(t["coef"]) * math.prod(float(values[p])
                                         for p in t.get("times", []))
        if len(t["ops"]) == 1:
            W[0, w - 1] += c * ops[t["ops"][0]]
        elif len(t["ops"]) != 2:
            raise ValueError(f"term {t} is neither one- nor two-site")
    for k, t in enumerate(two, 1):
        c = float(t["coef"]) * math.prod(float(values[p])
                                         for p in t.get("times", []))
        W[0, k] = ops[t["ops"][0]]
        W[k, w - 1] = c * ops[t["ops"][1]]
    return W if W.imag.any() else W.real.copy()


def bond_dims(L: int, d: int, D: int) -> list:
    """The largest rank of each bond of an open chain of L sites kept at
    bond dimension D: min(d^i, d^(L-i), D) for i = 0..L."""
    return [min(d ** i, d ** (L - i), D) for i in range(L + 1)]


def trimmed(tensors, D: int) -> list:
    """Site tensors cut to the bond ranks an open chain can have (a padded
    layout carries zeros beyond them; weight there is lost to the check)."""
    L, d = len(tensors), tensors[0].shape[1]
    dims = bond_dims(L, d, D)
    return [A[:dims[i], :, :dims[i + 1]] for i, A in enumerate(tensors)]


def as_reference(tensors, W: np.ndarray, device) -> tuple:
    """The state's tensors and W on `device` in one common float64 or
    complex128 dtype."""
    cplx = any(t.is_complex() for t in tensors) or np.iscomplexobj(W)
    dtype = torch.complex128 if cplx else torch.float64
    return ([t.to(device=device, dtype=dtype) for t in tensors],
            torch.as_tensor(W, dtype=dtype, device=device))


def _left(E, A, W):
    T = torch.einsum("xay,ytz->xatz", E, A)
    T = torch.einsum("xatz,abst->xbsz", T, W)
    return torch.einsum("xbsz,xsq->qbz", T, A.conj())


def _right(E, A, W):
    T = torch.einsum("ytz,qbz->ytqb", A, E)
    T = torch.einsum("ytqb,abst->yqas", T, W)
    return torch.einsum("yqas,xsq->xay", T, A.conj())


def _left_plain(E, A, B):
    """<B| ... |A> carried one site: E[x, y] with x on B, y on A."""
    T = torch.einsum("xy,ytz->xtz", E, A)
    return torch.einsum("xtz,xtq->qz", T, B.conj())


def norm2(As) -> float:
    E = torch.ones((1, 1), dtype=As[0].dtype, device=As[0].device)
    for A in As:
        E = _left_plain(E, A, A)
    return float(E[0, 0].real)


def overlap(As, Bs) -> complex:
    """<B|A>."""
    E = torch.ones((1, 1), dtype=As[0].dtype, device=As[0].device)
    for A, B in zip(As, Bs):
        E = _left_plain(E, A, B)
    return complex(E[0, 0])


def fidelity(As, Bs) -> float:
    """|<A|B>| / (|A| |B|)."""
    return abs(overlap(As, Bs)) / math.sqrt(norm2(As) * norm2(Bs))


def energy(As, W) -> float:
    """<psi|H|psi> / <psi|psi>."""
    w = W.shape[0]
    E = torch.zeros((1, w, 1), dtype=As[0].dtype, device=As[0].device)
    E[0, 0, 0] = 1
    for A in As:
        E = _left(E, A, W)
    return float(E[0, w - 1, 0].real) / norm2(As)


def variance(As, W) -> float:
    """<psi|H^2|psi> / <psi|psi> - (<psi|H|psi> / <psi|psi>)^2, with H^2
    as two MPO layers."""
    w = W.shape[0]
    E = torch.zeros((1, w, w, 1), dtype=As[0].dtype, device=As[0].device)
    E[0, 0, 0, 0] = 1
    for A in As:
        T = torch.einsum("xacy,ytz->xactz", E, A)
        T = torch.einsum("xactz,ceut->xaeuz", T, W)
        T = torch.einsum("xaeuz,absu->xbesz", T, W)
        E = torch.einsum("xbesz,xsq->qbez", T, A.conj())
    h2 = float(E[0, w - 1, w - 1, 0].real) / norm2(As)
    return h2 - energy(As, W) ** 2


def expm_krylov(apply, v, tau: complex, m: int = 40):
    """exp(tau H) v by a Lanczos basis of up to m vectors, fully
    reorthogonalized, with exp(tau T) of the tridiagonal T by its
    eigendecomposition on the host. Stops early on an invariant subspace."""
    nrm = torch.linalg.vector_norm(v)
    V = [v / nrm]
    alpha, beta = [], []
    for j in range(m):
        w = apply(V[j])
        alpha.append(torch.vdot(V[j].reshape(-1), w.reshape(-1)).real.item())
        for _ in range(2):
            for u in V:
                w = w - torch.vdot(u.reshape(-1), w.reshape(-1)) * u
        b = torch.linalg.vector_norm(w).item()
        if j == m - 1 or b < 1e-13 * max(1.0, abs(alpha[-1])):
            break
        beta.append(b)
        V.append(w / b)
    k = len(alpha)
    T = np.diag(alpha) + np.diag(beta[:k - 1], 1) + np.diag(beta[:k - 1], -1)
    lam, U = np.linalg.eigh(T)
    c = U @ (np.exp(tau * lam) * U[0])
    out = torch.zeros_like(v)
    for cj, u in zip(c, V):
        out = out + complex(cj) * u
    return out * nrm


def _h_ac(EL, W, ER, A):
    T = torch.einsum("xay,ytz->xatz", EL, A)
    T = torch.einsum("xatz,abst->xbsz", T, W)
    return torch.einsum("xbsz,qbz->xsq", T, ER)


def _h_c(EL, ER, C):
    T = torch.einsum("xay,yz->xaz", EL, C)
    return torch.einsum("xaz,qaz->xq", T, ER)


def tdvp_step(As, W, dt: float) -> list:
    """One symmetric second-order one-site TDVP step of the open chain:
    left to right, each site forward by dt/2 and its right bond back by
    dt/2, then right to left the same with the left bonds (the last site
    takes both forward half steps in a row); starts and ends with the
    centre on site 0. As is any list of complex128 site tensors; it is
    brought to right-canonical form first."""
    L, w = len(As), W.shape[0]
    dev, dt_ = As[0].device, As[0].dtype
    ARs = [None] * L
    carry = None
    for i in range(L - 1, 0, -1):
        A = As[i] if carry is None else torch.einsum("lpm,mr->lpr", As[i],
                                                      carry)
        Dl, d, Dr = A.shape
        Q, R = torch.linalg.qr(A.reshape(Dl, d * Dr).mH)
        ARs[i] = Q.mH.reshape(-1, d, Dr)
        carry = R.mH
    AC = As[0] if carry is None else torch.einsum("lpm,mr->lpr", As[0], carry)
    ERs = [None] * (L + 1)
    ERs[L] = torch.zeros((1, w, 1), dtype=dt_, device=dev)
    ERs[L][0, w - 1, 0] = 1
    for i in range(L - 1, 0, -1):
        ERs[i] = _right(ERs[i + 1], ARs[i], W)

    half = 0.5 * dt
    ALs, ELs = [None] * L, [None] * L
    EL = torch.zeros((1, w, 1), dtype=dt_, device=dev)
    EL[0, 0, 0] = 1
    for i in range(L):
        ELs[i] = EL
        AC = expm_krylov(lambda x: _h_ac(ELs[i], W, ERs[i + 1], x), AC,
                         -1j * half)
        if i == L - 1:
            break
        Dl, d, Dr = AC.shape
        Q, C = torch.linalg.qr(AC.reshape(Dl * d, Dr))
        ALs[i] = Q.reshape(Dl, d, -1)
        EL = _left(EL, ALs[i], W)
        C = expm_krylov(lambda x: _h_c(EL, ERs[i + 1], x), C, 1j * half)
        AC = torch.einsum("lm,mpr->lpr", C, ARs[i + 1])
    ER = ERs[L]
    for i in range(L - 1, -1, -1):
        AC = expm_krylov(lambda x: _h_ac(ELs[i], W, ER, x), AC, -1j * half)
        if i == 0:
            break
        Dl, d, Dr = AC.shape
        Q, R = torch.linalg.qr(AC.reshape(Dl, d * Dr).mH)
        ARs[i] = Q.mH.reshape(-1, d, Dr)
        ER = _right(ER, ARs[i], W)
        C = expm_krylov(lambda x: _h_c(ELs[i], ER, x), R.mH, 1j * half)
        AC = torch.einsum("lpm,mr->lpr", ALs[i - 1], C)
    return [AC] + ARs[1:]

