"""SU(2)-reduced quasiparticle excitations with multiplet-resolved X blocks
(counterpart of mpskit_tpu/symmetry/su2_reduced_qp.py).

The excitation carries a definite total spin k_exc (`tke` = 2 k_exc):

* ``VL``: reduced left null space of AL, blocks keyed ``(2j_l, 2j_m)``.
* ``X``: charged bond matrix, blocks keyed ``(2j_m, 2j_r)`` admissible
  under the excitation spin (``j_m (x) k_exc -> j_r``).
* ``B = VL . X``: charged site blocks keyed ``(2j_l, 2j_m, 2j_r)``, the
  inner line of the fusion tree ``(l (x) p) -> m, m (x) k_exc -> r``.
* Charged environments: blocks keyed ``(2j_bra, 2K, 2j_ket)`` with K the
  total channel fused from the MPO level irrep and k_exc.

Every structure coefficient is probed numerically on the host, as in
`su2_reduced.py`, and every contraction runs a cached term plan over the
flat `RBlocks`. For k_exc != 0 the mixed charged transfer is strictly
contractive, so the geometric tails are plain (1 - e^{ip} T) solves.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import sqrt
from typing import Tuple

import numpy as np
import torch

from ..linalg.gmres import linsolve
from ..linalg.lanczos import eigsh_smallest
from ..utils.sync import to_host
from .su2_reduced import (
    RBlocks, ReducedMPO, SU2ReducedState, _admissible, _adj,
    _cg, _conj, _env_basis, _generator, _group, _ident, _key_index, _np,
    _randn, _run, _site_basis, _tr, _w_entry_dense,
    _bond_sectors_from_blocks, rac_apply, reduced_ham_envs, tree_dot,
    tree_normalize,
)


# ----------------------------------------------------------------------------
# Dense bases for charged objects (numpy; probing/embedding only)
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _xbond_basis(tjm: int, tke: int, tjr: int) -> np.ndarray:
    """Unit-norm basis X[mm, qe, mr] of a charged bond-matrix block."""
    return _cg(tjm, tke, tjr) / sqrt(tjr + 1)


@lru_cache(maxsize=None)
def _csite_basis(tjl: int, tjp: int, tjm: int, tke: int,
                 tjr: int) -> np.ndarray:
    """Unit-norm basis T[ml, s, qe, mr] of a charged site block with the
    fusion tree (l (x) p) -> m, m (x) k_exc -> r."""
    C1 = _cg(tjl, tjp, tjm)                  # [ml, s, mm]
    C2 = _cg(tjm, tke, tjr)                  # [mm, qe, mr]
    T = np.einsum("lsm,mqr->lsqr", C1, C2)
    return T / sqrt(tjr + 1)


@lru_cache(maxsize=None)
def _eps(tk: int) -> np.ndarray:
    """SU(2) dual (cup/cap) matrix on the spin-k/2 space:
    eps[q', q] = (-1)^((k - m)/2) delta_{m', -m}."""
    E = np.zeros((tk + 1, tk + 1))
    for q in range(tk + 1):
        m2 = 2 * q - tk
        E[tk - q, q] = (-1.0) ** ((tk - m2) // 2)
    return E


@lru_cache(maxsize=None)
def _cenv_basis(tjb: int, tka: int, tke: int, tK: int, tjk: int,
                twist: bool = False) -> np.ndarray:
    """Unit-norm basis E[mb, qa, qe, mk] of a charged environment block:
    the MPO channel k_a and the excitation k_e fuse into the total K.
    ``twist=True`` applies the dual (epsilon) map to the excitation leg, the
    basis of the LEFT B-environments."""
    Cf = _cg(tka, tke, tK)                   # [qa, qe, Q]
    E = _env_basis(tjb, tK, tjk)             # [mb, Q, mk]
    out = np.einsum("aeQ,bQk->baek", Cf, E)
    if twist:
        out = np.einsum("fe,baek->bafk", _eps(tke), out)
    return out


def _fused_channels(tka: int, tke: int) -> Tuple[int, ...]:
    return tuple(tK for tK in range(abs(tka - tke), tka + tke + 1, 2))


def _w_dense(tka, tkop, tkb, tjp, ident: bool) -> np.ndarray:
    """Dense W[qa, qb, s, t] of one FSM entry, or the exact identity for
    the implicit diagonal identity entries (levels 0 and w-1)."""
    if ident:
        return np.eye(tjp + 1)[None, None]
    return _w_entry_dense(tka, tkop, tkb, tjp)


# ----------------------------------------------------------------------------
# Key enumerations
# ----------------------------------------------------------------------------

def csite_keys(secs_l, tjp, tke, secs_r):
    """Triple keys (tjl, tjm, tjr) of a charged site tensor."""
    out = []
    for tjl, _ in secs_l:
        for tjr, _ in secs_r:
            for tjm in range(abs(tjl - tjp), tjl + tjp + 1, 2):
                if _admissible(tjm, tke, tjr):
                    out.append((tjl, tjm, tjr))
    return tuple(sorted(out))


def cenv_keys(secs, tka, tke):
    """(tjb, tK, tjk) keys of a charged environment at MPO channel tka."""
    out = []
    for tjb, _ in secs:
        for tjk, _ in secs:
            for tK in _fused_channels(tka, tke):
                if _admissible(tjk, tK, tjb):
                    out.append((tjb, tK, tjk))
    return tuple(sorted(out))


def _cenv_zero(secs, tka, tke, like) -> RBlocks:
    d = dict(secs)
    keys = cenv_keys(secs, tka, tke)
    return RBlocks.zeros(keys, [(d[tb], d[tk]) for (tb, _, tk) in keys],
                         like.dtype, like.device)


# ----------------------------------------------------------------------------
# Dense embeddings (tests only)
# ----------------------------------------------------------------------------

def _offsets(secs):
    out, pos = {}, 0
    for tj, m in secs:
        out[tj] = (pos, m)
        pos += m * (tj + 1)
    return out, pos


def embed_csite(B: RBlocks, secs, tjp: int, tke: int) -> np.ndarray:
    """Dense charged site tensor [l, s, qe, r]."""
    off, D = _offsets(secs)
    A = np.zeros((D, tjp + 1, tke + 1, D), _np(B.flat).dtype)
    for (tjl, tjm, tjr), blk in B.items():
        (l0, nl), (r0, nr) = off[tjl], off[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _csite_basis(tjl, tjp, tjm, tke, tjr)
        blkT = np.einsum("ab,lsqr->alsqbr", _np(blk), T)
        A[l0:l0 + nl * dl, :, :, r0:r0 + nr * dr] += blkT.reshape(
            nl * dl, tjp + 1, tke + 1, nr * dr)
    return A


def restrict_csite(A: np.ndarray, secs, tjp: int, tke: int,
                   device="cuda") -> RBlocks:
    off, _ = _offsets(secs)
    keys = csite_keys(secs, tjp, tke, secs)
    vals = []
    for (tjl, tjm, tjr) in keys:
        (l0, nl), (r0, nr) = off[tjl], off[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _csite_basis(tjl, tjp, tjm, tke, tjr)
        view = np.asarray(A)[l0:l0 + nl * dl, :, :, r0:r0 + nr * dr].reshape(
            nl, dl, tjp + 1, tke + 1, nr, dr)
        vals.append(torch.as_tensor(np.einsum("alsqbr,lsqr->ab", view, T),
                                    device=device))
    return RBlocks.from_blocks(keys, vals)


def embed_cenv(G: RBlocks, secs, tka: int, tke: int,
               twist: bool = False) -> np.ndarray:
    """Dense charged environment [bra, qa, qe, ket]; twist=True uses the
    left-walk (dual excitation leg) basis."""
    off, D = _offsets(secs)
    E = np.zeros((D, tka + 1, tke + 1, D), _np(G.flat).dtype)
    for (tjb, tK, tjk), blk in G.items():
        (b0, nb), (k0, nk) = off[tjb], off[tjk]
        db, dk = tjb + 1, tjk + 1
        T = _cenv_basis(tjb, tka, tke, tK, tjk, twist)
        blkT = np.einsum("ab,xqey->axqeby", _np(blk), T)
        E[b0:b0 + nb * db, :, :, k0:k0 + nk * dk] += blkT.reshape(
            nb * db, tka + 1, tke + 1, nk * dk)
    return E


def restrict_cenv(E: np.ndarray, secs, tka: int, tke: int,
                  twist: bool = False, device="cuda") -> RBlocks:
    off, _ = _offsets(secs)
    keys = cenv_keys(secs, tka, tke)
    vals = []
    for (tjb, tK, tjk) in keys:
        (b0, nb), (k0, nk) = off[tjb], off[tjk]
        db, dk = tjb + 1, tjk + 1
        T = _cenv_basis(tjb, tka, tke, tK, tjk, twist)
        view = np.asarray(E)[b0:b0 + nb * db, :, :, k0:k0 + nk * dk].reshape(
            nb, db, tka + 1, tke + 1, nk, dk)
        vals.append(torch.as_tensor(np.einsum("axqeby,xqey->ab", view, T),
                                    device=device))
    return RBlocks.from_blocks(keys, vals)


# ----------------------------------------------------------------------------
# Reduced left null space
# ----------------------------------------------------------------------------

def left_null_reduced(AL: RBlocks, tjp: int) -> RBlocks:
    """VL with VL^dag AL = 0 and VL a dense isometry, per right sector:
    complete the QR of the stacked (1/sqrt(2j_m+1)-scaled) AL columns.
    The null sectors run over EVERY j_m reachable from l (x) p, including
    sectors absent from the bond (whose null space is the whole stacked
    row space)."""
    secs_l, secs_m = {}, {}
    for (tjl, tjm_), s in zip(AL.keys, AL.shapes):
        secs_l[tjl] = s[0]
        secs_m[tjm_] = s[1]
    tjms = sorted({tjm for tjl in secs_l
                   for tjm in range(abs(tjl - tjp), tjl + tjp + 1, 2)})
    keys, vals = [], []
    dtype, device = AL.dtype, AL.device
    for tjm in tjms:
        rows, meta = [], []
        for tjl in sorted(secs_l):
            if not _admissible(tjl, tjp, tjm):
                continue
            blk = AL.get((tjl, tjm))
            nl = secs_l[tjl]
            meta.append((tjl, nl))
            # a missing block is an all-zero block of the sector's bond
            # multiplicity, not 0 columns
            rows.append(blk if blk is not None else torch.zeros(
                (nl, secs_m.get(tjm, 0)), dtype=dtype, device=device))
        S = torch.cat(rows, dim=0) / sqrt(tjm + 1)
        R, nm = S.shape
        if R <= nm:
            continue                          # no null directions
        if nm == 0:
            N = torch.eye(R, dtype=dtype, device=device)
        else:
            Q, _ = torch.linalg.qr(S, mode="complete")
            N = Q[:, nm:]                     # (R, R - nm)
        pos = 0
        for (tjl, nl) in meta:
            keys.append((tjl, tjm))
            vals.append(sqrt(tjm + 1) * N[pos:pos + nl])
            pos += nl
    order = sorted(range(len(keys)), key=lambda i: keys[i])
    return RBlocks.from_blocks(tuple(keys[i] for i in order),
                               [vals[i] for i in order])


def null_sectors(VL: RBlocks):
    """((2j_m, nn_m), ...) of the null bond."""
    out = {}
    for (tjl, tjm), s in zip(VL.keys, VL.shapes):
        out[tjm] = s[1]
    return tuple(sorted(out.items()))


def x_keys(VL: RBlocks, secs_r, tke: int):
    nsec = null_sectors(VL)
    return tuple(sorted((tjm, tjr) for tjm, _ in nsec for tjr, _ in secs_r
                        if _admissible(tjm, tke, tjr)))


def random_x(VL: RBlocks, secs_r, tke: int, dtype,
             generator: torch.Generator = None) -> RBlocks:
    """Gaussian X blocks on VL's device, from `generator` (seeded 0 when
    None)."""
    nsec = dict(null_sectors(VL))
    rsec = dict(secs_r)
    keys = x_keys(VL, tuple(sorted(rsec.items())), tke)
    shapes = [(nsec[tjm], rsec[tjr]) for tjm, tjr in keys]
    g = _generator(generator, VL.device)
    flat = _randn((sum(a * b for a, b in shapes),), dtype, VL.device, g)
    return RBlocks(keys, shapes, flat)


# ----------------------------------------------------------------------------
# Probed structure coefficients
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _probe_vlx(tjp, tke, tjl, tjm, tjr) -> float:
    """B block (tjl,tjm,tjr) = coeff * VL[(tjl,tjm)] @ X[(tjm,tjr)]."""
    SB = _site_basis(tjl, tjp, tjm)
    XB = _xbond_basis(tjm, tke, tjr)
    out = np.einsum("lsm,mqr->lsqr", SB, XB)
    T = _csite_basis(tjl, tjp, tjm, tke, tjr)
    return float(np.einsum("lsqr,lsqr->", out, T))


@lru_cache(maxsize=None)
def _probe_pullback(tjp, tke, tjl, tjm, tjr) -> float:
    """X' block (tjm,tjr) += coeff * VL[(tjl,tjm)]^dag @ y[(tjl,tjm,tjr)]."""
    SB = _site_basis(tjl, tjp, tjm)
    CB = _csite_basis(tjl, tjp, tjm, tke, tjr)
    out = np.einsum("lsm,lsqr->mqr", SB, CB)
    XB = _xbond_basis(tjm, tke, tjr)
    return float(np.einsum("mqr,mqr->", out, XB))


@lru_cache(maxsize=None)
def _probe_cpush_left(tka, tkop, tkb, tke, tjp, ident,
                      tjx, tKi, tjy, tjm, tKo, tjn) -> float:
    """Charged left push (bra=AL ket=AR) through one FSM entry:
    out[(tjm,tKo,tjn)] += c * AL[(tjx,tjm)]^dag lB[(tjx,tKi,tjy)]
    AR[(tjy,tjn)]."""
    if not (_admissible(tjy, tKi, tjx) and _admissible(tjn, tKo, tjm)
            and _admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)):
        return 0.0
    E = _cenv_basis(tjx, tka, tke, tKi, tjy, True)  # [mx, qa, qe, my]
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ab = _site_basis(tjx, tjp, tjm)
    Ak = _site_basis(tjy, tjp, tjn)
    out = np.einsum("xaey,abst,xsm,ytn->mben", E, W, Ab, Ak, optimize=True)
    Eo = _cenv_basis(tjm, tkb, tke, tKo, tjn, True)
    return float(np.einsum("mben,mben->", out, Eo))


@lru_cache(maxsize=None)
def _probe_csrc_left(tka, tkop, tkb, tke, tjp, ident,
                     tjx, tjy, tjmid, tjn, tjm, tKo) -> float:
    """Left source: out[(tjm,tKo,tjn)] += c * AL[(tjx,tjm)]^dag
    gl[(tjx,tjy)] W B[(tjy,tjmid,tjn)] with gl uncharged at channel tka."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjn, tKo, tjm)
            and _admissible(tjx, tjp, tjm)):
        return 0.0
    E = _env_basis(tjx, tka, tjy)              # [mx, qa, my]
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ab = _site_basis(tjx, tjp, tjm)
    Bk = _csite_basis(tjy, tjp, tjmid, tke, tjn)  # [my, t, qe, mn]
    out = np.einsum("xay,abst,xsm,yten->mben", E, W, Ab, Bk, optimize=True)
    Eo = _cenv_basis(tjm, tkb, tke, tKo, tjn, True)
    return float(np.einsum("mben,mben->", out, Eo))


@lru_cache(maxsize=None)
def _probe_cpush_right(tka, tkop, tkb, tke, tjp, ident,
                       tjm, tKi, tjn, tjx, tKo, tjy) -> float:
    """Charged right push (bra=AR ket=AL):
    out[(tjx,tKo,tjy)] += c * AR[(tjx,tjm)]^dag rB[(tjm,tKi,tjn)]
    AL[(tjy,tjn)]^T."""
    if not (_admissible(tjn, tKi, tjm) and _admissible(tjy, tKo, tjx)
            and _admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)):
        return 0.0
    E = _cenv_basis(tjm, tkb, tke, tKi, tjn)   # [mm, qb, qe, mn]
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ab = _site_basis(tjx, tjp, tjm)            # bra AR
    Ak = _site_basis(tjy, tjp, tjn)            # ket AL
    out = np.einsum("mben,abst,xsm,ytn->xaey", E, W, Ab, Ak, optimize=True)
    Eo = _cenv_basis(tjx, tka, tke, tKo, tjy)
    return float(np.einsum("xaey,xaey->", out, Eo))


@lru_cache(maxsize=None)
def _probe_csrc_right(tka, tkop, tkb, tke, tjp, ident,
                      tjm, tjn, tjy, tjmid, tjx, tKo) -> float:
    """Right source: out[(tjx,tKo,tjy)] += c * AR[(tjx,tjm)]^dag
    gr[(tjm,tjn)] W B[(tjy,tjmid,tjn)]^T with gr uncharged at channel
    tkb."""
    if not (_admissible(tjn, tkb, tjm) and _admissible(tjy, tKo, tjx)
            and _admissible(tjx, tjp, tjm)):
        return 0.0
    E = _env_basis(tjm, tkb, tjn)              # [mm, qb, mn]
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ab = _site_basis(tjx, tjp, tjm)            # bra AR
    Bk = _csite_basis(tjy, tjp, tjmid, tke, tjn)
    out = np.einsum("mbn,abst,xsm,yten->xaey", E, W, Ab, Bk, optimize=True)
    Eo = _cenv_basis(tjx, tka, tke, tKo, tjy)
    return float(np.einsum("xaey,xaey->", out, Eo))


@lru_cache(maxsize=None)
def _probe_cac_center(tka, tkop, tkb, tke, tjp, ident,
                      tjx, tjy, tjmid, tjn, tjmo, tjr) -> float:
    """Matvec term 1: y[(tjx,tjmo,tjr)] += c * gl[(tjx,tjy)]
    B[(tjy,tjmid,tjn)] gr[(tjr,tjn)]^T through one FSM entry."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjn, tkb, tjr)
            and _admissible(tjx, tjp, tjmo) and _admissible(tjmo, tke, tjr)):
        return 0.0
    Gl = _env_basis(tjx, tka, tjy)
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Bk = _csite_basis(tjy, tjp, tjmid, tke, tjn)
    Gr = _env_basis(tjr, tkb, tjn)
    out = np.einsum("xay,abst,yten,rbn->xser", Gl, W, Bk, Gr, optimize=True)
    T = _csite_basis(tjx, tjp, tjmo, tke, tjr)
    return float(np.einsum("xser,xser->", out, T))


@lru_cache(maxsize=None)
def _probe_cac_lb(tka, tkop, tkb, tke, tjp, ident,
                  tjx, tKi, tjy, tjn, tjmo, tjr) -> float:
    """Matvec term 2: y[(tjx,tjmo,tjr)] += c * lB[(tjx,tKi,tjy)]
    AR[(tjy,tjn)] gr[(tjr,tjn)]^T."""
    if not (_admissible(tjy, tKi, tjx) and _admissible(tjn, tkb, tjr)
            and _admissible(tjy, tjp, tjn) and _admissible(tjx, tjp, tjmo)
            and _admissible(tjmo, tke, tjr)):
        return 0.0
    E = _cenv_basis(tjx, tka, tke, tKi, tjy, True)
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ak = _site_basis(tjy, tjp, tjn)
    Gr = _env_basis(tjr, tkb, tjn)
    out = np.einsum("xaey,abst,ytn,rbn->xser", E, W, Ak, Gr, optimize=True)
    T = _csite_basis(tjx, tjp, tjmo, tke, tjr)
    return float(np.einsum("xser,xser->", out, T))


@lru_cache(maxsize=None)
def _probe_cac_rb(tka, tkop, tkb, tke, tjp, ident,
                  tjx, tjy, tjn, tKi, tjr, tjmo) -> float:
    """Matvec term 3: y[(tjx,tjmo,tjr)] += c * gl[(tjx,tjy)]
    AL[(tjy,tjn)] rB[(tjr,tKi,tjn)]^T."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjn, tKi, tjr)
            and _admissible(tjy, tjp, tjn) and _admissible(tjx, tjp, tjmo)
            and _admissible(tjmo, tke, tjr)):
        return 0.0
    Gl = _env_basis(tjx, tka, tjy)
    W = _w_dense(tka, tkop, tkb, tjp, ident)
    Ak = _site_basis(tjy, tjp, tjn)            # ket AL
    E = _cenv_basis(tjr, tkb, tke, tKi, tjn)   # [mr, qb, qe, mn]
    out = np.einsum("xay,abst,ytn,rben->xser", Gl, W, Ak, E, optimize=True)
    T = _csite_basis(tjx, tjp, tjmo, tke, tjr)
    return float(np.einsum("xser,xser->", out, T))


# ----------------------------------------------------------------------------
# Runtime charged kernels (cached term plans)
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _plan_vlx(vl_keys, vl_shapes, x_keys_, x_shapes, tjp, tke):
    keys, shapes, raw = [], [], []
    for xi, (tjm, tjr) in enumerate(x_keys_):
        for vi, (tjl, tjm2) in enumerate(vl_keys):
            if tjm2 != tjm:
                continue
            keys.append((tjl, tjm, tjr))
            shapes.append((vl_shapes[vi][0], x_shapes[xi][1]))
            raw.append((_probe_vlx(tjp, tke, tjl, tjm, tjr), vi, xi))
    order = sorted(range(len(keys)), key=lambda i: keys[i])
    return (tuple(keys[i] for i in order), tuple(shapes[i] for i in order),
            tuple(raw[i] for i in order))


def vl_x(VL: RBlocks, X: RBlocks, tjp: int, tke: int) -> RBlocks:
    """B = VL . X as charged site blocks."""
    keys, shapes, terms = _plan_vlx(VL.keys, VL.shapes, X.keys, X.shapes,
                                    tjp, tke)
    out = RBlocks.zeros(keys, shapes, X.dtype, X.device)
    ov, vv, xv = out.vals, VL.vals, X.vals
    for o, (c, vi, xi) in enumerate(terms):
        ov[o].addmm_(vv[vi], xv[xi], alpha=c)
    return out


@lru_cache(maxsize=None)
def _plan_pullback(vl_keys, y_keys, x_keys_, tjp, tke):
    oidx, vidx = _key_index(x_keys_), _key_index(vl_keys)
    terms = []
    for yi, (tjl, tjm, tjr) in enumerate(y_keys):
        o = oidx.get((tjm, tjr))
        vi = vidx.get((tjl, tjm))
        if o is None or vi is None:
            continue
        terms.append((_probe_pullback(tjp, tke, tjl, tjm, tjr), o, vi, yi))
    return tuple(terms)


def vl_pullback(VL: RBlocks, Y: RBlocks, X_like: RBlocks, tjp: int,
                tke: int) -> RBlocks:
    """X' = VL^dag . Y projected on the X key structure."""
    terms = _plan_pullback(VL.keys, Y.keys, X_like.keys, tjp, tke)
    out = X_like.like(torch.zeros_like(X_like.flat))
    ov, vv, yv = out.vals, VL.vals, Y.vals
    for c, o, vi, yi in terms:
        ov[o].addmm_(vv[vi].mH, yv[yi], alpha=c)
    return out


def _entry_iter(mpo: ReducedMPO):
    """FSM entries plus the implicit identity diagonals, as
    (a, b, tkop, weight, ident)."""
    w = mpo.odim
    out = [(a, b, tkop, wgt, False) for (a, b, tkop, wgt) in mpo.entries]
    out.append((0, 0, 0, 1.0, True))
    out.append((w - 1, w - 1, 0, 1.0, True))
    return tuple(out)


@lru_cache(maxsize=None)
def _plan_cpush_left(lb_keys, entry, mpo, tke, al_keys, ar_keys, out_keys):
    a, b, tkop, wgt, ident = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx = _key_index(out_keys)
    raw = []
    for li, (tjx, tKi, tjy) in enumerate(lb_keys):
        for ai, (tjx2, tjm) in enumerate(al_keys):
            if tjx2 != tjx:
                continue
            for ri, (tjy2, tjn) in enumerate(ar_keys):
                if tjy2 != tjy:
                    continue
                for tKo in _fused_channels(tkb, tke):
                    o = oidx.get((tjm, tKo, tjn))
                    if o is None:
                        continue
                    c = _probe_cpush_left(tka, tkop, tkb, tke, mpo.tjp,
                                          ident, tjx, tKi, tjy, tjm, tKo,
                                          tjn)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, 0, ai, 0, li, 0, ri))
    return _group(raw)


def _acc_cpush_left(lB, entry, mpo, tke, AL, AR, out):
    plan, _ = _plan_cpush_left(lB.keys, entry, mpo, tke, AL.keys, AR.keys,
                               out.keys)
    return _run(plan, out, [AL], _adj, [lB], [AR], _ident)


def cpush_left(lB: RBlocks, entry, mpo: ReducedMPO, tke, AL: RBlocks,
               AR: RBlocks, out: RBlocks) -> RBlocks:
    return _acc_cpush_left(lB, entry, mpo, tke, AL, AR,
                           out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_csrc_left(gl_keys, entry, mpo, tke, al_keys, b_keys, out_keys):
    a, b, tkop, wgt, ident = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx = _key_index(out_keys)
    raw = []
    for gi, (tjx, tjy) in enumerate(gl_keys):
        for ai, (tjx2, tjm) in enumerate(al_keys):
            if tjx2 != tjx:
                continue
            for bi, (tjy2, tjmid, tjn) in enumerate(b_keys):
                if tjy2 != tjy:
                    continue
                for tKo in _fused_channels(tkb, tke):
                    o = oidx.get((tjm, tKo, tjn))
                    if o is None:
                        continue
                    c = _probe_csrc_left(tka, tkop, tkb, tke, mpo.tjp,
                                         ident, tjx, tjy, tjmid, tjn, tjm,
                                         tKo)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, 0, ai, 0, gi, 0, bi))
    return _group(raw)


def _acc_csrc_left(gl, entry, mpo, tke, AL, B, out):
    plan, _ = _plan_csrc_left(gl.keys, entry, mpo, tke, AL.keys, B.keys,
                              out.keys)
    return _run(plan, out, [AL], _adj, [gl], [B], _ident)


def csrc_left(gl: RBlocks, entry, mpo: ReducedMPO, tke, AL: RBlocks,
              B: RBlocks, out: RBlocks) -> RBlocks:
    return _acc_csrc_left(gl, entry, mpo, tke, AL, B,
                          out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_cpush_right(rb_keys, entry, mpo, tke, ar_keys, al_keys, out_keys):
    a, b, tkop, wgt, ident = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx = _key_index(out_keys)
    raw = []
    for ri, (tjm, tKi, tjn) in enumerate(rb_keys):
        for xi, (tjx, tjm2) in enumerate(ar_keys):
            if tjm2 != tjm:
                continue
            for yi, (tjy, tjn2) in enumerate(al_keys):
                if tjn2 != tjn:
                    continue
                for tKo in _fused_channels(tka, tke):
                    o = oidx.get((tjx, tKo, tjy))
                    if o is None:
                        continue
                    c = _probe_cpush_right(tka, tkop, tkb, tke, mpo.tjp,
                                           ident, tjm, tKi, tjn, tjx, tKo,
                                           tjy)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, 0, xi, 0, ri, 0, yi))
    return _group(raw)


def _acc_cpush_right(rB, entry, mpo, tke, AR, AL, out):
    plan, _ = _plan_cpush_right(rB.keys, entry, mpo, tke, AR.keys, AL.keys,
                                out.keys)
    return _run(plan, out, [AR], _conj, [rB], [AL], _tr)


def cpush_right(rB: RBlocks, entry, mpo: ReducedMPO, tke, AR: RBlocks,
                AL: RBlocks, out: RBlocks) -> RBlocks:
    return _acc_cpush_right(rB, entry, mpo, tke, AR, AL,
                            out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_csrc_right(gr_keys, entry, mpo, tke, ar_keys, b_keys, out_keys):
    a, b, tkop, wgt, ident = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx = _key_index(out_keys)
    raw = []
    for gi, (tjm, tjn) in enumerate(gr_keys):
        for xi, (tjx, tjm2) in enumerate(ar_keys):
            if tjm2 != tjm:
                continue
            for bi, (tjy, tjmid, tjn2) in enumerate(b_keys):
                if tjn2 != tjn:
                    continue
                for tKo in _fused_channels(tka, tke):
                    o = oidx.get((tjx, tKo, tjy))
                    if o is None:
                        continue
                    c = _probe_csrc_right(tka, tkop, tkb, tke, mpo.tjp,
                                          ident, tjm, tjn, tjy, tjmid, tjx,
                                          tKo)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, 0, xi, 0, gi, 0, bi))
    return _group(raw)


def _acc_csrc_right(gr, entry, mpo, tke, AR, B, out):
    plan, _ = _plan_csrc_right(gr.keys, entry, mpo, tke, AR.keys, B.keys,
                               out.keys)
    return _run(plan, out, [AR], _conj, [gr], [B], _tr)


def csrc_right(gr: RBlocks, entry, mpo: ReducedMPO, tke, AR: RBlocks,
               B: RBlocks, out: RBlocks) -> RBlocks:
    return _acc_csrc_right(gr, entry, mpo, tke, AR, B,
                           out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_cac(gl_keys, gr_keys, lb_keys, rb_keys, mpo, tke, al_keys, ar_keys,
              b_keys):
    """Terms of the three charged AC-derivative contractions. Operand
    lists: left [gls..., lBs...], middle [B, AR, AL], right [grs...,
    rBs...]."""
    tjp = mpo.tjp
    w = mpo.odim
    raw = []
    for entry in _entry_iter(mpo):
        a, b, tkop, wgt, ident = entry
        tka, tkb = mpo.channels[a], mpo.channels[b]
        glx, grx = _key_index(gl_keys[a]), _key_index(gr_keys[b])
        for o, (tjx, tjmo, tjr) in enumerate(b_keys):
            # term 1: B center
            for bi, (tjy2, tjmid, tjn) in enumerate(b_keys):
                gi, ri = glx.get((tjx, tjy2)), grx.get((tjr, tjn))
                if gi is None or ri is None:
                    continue
                c = _probe_cac_center(tka, tkop, tkb, tke, tjp, ident,
                                      tjx, tjy2, tjmid, tjn, tjmo, tjr)
                if abs(c) < 1e-14:
                    continue
                raw.append((wgt * c, o, a, gi, 0, bi, b, ri))
            # term 2: lB with AR ket
            for li, (tjx2, tKi, tjy) in enumerate(lb_keys[a]):
                if tjx2 != tjx:
                    continue
                for ai, (tjy2, tjn) in enumerate(ar_keys):
                    ri = grx.get((tjr, tjn))
                    if tjy2 != tjy or ri is None:
                        continue
                    c = _probe_cac_lb(tka, tkop, tkb, tke, tjp, ident,
                                      tjx, tKi, tjy, tjn, tjmo, tjr)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, w + a, li, 1, ai, b, ri))
            # term 3: rB with AL ket
            for ai, (tjy, tjn) in enumerate(al_keys):
                gi = glx.get((tjx, tjy))
                if gi is None:
                    continue
                for ri, (tjr2, tKi, tjn2) in enumerate(rb_keys[b]):
                    if tjr2 != tjr or tjn2 != tjn:
                        continue
                    c = _probe_cac_rb(tka, tkop, tkb, tke, tjp, ident,
                                      tjx, tjy, tjn, tKi, tjr, tjmo)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((wgt * c, o, a, gi, 2, ai, w + b, ri))
    return _group(raw)


def cac_apply(gls, grs, lBs, rBs, mpo: ReducedMPO, tke, AL: RBlocks,
              AR: RBlocks, B: RBlocks) -> RBlocks:
    """The three charged AC-derivative terms summed over FSM entries:
    gl W B gr + lB W AR gr + gl W AL rB, on charged site blocks."""
    plan, _ = _plan_cac(tuple(g.keys for g in gls), tuple(g.keys for g in grs),
                        tuple(g.keys for g in lBs), tuple(g.keys for g in rBs),
                        mpo, tke, AL.keys, AR.keys, B.keys)
    return _run(plan, B.like(torch.zeros_like(B.flat)), list(gls) + list(lBs),
                _ident, [B, AR, AL], list(grs) + list(rBs), _tr)


# ----------------------------------------------------------------------------
# Charged B-environments (single-site unit cell, momentum-phased tails)
# ----------------------------------------------------------------------------

def qp_envs_reduced(B: RBlocks, AL: RBlocks, AR: RBlocks, gls, grs,
                    mpo: ReducedMPO, tke: int, phase, tol=1e-10):
    """(lBs, rBs): per-FSM-level charged environments of the single
    B insertion. phase = e^{-ip} (left walk; the right walk uses its
    conjugate), a Python number or 0-dim tensor. For tke != 0 the charged
    transfer is strictly contractive, so identity-diagonal tails are plain
    linsolves."""
    assert tke != 0, (
        "spin-0 reduced excitations coincide with the dense uncharged "
        "path (run excitations_infinite on the embedded state)")
    w = mpo.odim
    secs = _bond_sectors_from_blocks(AL)
    entries = _entry_iter(mpo)
    # the walks below geometric-solve ONLY the identity diagonals at
    # levels 0 / w-1; a diagonal entry at a middle level would need its
    # own linsolve and would be silently skipped: refuse instead
    bad = [e for e in entries
           if e[0] == e[1] and e[0] not in (0, w - 1)]
    if bad:
        raise NotImplementedError(
            "qp_envs_reduced: diagonal FSM entries at middle levels "
            f"{sorted({e[0] for e in bad})} are not supported (each needs "
            "its own geometric-tail linsolve); decompose the interaction "
            "into strictly upper-triangular form first")

    # -- left walk: levels 0..w-1 ----------------------------------------
    lBs = [None] * w
    for b in range(w):
        tkb = mpo.channels[b]
        F = _cenv_zero(secs, tkb, tke, AL)
        for e in entries:
            if e[1] != b:
                continue
            a = e[0]
            if a != b and lBs[a] is not None:
                _acc_cpush_left(lBs[a], e, mpo, tke, AL, AR, F)
            _acc_csrc_left(gls[a], e, mpo, tke, AL, B, F)
        F = F.like(phase * F.flat)
        if b in (0, w - 1):
            ident_e = (b, b, 0, 1.0, True)

            def mv(x, _e=ident_e, _F=F):
                y = _acc_cpush_left(_F.like(x), _e, mpo, tke, AL, AR,
                                    _F.like(torch.zeros_like(x)))
                return phase * y.flat

            lBs[b] = F.like(linsolve(mv, F.flat, a0=1.0, a1=-1.0, tol=tol))
        else:
            lBs[b] = F

    # -- right walk: levels w-1..0 ----------------------------------------
    phase_r = phase.conj() if torch.is_tensor(phase) else np.conj(phase)
    rBs = [None] * w
    for a in range(w - 1, -1, -1):
        tka = mpo.channels[a]
        F = _cenv_zero(secs, tka, tke, AR)
        for e in entries:
            if e[0] != a:
                continue
            b = e[1]
            if b != a and rBs[b] is not None:
                _acc_cpush_right(rBs[b], e, mpo, tke, AR, AL, F)
            _acc_csrc_right(grs[b], e, mpo, tke, AR, B, F)
        F = F.like(phase_r * F.flat)
        if a in (0, w - 1):
            ident_e = (a, a, 0, 1.0, True)

            def mv(x, _e=ident_e, _F=F):
                y = _acc_cpush_right(_F.like(x), _e, mpo, tke, AR, AL,
                                     _F.like(torch.zeros_like(x)))
                return phase_r * y.flat

            rBs[a] = F.like(linsolve(mv, F.flat, a0=1.0, a1=-1.0, tol=tol))
        else:
            rBs[a] = F
    return lBs, rBs


# ----------------------------------------------------------------------------
# The reduced quasiparticle solve
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReducedQP:
    """SU(2)-reduced quasiparticle: X blocks on the left-gauge null bond,
    excitation spin tke/2, momentum p."""
    X: RBlocks
    VL: RBlocks
    tke: int
    momentum: float


def qp_matvec_reduced(X: RBlocks, VL: RBlocks, state: SU2ReducedState,
                      mpo: ReducedMPO, tke: int, gls, grs, E0, phase,
                      env_tol=1e-10) -> RBlocks:
    """(H_eff(p) - E0) X in reduced coordinates."""
    tjp = state.tjp
    B = vl_x(VL, X, tjp, tke)
    lBs, rBs = qp_envs_reduced(B, state.AL, state.AR, gls, grs, mpo, tke,
                               phase, tol=env_tol)
    y = cac_apply(gls, grs, lBs, rBs, mpo, tke, state.AL, state.AR, B)
    Xp = vl_pullback(VL, y, X, tjp, tke)
    return X.like(Xp.flat - E0 * X.flat)


def excitations_su2_reduced(mpo: ReducedMPO, state: SU2ReducedState,
                            momenta, tke: int = 2, num: int = 1,
                            tol: float = 1e-8, krylovdim: int = 20,
                            maxrestarts: int = 60, env_tol: float = 1e-10,
                            generator: torch.Generator = None):
    """Reduced-coordinate quasiparticle excitation energies in the spin
    tke/2 multiplet sector. Returns (energies, qps): energies a
    (n_momenta, num) float64 CPU tensor, qps per-momentum lists of
    ReducedQP. The start vector comes from `generator` (seeded 0 when None)
    on the state's device."""
    from ..config import matmul_precision

    if np.isscalar(momenta):
        momenta = [momenta]
    tjp = state.tjp
    AL, AR, AC, C = state.AL, state.AR, state.AC, state.C
    dtype = AL.dtype

    with matmul_precision():
        gls, grs, _, _ = reduced_ham_envs(AL, AR, C, mpo, tjp, tol=env_tol)
        E0 = tree_dot(AC, rac_apply(gls, grs, mpo, AC)).real / \
            tree_dot(AC, AC).real

        VL = left_null_reduced(AL, tjp)
        secs = _bond_sectors_from_blocks(AL)
        X0 = random_x(VL, secs, tke, dtype, generator)
        assert X0.keys, f"excitation spin {tke}/2 unreachable from the bond"
        X0 = tree_normalize(X0)

        energies, qps = [], []
        for p in momenta:
            if dtype.is_complex:
                phase = complex(np.exp(-1j * p))
            else:
                assert abs(np.sin(p)) < 1e-12, \
                    "momentum != 0 mod pi requires a complex dtype"
                phase = float(np.cos(p))

            found, es = [], []
            shift = 100.0 * (1.0 + abs(to_host(E0)[0]))
            for _ in range(num):
                def mv(v, _found=tuple(found)):
                    y = qp_matvec_reduced(X0.like(v), VL, state, mpo, tke,
                                          gls, grs, E0, phase,
                                          env_tol=env_tol).flat
                    for xf in _found:
                        y = y + (shift * torch.vdot(xf.flat, v)) * xf.flat
                    return y

                res = eigsh_smallest(mv, X0.flat, krylovdim, maxrestarts,
                                     tol, reorth="local")
                es.append(res.eigenvalue)
                found.append(X0.like(res.eigenvector))
            energies.append(es)
            qps.append([ReducedQP(x, VL, tke, float(p)) for x in found])
    return torch.tensor(energies, dtype=torch.float64), qps
