"""SU(2)-reduced FINITE MPS and its algorithm surface (counterpart of
mpskit_tpu/symmetry/su2_finite.py): one-site DMRG, two-site DMRG2 with
dynamic multiplet allocation, OptimalExpand-style bond growth and one-site
TDVP, all in reduced (fusion-tree) coordinates on top of `su2_reduced.py`.

A two-site tensor is an `RBlocks` keyed by the fusion tree
`(2j_l, 2j_mid, 2j_r)`; the middle spin is a tree label with no
multiplicity axis. With unit-norm site bases the composed tree basis has
Frobenius norm 1/sqrt(2j_mid+1), which gives the composition and split
rules below (each is checked against dense embeddings in the tests):

* compose:  theta[(l,m,r)] = A1[(l,m)] @ A2[(m,r)] / sqrt(2j_m+1)
* split:    Theta_m = U S Vh  ->  A1' = sqrt(2j_m+1) U, C = diag(S),
  A2' = sqrt(2j_m+1) Vh; the dense Schmidt values of sector m are
  S/sqrt(2j_m+1), each (2j_m+1)-fold degenerate.

The two-site effective Hamiltonian contracts FSM entry PAIRS through
numerically probed structure coefficients (`_probe_ac2`), with a cached
term plan as in `su2_reduced.rac_apply`.

Deliberate difference: the JAX package splits on the host with numpy's
SVD; here every middle sector's SVD runs on the state's device (`gesvd`
on the card) and one host read per bond brings back the singular values
for the global ranking, as the port's `symmetry.charges._sector_split`
does.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import sqrt
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..linalg.expm import expm_multiply_err
from ..utils.sync import to_host, to_host_array
from .su2 import SU2Bond
from .su2_reduced import (
    RBlocks, ReducedMPO, _admissible, _by_first, _by_second,
    _env_basis, _env_zero, _eig_blocks, _generator, _group, _ident,
    _key_index, _layout, _np, _randn, _run, _sector_offsets, _site_basis,
    _tr, _w_entry_dense, _acc_transfer_left, _acc_transfer_right,
    embed_site, left_qr_reduced, rac_apply, rc_apply, right_lq_reduced,
    rmul_c_left, rmul_c_right, rtransfer_left_plain, rtransfer_right_plain,
    tree_dot, tree_norm, tree_normalize,
)


# ----------------------------------------------------------------------------
# finite bond construction
# ----------------------------------------------------------------------------

def fuse_sectors(secs: Tuple[Tuple[int, int], ...], tjp: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """Fuse every bond sector with the physical spin: multiplicities add
    over all admissible paths."""
    acc: Dict[int, int] = {}
    for tj, m in secs:
        for tjn in range(abs(tj - tjp), tj + tjp + 1, 2):
            acc[tjn] = acc.get(tjn, 0) + m
    return tuple(sorted(acc.items()))


def finite_bonds(L: int, tjp: int, target_tj: int = 0,
                 max_mult: Optional[int] = None
                 ) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """L+1 sector tuples ((2j, mult), ...): forward fusion from the trivial
    left vacuum intersected with backward fusion from the `target_tj`
    right boundary, multiplicities capped at `max_mult`."""
    fwd = [((0, 1),)]
    for _ in range(L):
        nxt = fuse_sectors(fwd[-1], tjp)
        if max_mult is not None:
            nxt = tuple((tj, min(m, max_mult)) for tj, m in nxt)
        fwd.append(nxt)
    bwd = [((target_tj, 1),)]
    for _ in range(L):
        nxt = fuse_sectors(bwd[-1], tjp)
        if max_mult is not None:
            nxt = tuple((tj, min(m, max_mult)) for tj, m in nxt)
        bwd.append(nxt)
    bwd = bwd[::-1]
    bonds = []
    for f, b in zip(fwd, bwd):
        df, db = dict(f), dict(b)
        bonds.append(tuple(sorted((tj, min(df[tj], db[tj]))
                                  for tj in set(df) & set(db))))
    if not bonds[-1] or not all(bonds):
        raise ValueError(
            f"no fusion path to sector {target_tj} on {L} spins")

    # capacity propagation: every sector multiplicity must be reachable by
    # fusing the neighbouring bond (the stacked QR/LQ panels are then
    # never wider than tall, so gauge moves preserve the bond structure)
    def _cap(secs, prev):
        capn = dict(fuse_sectors(prev, tjp))
        return tuple(sorted((tj, min(m, capn.get(tj, 0)))
                            for tj, m in secs if capn.get(tj, 0) > 0))
    for i in range(1, L + 1):
        bonds[i] = _cap(bonds[i], bonds[i - 1])
    for i in range(L - 1, -1, -1):
        bonds[i] = _cap(bonds[i], bonds[i + 1])
    return tuple(bonds)


def _secs_dim(secs) -> int:
    return sum(m * (tj + 1) for tj, m in secs)


def _site_struct(secs_l, tjp, secs_r):
    dl, dr = dict(secs_l), dict(secs_r)
    keys = tuple((tjl, tjr) for tjl in sorted(dl) for tjr in sorted(dr)
                 if _admissible(tjl, tjp, tjr))
    return keys, tuple((dl[k[0]], dr[k[1]]) for k in keys)


def _zeros_site(secs_l, tjp, secs_r, dtype, device) -> RBlocks:
    keys, shapes = _site_struct(secs_l, tjp, secs_r)
    return RBlocks.zeros(keys, shapes, dtype, device)


def _random_site(secs_l, tjp, secs_r, dtype, device, generator) -> RBlocks:
    keys, shapes = _site_struct(secs_l, tjp, secs_r)
    flat = _randn((_layout(shapes)[1],), dtype, device, generator)
    return RBlocks(keys, shapes, flat)


# ----------------------------------------------------------------------------
# state container
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2FiniteMPS:
    """Finite MPS in reduced coordinates. Sites left of `center` are
    left-isometric, right of it right-isometric (dense sense, via the
    sqrt(2j+1)-scaled QR/LQ of `su2_reduced`)."""

    sites: Tuple[RBlocks, ...]
    bonds: Tuple[Tuple[Tuple[int, int], ...], ...]   # L+1 sector tuples
    center: int
    tjp: int

    @property
    def length(self) -> int:
        return len(self.sites)

    @property
    def dtype(self):
        return self.sites[0].dtype

    @property
    def device(self):
        return self.sites[0].device

    @staticmethod
    def random(L: int, tjp: int, target_tj: int = 0,
               max_mult: Optional[int] = 8, dtype=torch.float64,
               device="cuda", generator: torch.Generator = None
               ) -> "SU2FiniteMPS":
        """Gaussian sites on `finite_bonds(L, tjp, target_tj, max_mult)`,
        drawn from `generator` (seeded 0 when None), brought to center 0
        and normalized."""
        bonds = finite_bonds(L, tjp, target_tj, max_mult)
        g = _generator(generator, device)
        sites = [_random_site(bonds[i], tjp, bonds[i + 1], dtype, device, g)
                 for i in range(L)]
        psi = SU2FiniteMPS(tuple(sites), bonds, L - 1, tjp).move_center(0)
        return psi.normalize()

    def move_center(self, i: int) -> "SU2FiniteMPS":
        sites = list(self.sites)
        c = self.center
        while c < i:
            AL, C = left_qr_reduced(sites[c])
            sites[c] = AL
            sites[c + 1] = rmul_c_left(C, sites[c + 1])
            c += 1
        while c > i:
            C, AR = right_lq_reduced(sites[c])
            sites[c] = AR
            sites[c - 1] = rmul_c_right(sites[c - 1], C)
            c -= 1
        return dataclasses.replace(self, sites=tuple(sites), center=i)

    def normalize(self) -> "SU2FiniteMPS":
        sites = list(self.sites)
        sites[self.center] = tree_normalize(sites[self.center])
        return dataclasses.replace(self, sites=tuple(sites))

    def norm(self) -> float:
        return to_host(tree_norm(self.sites[self.center]))[0]

    def astype(self, dtype) -> "SU2FiniteMPS":
        """The same state with every block cast to `dtype` (e.g. complex128
        for real-time evolution)."""
        return dataclasses.replace(
            self, sites=tuple(s.to(dtype) for s in self.sites))

    def to_dense(self) -> np.ndarray:
        """Dense state vector (physical-leg tensor product, left to right),
        for small-L oracle tests only."""
        bonds = [SU2Bond(b) for b in self.bonds]
        v = None
        for i, B in enumerate(self.sites):
            A = embed_site(B, bonds[i], self.tjp, bonds[i + 1])
            v = A if v is None else np.einsum("...a,apb->...pb", v, A)
        return v.reshape(-1, v.shape[-1])

    def schmidt(self, bond: int) -> Dict[int, np.ndarray]:
        """{2j: dense multiplet Schmidt values} at `bond` (1..L-1)."""
        psi = self.move_center(bond - 1)
        _, C = left_qr_reduced(psi.sites[bond - 1])
        out = {}
        for (tj, _), M in C.items():
            s = np.linalg.svd(_np(M), compute_uv=False)
            out[tj] = np.sort(s)[::-1] / sqrt(tj + 1)
        return out

    def entropy(self, bond: int) -> float:
        """Von Neumann entanglement entropy of the dense state at `bond`
        (each multiplet value enters with its (2j+1) degeneracy)."""
        S = self.schmidt(bond)
        tot = sum((tj + 1) * float(np.sum(s ** 2)) for tj, s in S.items())
        ent = 0.0
        for tj, s in S.items():
            p = (s ** 2) / tot
            p = p[p > 1e-30]
            ent -= (tj + 1) * float(np.sum(p * np.log(p)))
        return ent


# ----------------------------------------------------------------------------
# finite environments
# ----------------------------------------------------------------------------

def _radd(acc: RBlocks, other: RBlocks) -> RBlocks:
    """acc + other on other's keys (a subset of acc's), in place."""
    for k, v in other.items():
        acc[k].add_(v)
    return acc


def _identity_env(secs, dtype, device) -> RBlocks:
    """Reduced identity environment on a bond (identity_c convention)."""
    d = dict(secs)
    return RBlocks.from_blocks(
        tuple((tj, tj) for tj in sorted(d)),
        [sqrt(tj + 1) * torch.eye(d[tj], dtype=dtype, device=device)
         for tj in sorted(d)])


def left_boundary_reduced(secs, mpo: ReducedMPO, dtype, device="cuda"):
    """gls at the leftmost bond: level 0 identity, others zero."""
    like = torch.empty(0, dtype=dtype, device=device)
    return tuple(_identity_env(secs, dtype, device) if b == 0
                 else _env_zero(tuple(secs), mpo.channels[b], like)
                 for b in range(mpo.odim))


def right_boundary_reduced(secs, mpo: ReducedMPO, dtype, device="cuda"):
    like = torch.empty(0, dtype=dtype, device=device)
    w = mpo.odim
    return tuple(_identity_env(secs, dtype, device) if a == w - 1
                 else _env_zero(tuple(secs), mpo.channels[a], like)
                 for a in range(w))


def push_left_reduced(gls, site: RBlocks, mpo: ReducedMPO, new_secs):
    """Push the whole FSM-level environment stack through one
    left-isometric site."""
    w = mpo.odim
    out = []
    for b in range(w):
        acc = _env_zero(tuple(new_secs), mpo.channels[b], site)
        for entry in mpo.entries_into(b):
            _acc_transfer_left(gls[entry[0]], entry, mpo, site, acc)
        if b in (0, w - 1):
            _radd(acc, rtransfer_left_plain(gls[b], site, site, mpo.tjp))
        out.append(acc)
    return tuple(out)


def push_right_reduced(grs, site: RBlocks, mpo: ReducedMPO, new_secs):
    w = mpo.odim
    out = []
    for a in range(w):
        acc = _env_zero(tuple(new_secs), mpo.channels[a], site)
        for entry in mpo.entries_from(a):
            _acc_transfer_right(grs[entry[1]], entry, mpo, site, acc)
        if a in (0, w - 1):
            _radd(acc, rtransfer_right_plain(grs[a], site, site, mpo.tjp))
        out.append(acc)
    return tuple(out)


def compute_right_envs_reduced(psi: SU2FiniteMPS, mpo: ReducedMPO):
    """GRs[i] = environment stack right of site i, for i = 0..L-1 (site
    tensors right of the center must be right-isometric)."""
    L = psi.length
    grs = right_boundary_reduced(psi.bonds[L], mpo, psi.dtype, psi.device)
    out = [None] * L
    out[L - 1] = grs
    for i in range(L - 1, 0, -1):
        grs = push_right_reduced(grs, psi.sites[i], mpo, psi.bonds[i])
        out[i - 1] = grs
    return out


def _left_env_stack(sites, bonds, mpo, dtype, device):
    """[gls left of site i for i in 0..L-1] over left-isometric sites."""
    L = len(sites)
    out = [None] * L
    gl = left_boundary_reduced(bonds[0], mpo, dtype, device)
    for i in range(L):
        out[i] = gl
        if i < L - 1:
            gl = push_left_reduced(gl, sites[i], mpo, bonds[i + 1])
    return out


def energy_reduced(psi: SU2FiniteMPS, mpo: ReducedMPO) -> float:
    """<psi|H|psi> / <psi|psi> via the center-site effective Hamiltonian."""
    i = psi.center
    gls = left_boundary_reduced(psi.bonds[0], mpo, psi.dtype, psi.device)
    for k in range(i):
        gls = push_left_reduced(gls, psi.sites[k], mpo, psi.bonds[k + 1])
    grs = right_boundary_reduced(psi.bonds[psi.length], mpo, psi.dtype,
                                 psi.device)
    for k in range(psi.length - 1, i, -1):
        grs = push_right_reduced(grs, psi.sites[k], mpo, psi.bonds[k])
    ac = psi.sites[i]
    num, den = to_host(tree_dot(ac, rac_apply(gls, grs, mpo, ac)).real,
                       tree_dot(ac, ac).real)
    return num / den


# ----------------------------------------------------------------------------
# two-site machinery
# ----------------------------------------------------------------------------

def theta_keys(secs_l, tjp: int, secs_r) -> Tuple[tuple, ...]:
    """(2j_l, 2j_mid, 2j_r) trees admissible between the OUTER bonds (the
    middle spin ranges over all fusion channels, which lets the split
    re-allocate multiplets)."""
    dl, dr = dict(secs_l), dict(secs_r)
    keys = []
    for tjl in sorted(dl):
        for tjr in sorted(dr):
            lo = max(abs(tjl - tjp), abs(tjr - tjp))
            hi = min(tjl + tjp, tjr + tjp)
            for tjm in range(lo, hi + 1, 2):
                if _admissible(tjl, tjp, tjm) and _admissible(tjm, tjp, tjr):
                    keys.append((tjl, tjm, tjr))
    return tuple(keys)


def _outer_secs(A1: RBlocks, A2: RBlocks):
    secs_l = tuple(sorted({(k[0], s[0]) for k, s in zip(A1.keys, A1.shapes)}))
    secs_r = tuple(sorted({(k[1], s[1]) for k, s in zip(A2.keys, A2.shapes)}))
    return secs_l, secs_r


def compose_theta(A1: RBlocks, A2: RBlocks, tjp: int,
                  keys: Optional[tuple] = None) -> RBlocks:
    """Two-site tensor from adjacent site tensors (see module docstring).
    `keys` may supply a larger tree set (extra blocks start at zero)."""
    secs_l, secs_r = _outer_secs(A1, A2)
    if keys is None:
        keys = theta_keys(secs_l, tjp, secs_r)
    dl, dr = dict(secs_l), dict(secs_r)
    vals = []
    for (tjl, tjm, tjr) in keys:
        b1 = A1.get((tjl, tjm))
        b2 = A2.get((tjm, tjr))
        if b1 is None or b2 is None:
            vals.append(torch.zeros((dl[tjl], dr[tjr]), dtype=A1.dtype,
                                    device=A1.device))
        else:
            vals.append((b1 @ b2) / sqrt(tjm + 1))
    return RBlocks.from_blocks(keys, vals)


def _sector_svds(theta: RBlocks, mids):
    """Per middle sector: (rmeta, cmeta, U, s, Vh) of the stacked block
    matrix Theta_m, factorized on theta's device."""
    svd_kw = {"driver": "gesvd"} if theta.flat.is_cuda else {}
    out = {}
    for tjm in mids:
        rows = sorted({k[0] for k in theta.keys if k[1] == tjm})
        cols = sorted({k[2] for k in theta.keys if k[1] == tjm})
        rmeta, blocks = [], []
        for tjl in rows:
            row = [theta[(tjl, tjm, tjr)] for tjr in cols]
            rmeta.append((tjl, row[0].shape[0]))
            blocks.append(torch.cat(row, dim=1))
        cmeta = [(tjr, theta[(rows[0], tjm, tjr)].shape[1]) for tjr in cols]
        U, s, Vh = torch.linalg.svd(torch.cat(blocks, dim=0),
                                    full_matrices=False, **svd_kw)
        out[tjm] = (rmeta, cmeta, U, s, Vh)
    return out


def split_theta(theta: RBlocks, tjp: int, max_mult: Optional[int] = None,
                max_dense: Optional[int] = None, trunc_tol: float = 0.0):
    """Per-middle-sector SVD with global dense-Schmidt ranking.

    Returns (A1, C, A2, new_secs, err): A1 left-isometric, A2
    right-isometric, C the bond matrix on the new middle bond (identity_c
    convention), err the dense relative truncation error (a host float).
    One host read brings back every sector's singular values."""
    mids = sorted({k[1] for k in theta.keys})
    svds = _sector_svds(theta, mids)
    host = to_host_array(*[svds[m][3] for m in mids]).real.astype(np.float64)
    svals, pos = {}, 0
    for tjm in mids:
        n = svds[tjm][3].shape[0]
        svals[tjm] = host[pos:pos + n]
        pos += n
    total2 = float(sum(np.sum(s ** 2) for s in svals.values()))

    # global ranking by DENSE Schmidt value s/sqrt(2j+1); dense cost 2j+1
    ranked = sorted(((float(sv) / sqrt(tjm + 1), tjm, k)
                     for tjm, s in svals.items()
                     for k, sv in enumerate(s)), reverse=True)
    counts: Dict[int, int] = {}
    dense_used, kept2 = 0, 0.0
    for sd, tjm, k in ranked:
        if sd <= 1e-300:
            continue
        if trunc_tol > 0.0 and counts and \
                total2 - kept2 <= trunc_tol ** 2 * total2:
            break   # remaining weight is below the truncation tolerance
        if max_dense is not None and dense_used + tjm + 1 > max_dense:
            continue
        if max_mult is not None and counts.get(tjm, 0) >= max_mult:
            continue
        counts[tjm] = counts.get(tjm, 0) + 1
        dense_used += tjm + 1
        kept2 += (sd * sqrt(tjm + 1)) ** 2
    new_secs = tuple(sorted((tjm, n) for tjm, n in counts.items() if n > 0))
    err = sqrt(max(total2 - kept2, 0.0) / max(total2, 1e-300))

    a1, a2 = {}, {}
    ckeys, cvals = [], []
    for tjm, n in new_secs:
        rmeta, cmeta, U, s, Vh = svds[tjm]
        sq = sqrt(tjm + 1)
        Un, Vn = U[:, :n], Vh[:n]
        pos = 0
        for tjl, nl in rmeta:
            a1[(tjl, tjm)] = sq * Un[pos:pos + nl]
            pos += nl
        pos = 0
        for tjr, nr in cmeta:
            a2[(tjm, tjr)] = sq * Vn[:, pos:pos + nr]
            pos += nr
        # C = diag(s) WITHOUT the sqrt(2j+1) factor: compose(A1,
        # rmul_c_left(C, A2)) then reconstructs theta exactly
        ckeys.append((tjm, tjm))
        cvals.append(torch.diag(s[:n]).to(theta.dtype))
    k1, k2 = tuple(sorted(a1)), tuple(sorted(a2))
    A1 = RBlocks.from_blocks(k1, [a1[k] for k in k1])
    A2 = RBlocks.from_blocks(k2, [a2[k] for k in k2])
    return A1, RBlocks.from_blocks(ckeys, cvals), A2, new_secs, err


@lru_cache(maxsize=None)
def _pair_basis(tjl: int, tjp: int, tjm: int, tjr: int) -> np.ndarray:
    """Unit-norm two-site tree basis T[ml, p1, p2, mr]."""
    E1 = _site_basis(tjl, tjp, tjm)
    E2 = _site_basis(tjm, tjp, tjr)
    return np.einsum("lpm,mqr->lpqr", E1, E2) * sqrt(tjm + 1)


def _w_dense(tka, tkop, tkb, tjp, identity: bool):
    """Dense channel-form FSM entry [qa, qb, s, t]; identity entries (the
    implicit diagonals at FSM levels 0 and w-1) are delta on the channel
    index tensor identity on the physical spin."""
    if identity:
        if tka != tkb:
            return None
        return np.einsum("ab,st->abst", np.eye(tka + 1), np.eye(tjp + 1))
    if not _admissible(tka, tkop, tkb):
        return None
    return _w_entry_dense(tka, tkop, tkb, tjp)


@lru_cache(maxsize=None)
def _probe_ac2(tka: int, tkop1: int, tkc: int, tkop2: int, tkb: int,
               id1: bool, id2: bool, tjp: int,
               tjx: int, tjy: int, tjm_in: int, tjn: int,
               tjm_out: int, tjr: int) -> float:
    """Structure coefficient of one FSM entry PAIR in the two-site
    effective Hamiltonian: out[(tjx, tjm_out, tjr)] +=
    coeff * gl[(tjx,tjy)] theta[(tjy, tjm_in, tjn)] gr[(tjr,tjn)]^T."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjn, tkb, tjr)):
        return 0.0
    if not (_admissible(tjy, tjp, tjm_in) and _admissible(tjm_in, tjp, tjn)):
        return 0.0
    if not (_admissible(tjx, tjp, tjm_out)
            and _admissible(tjm_out, tjp, tjr)):
        return 0.0
    W1 = _w_dense(tka, tkop1, tkc, tjp, id1)   # [qa, qc, s1, t1]
    W2 = _w_dense(tkc, tkop2, tkb, tjp, id2)   # [qc, qb, s2, t2]
    if W1 is None or W2 is None:
        return 0.0
    Gl = _env_basis(tjx, tka, tjy)             # [mx, qa, my]
    Tin = _pair_basis(tjy, tjp, tjm_in, tjn)   # [my, t1, t2, mn]
    Gr = _env_basis(tjr, tkb, tjn)             # [mr, qb, mn]
    out = np.einsum("xay,acuv,cbpq,yvqn,rbn->xupr",
                    Gl, W1, W2, Tin, Gr, optimize=True)
    Tout = _pair_basis(tjx, tjp, tjm_out, tjr)
    return float(np.einsum("xupr,xupr->", out, Tout))


def embed_theta(theta: RBlocks, secs_l, tjp: int, secs_r) -> np.ndarray:
    """Dense (Dl, d, d, Dr) two-site tensor (oracle tests only)."""
    bl, br = SU2Bond(tuple(secs_l)), SU2Bond(tuple(secs_r))
    offL, offR = _sector_offsets(bl), _sector_offsets(br)
    d = tjp + 1
    out = np.zeros((bl.dim, d, d, br.dim), _np(theta.flat).dtype)
    for (tjl, tjm, tjr), blk in theta.items():
        (l0, nl), (r0, nr) = offL[tjl], offR[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _pair_basis(tjl, tjp, tjm, tjr)      # [ml, p1, p2, mr]
        blkT = np.einsum("ab,lpqr->alpqbr", _np(blk), T)
        out[l0:l0 + nl * dl, :, :, r0:r0 + nr * dr] += blkT.reshape(
            nl * dl, d, d, nr * dr)
    return out


def restrict_theta(A: np.ndarray, secs_l, tjp: int, secs_r,
                   device="cuda") -> RBlocks:
    """Reduced tree coefficients of a dense two-site tensor."""
    bl, br = SU2Bond(tuple(secs_l)), SU2Bond(tuple(secs_r))
    offL, offR = _sector_offsets(bl), _sector_offsets(br)
    keys = theta_keys(secs_l, tjp, secs_r)
    vals = []
    for (tjl, tjm, tjr) in keys:
        (l0, nl), (r0, nr) = offL[tjl], offR[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _pair_basis(tjl, tjp, tjm, tjr)
        view = np.asarray(A)[l0:l0 + nl * dl, :, :, r0:r0 + nr * dr].reshape(
            nl, dl, tjp + 1, tjp + 1, nr, dr)
        vals.append(torch.as_tensor(np.einsum("alpqbr,lpqr->ab", view, T),
                                    device=device))
    return RBlocks.from_blocks(keys, vals)


def _entry_pairs(mpo: ReducedMPO):
    """All FSM entry pairs (W1 at site i, W2 at site i+1) with matching
    middle level, including the implicit identity diagonals."""
    w = mpo.odim
    full = list(mpo.entries) + [(0, 0, 0, None), (w - 1, w - 1, 0, None)]
    return [(e1, e2) for e1 in full for e2 in full if e1[1] == e2[0]]


@lru_cache(maxsize=None)
def _plan_theta(gl_keys, gr_keys, mpo, th_keys):
    tjp = mpo.tjp
    oidx, tfirst = _key_index(th_keys), _by_first(th_keys)
    out_by_lr: Dict[tuple, list] = {}
    for o, k in enumerate(th_keys):
        out_by_lr.setdefault((k[0], k[2]), []).append(o)
    raw = []
    for (a, c, tk1, w1), (_, b, tk2, w2) in _entry_pairs(mpo):
        tka, tkc, tkb = mpo.channels[a], mpo.channels[c], mpo.channels[b]
        id1, id2 = w1 is None, w2 is None
        wgt = (1.0 if id1 else w1) * (1.0 if id2 else w2)
        grsecond = _by_second(gr_keys[b])
        for gi, (tjx, tjy) in enumerate(gl_keys[a]):
            for ti in tfirst.get(tjy, ()):
                _, tjm_in, tjn = th_keys[ti]
                for ri in grsecond.get(tjn, ()):
                    tjr = gr_keys[b][ri][0]
                    for o in out_by_lr.get((tjx, tjr), ()):
                        c_ = _probe_ac2(tka, tk1, tkc, tk2, tkb, id1, id2,
                                        tjp, tjx, tjy, tjm_in, tjn,
                                        th_keys[o][1], tjr)
                        if abs(c_) < 1e-14:
                            continue
                        raw.append((wgt * c_, o, a, gi, 0, ti, b, ri))
    return _group(raw)


def rtheta_apply(gls, grs, mpo: ReducedMPO, theta: RBlocks) -> RBlocks:
    """Two-site effective Hamiltonian in reduced coordinates."""
    plan, _ = _plan_theta(tuple(g.keys for g in gls),
                          tuple(g.keys for g in grs), mpo, theta.keys)
    return _run(plan, theta.like(torch.zeros_like(theta.flat)), gls, _ident,
                [theta], grs, _tr)


# ----------------------------------------------------------------------------
# DMRG / DMRG2
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2DMRG:
    tol: float = 1e-10
    maxiter: int = 100
    krylovdim: int = 10
    eig_maxrestarts: int = 6
    verbosity: int = 0


@dataclasses.dataclass(frozen=True)
class SU2DMRG2:
    tol: float = 1e-10
    maxiter: int = 100
    krylovdim: int = 10
    eig_maxrestarts: int = 6
    max_mult: Optional[int] = None      # per-sector multiplet cap
    max_dense: Optional[int] = None     # dense bond-dimension cap
    trunc_tol: float = 0.0
    verbosity: int = 0


def _solve_site(mpo, gls, grs, AC, m, restarts, tol):
    res, x = _eig_blocks(lambda v: rac_apply(gls, grs, mpo, v), AC, m,
                         restarts, tol)
    return res.eigenvalue, tree_normalize(x)


def _solve_theta(mpo, gls, grs, theta, m, restarts, tol):
    res, x = _eig_blocks(lambda v: rtheta_apply(gls, grs, mpo, v), theta, m,
                         restarts, tol)
    return res.eigenvalue, tree_normalize(x)


def find_groundstate_su2_finite_dmrg(psi: SU2FiniteMPS, mpo: ReducedMPO,
                                     alg: SU2DMRG = SU2DMRG()):
    """One-site DMRG on the reduced finite MPS. Returns (psi, E, eps)."""
    from ..config import matmul_precision

    L = psi.length
    dtype, device = psi.dtype, psi.device
    psi = psi.move_center(0).normalize()
    sites = list(psi.sites)
    tol_in = max(alg.tol * 1e-2, 1e-14)
    lam, eps = 0.0, 1.0
    with matmul_precision():
        GRs = compute_right_envs_reduced(psi, mpo)
        for it in range(1, alg.maxiter + 1):
            lam_prev = lam
            gls = left_boundary_reduced(psi.bonds[0], mpo, dtype, device)
            # left-to-right
            for i in range(L - 1):
                lam, ac = _solve_site(mpo, gls, GRs[i], sites[i],
                                      alg.krylovdim, alg.eig_maxrestarts,
                                      tol_in)
                AL, C = left_qr_reduced(ac)
                sites[i] = AL
                sites[i + 1] = rmul_c_left(C, sites[i + 1])
                gls = push_left_reduced(gls, AL, mpo, psi.bonds[i + 1])
            # right-to-left: left envs per site (sites 0..i-1 are AL-form)
            grs = right_boundary_reduced(psi.bonds[L], mpo, dtype, device)
            gls_stack = _left_env_stack(sites, psi.bonds, mpo, dtype, device)
            for i in range(L - 1, 0, -1):
                lam, ac = _solve_site(mpo, gls_stack[i], grs, sites[i],
                                      alg.krylovdim, alg.eig_maxrestarts,
                                      tol_in)
                C, AR = right_lq_reduced(ac)
                sites[i] = AR
                sites[i - 1] = rmul_c_right(sites[i - 1], C)
                grs = push_right_reduced(grs, AR, mpo, psi.bonds[i])
                GRs[i - 1] = grs
            sites[0] = tree_normalize(sites[0])
            psi = dataclasses.replace(psi, sites=tuple(sites), center=0)
            eps = abs(lam - lam_prev) if it > 1 else 1.0
            if alg.verbosity >= 2:
                print(f"SU2-DMRG it {it}: E = {lam:.12f} dE = {eps:.2e}")
            if eps < alg.tol:
                break
    return psi, lam, eps


def find_groundstate_su2_finite_dmrg2(psi: SU2FiniteMPS, mpo: ReducedMPO,
                                      alg: SU2DMRG2 = SU2DMRG2()):
    """Two-site DMRG with dynamic multiplet allocation: the split's
    per-sector SVD re-allocates middle-bond multiplets every update.
    Returns (psi, E, max(eps, truncation error))."""
    from ..config import matmul_precision

    L = psi.length
    dtype, device = psi.dtype, psi.device
    psi = psi.move_center(0).normalize()
    sites = list(psi.sites)
    bonds = list(psi.bonds)
    tol_in = max(alg.tol * 1e-2, 1e-14)
    lam, eps, trunc = 0.0, 1.0, 0.0
    split = dict(max_mult=alg.max_mult, max_dense=alg.max_dense,
                 trunc_tol=alg.trunc_tol)
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            lam_prev = lam
            trunc = 0.0
            # right envs anew (the bond structure may have changed)
            cur = SU2FiniteMPS(tuple(sites), tuple(bonds), 0, psi.tjp)
            GRs = compute_right_envs_reduced(cur, mpo)
            gls = left_boundary_reduced(bonds[0], mpo, dtype, device)
            for i in range(L - 1):
                theta0 = compose_theta(sites[i], sites[i + 1], psi.tjp)
                lam, th = _solve_theta(mpo, gls, GRs[i + 1], theta0,
                                       alg.krylovdim, alg.eig_maxrestarts,
                                       tol_in)
                A1, C, A2, new_secs, err = split_theta(th, psi.tjp, **split)
                trunc = max(trunc, err)
                bonds[i + 1] = new_secs
                sites[i] = A1
                sites[i + 1] = rmul_c_left(C, A2)
                if i < L - 2:
                    gls = push_left_reduced(gls, A1, mpo, bonds[i + 1])
            # right-to-left
            grs = right_boundary_reduced(bonds[L], mpo, dtype, device)
            gls_stack = _left_env_stack(sites, bonds, mpo, dtype, device)
            for i in range(L - 2, -1, -1):
                theta0 = compose_theta(sites[i], sites[i + 1], psi.tjp)
                lam, th = _solve_theta(mpo, gls_stack[i], grs, theta0,
                                       alg.krylovdim, alg.eig_maxrestarts,
                                       tol_in)
                A1, C, A2, new_secs, err = split_theta(th, psi.tjp, **split)
                trunc = max(trunc, err)
                bonds[i + 1] = new_secs
                sites[i + 1] = A2
                sites[i] = rmul_c_right(A1, C)
                grs = push_right_reduced(grs, A2, mpo, bonds[i + 1])
            sites[0] = tree_normalize(sites[0])
            psi = SU2FiniteMPS(tuple(sites), tuple(bonds), 0, psi.tjp)
            eps = abs(lam - lam_prev) if it > 1 else 1.0
            if alg.verbosity >= 2:
                print(f"SU2-DMRG2 it {it}: E = {lam:.12f} dE = {eps:.2e} "
                      f"trunc = {trunc:.2e}")
            if eps < alg.tol:
                break
    return psi, lam, max(eps, trunc)


# ----------------------------------------------------------------------------
# OptimalExpand-style bond growth
# ----------------------------------------------------------------------------

def expand_bond_reduced(psi: SU2FiniteMPS, mpo: ReducedMPO, bond: int,
                        extra_mult: int = 1,
                        max_mult: Optional[int] = None) -> SU2FiniteMPS:
    """Grow `bond` (1..L-1) with the dominant multiplets of the two-site
    tangent-space residual, projected off the current column space per
    middle sector, so the expansion allocates MULTIPLETS, including
    sectors absent from the current bond. The new directions are appended
    to the left-isometric site bond-1 (orthonormal to its columns, so it
    stays left-isometric) and zero rows to site bond, which becomes the
    center: the state is exactly unchanged. The residual SVDs run on the
    state's device; one host read brings back their singular values."""
    i = bond - 1
    psi = psi.move_center(i + 1)   # site i is AL-form, site i+1 the center
    sites = list(psi.sites)
    bonds = list(psi.bonds)
    L = psi.length
    dtype, device = psi.dtype, psi.device
    gls = left_boundary_reduced(bonds[0], mpo, dtype, device)
    for k in range(i):
        gls = push_left_reduced(gls, sites[k], mpo, bonds[k + 1])
    grs = right_boundary_reduced(bonds[L], mpo, dtype, device)
    for k in range(L - 1, i + 1, -1):
        grs = push_right_reduced(grs, sites[k], mpo, bonds[k])

    AL = sites[i]                  # already left-isometric
    theta = compose_theta(AL, sites[i + 1], psi.tjp)
    hth = rtheta_apply(gls, grs, mpo, theta)

    # project off the current left column space per middle sector
    mids_cur = dict(bonds[i + 1])
    mids = sorted({k[1] for k in hth.keys})
    svd_kw = {"driver": "gesvd"} if hth.flat.is_cuda else {}
    svds = {}
    for tjm in mids:
        rows = sorted({k[0] for k in hth.keys if k[1] == tjm})
        cols = sorted({k[2] for k in hth.keys if k[1] == tjm})
        rmeta = [(tjl, hth[(tjl, tjm, cols[0])].shape[0]) for tjl in rows]
        M = torch.cat([torch.cat([hth[(tjl, tjm, tjr)] for tjr in cols],
                                 dim=1) for tjl in rows], dim=0)
        if tjm in mids_cur:
            Q = torch.cat(
                [AL.get((tjl, tjm), torch.zeros(
                    (nl, mids_cur[tjm]), dtype=dtype, device=device))
                 for tjl, nl in rmeta], dim=0) / sqrt(tjm + 1)
            M = M - Q @ (Q.mH @ M)
        U, s, _ = torch.linalg.svd(M, full_matrices=False, **svd_kw)
        svds[tjm] = (rmeta, U, s)
    host = to_host_array(*[svds[m][2] for m in mids]).real.astype(np.float64)
    svals, pos = {}, 0
    for tjm in mids:
        n = svds[tjm][2].shape[0]
        svals[tjm] = host[pos:pos + n]
        pos += n

    ranked = sorted(((float(sv) / sqrt(tjm + 1), tjm, k)
                     for tjm, s in svals.items()
                     for k, sv in enumerate(s)), reverse=True)
    # fusion capacity of the neighbouring bonds: growing a sector beyond
    # what either side can support adds directions that can never acquire
    # weight (and would break the fixed-bond gauge moves)
    cap_l = dict(fuse_sectors(tuple(bonds[i]), psi.tjp))
    cap_r = dict(fuse_sectors(tuple(bonds[i + 2]), psi.tjp))
    counts: Dict[int, int] = {}
    budget = extra_mult
    for sd, tjm, k in ranked:
        if budget <= 0 or sd <= 1e-14:
            break
        new_m = mids_cur.get(tjm, 0) + counts.get(tjm, 0)
        if max_mult is not None and new_m >= max_mult:
            continue
        if new_m >= min(cap_l.get(tjm, 0), cap_r.get(tjm, 0)):
            continue
        counts[tjm] = counts.get(tjm, 0) + 1
        budget -= 1

    if not counts:
        return psi
    new_secs = dict(mids_cur)
    for tjm, n in counts.items():
        new_secs[tjm] = new_secs.get(tjm, 0) + n
    new_secs_t = tuple(sorted(new_secs.items()))

    # site i: the orthonormal residual columns appended at the end of each
    # grown sector block (it stays left-isometric); site i+1: zero rows
    grown = _zeros_site(bonds[i], psi.tjp, new_secs_t, dtype, device)
    for (tjl, tjm), blk in AL.items():
        grown[(tjl, tjm)][:, : blk.shape[1]] = blk
    for tjm, n in counts.items():
        rmeta, U, _ = svds[tjm]
        cols = sqrt(tjm + 1) * U[:, :n]
        base = mids_cur.get(tjm, 0)
        pos = 0
        for tjl, nl in rmeta:
            if (tjl, tjm) in grown:
                grown[(tjl, tjm)][:, base: base + n] = cols[pos: pos + nl]
            pos += nl
    next_grown = _zeros_site(new_secs_t, psi.tjp, bonds[i + 2], dtype,
                             device)
    for (tjm, tjr), blk in sites[i + 1].items():
        next_grown[(tjm, tjr)][: blk.shape[0]] = blk
    sites[i] = grown
    sites[i + 1] = next_grown
    bonds[i + 1] = new_secs_t
    return SU2FiniteMPS(tuple(sites), tuple(bonds), i + 1, psi.tjp)


# ----------------------------------------------------------------------------
# one-site TDVP
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2TDVP:
    dt: float = 0.05
    krylovdim: int = 20
    imaginary: bool = False   # exp(-dt H) instead of exp(-i dt H)


def _evolve(op, x: RBlocks, m, tau):
    y, err = expm_multiply_err(lambda v: op(x.like(v)).flat, x.flat, tau, m)
    return x.like(y), err


def timestep_su2_finite_tdvp(psi: SU2FiniteMPS, mpo: ReducedMPO,
                             alg: SU2TDVP = SU2TDVP()):
    """One symmetric left-right/right-left TDVP sweep of step dt. Complex
    dtype for real-time evolution; imaginary time in real dtypes. Returns
    (psi, max_krylov_err)."""
    from ..config import matmul_precision

    tau = -alg.dt / 2 if alg.imaginary else -0.5j * alg.dt
    if not alg.imaginary and not psi.dtype.is_complex:
        raise TypeError("real-time SU(2) TDVP needs a complex state "
                        "(SU2FiniteMPS.astype(torch.complex128))")
    L = psi.length
    dtype, device = psi.dtype, psi.device
    m = alg.krylovdim
    err = 0.0
    with matmul_precision():
        psi = psi.move_center(0)
        sites = list(psi.sites)
        GRs = compute_right_envs_reduced(psi, mpo)
        gls = left_boundary_reduced(psi.bonds[0], mpo, dtype, device)

        def ac_op(gl, gr):
            return lambda v: rac_apply(gl, gr, mpo, v)

        def c_op(gl, gr):
            return lambda v: rc_apply(gl, gr, mpo, v)

        # L2R half sweep (dt/2)
        for i in range(L):
            ac, e = _evolve(ac_op(gls, GRs[i]), sites[i], m, tau)
            ac = tree_normalize(ac)
            err = max(err, e)
            if i < L - 1:
                AL, C = left_qr_reduced(ac)
                sites[i] = AL
                gls = push_left_reduced(gls, AL, mpo, psi.bonds[i + 1])
                C, e = _evolve(c_op(gls, GRs[i]), C, m, -tau)
                C = tree_normalize(C)
                err = max(err, e)
                sites[i + 1] = rmul_c_left(C, sites[i + 1])
            else:
                sites[i] = ac
        # R2L half sweep (dt/2)
        grs = right_boundary_reduced(psi.bonds[L], mpo, dtype, device)
        gls_stack = _left_env_stack(sites, psi.bonds, mpo, dtype, device)
        for i in range(L - 1, -1, -1):
            ac, e = _evolve(ac_op(gls_stack[i], grs), sites[i], m, tau)
            ac = tree_normalize(ac)
            err = max(err, e)
            if i > 0:
                C, AR = right_lq_reduced(ac)
                sites[i] = AR
                grs = push_right_reduced(grs, AR, mpo, psi.bonds[i])
                C, e = _evolve(c_op(gls_stack[i], grs), C, m, -tau)
                C = tree_normalize(C)
                err = max(err, e)
                sites[i - 1] = rmul_c_right(sites[i - 1], C)
            else:
                sites[i] = tree_normalize(ac)
    return SU2FiniteMPS(tuple(sites), psi.bonds, 0, psi.tjp), err
