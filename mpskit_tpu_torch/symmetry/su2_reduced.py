"""SU(2) reduced-coordinate (fusion-tree) fast path (counterpart of
mpskit_tpu/symmetry/su2_reduced.py).

A reduced site tensor stores one multiplicity matrix per admissible
`(2j_left, 2j_right)` pair, the coefficients of the dense tensor in the
ORTHONORMAL (unit Frobenius norm) Clebsch-Gordan basis, so the plain
Frobenius metric on blocks equals the dense metric. MPO FSM levels carry
irrep labels (`ReducedMPO.channels`); the scalar structure coefficients
of every contraction are probed numerically on the host (`_probe_*`,
numpy, cached per spin structure), exactly as the JAX package probes
them, so every phase convention is self-consistent by construction.

Differences of design from the JAX package:

* `RBlocks` holds its static keys and block shapes and ONE flat tensor;
  each block is a view at a fixed offset. The shared Krylov solvers
  (`eigsh_smallest`, `linsolve_info`, `expm_multiply_err`) run unchanged
  on `.flat`, whose inner product is the JAX package's `tree_dot`.
* The JAX package walks the nested key loops once, at trace time. Eager
  PyTorch would walk them on every matvec, so every contraction builds
  its TERM PLAN once per (MPO, block structure) and caches it: a list of
  (coefficient, output block, operand blocks), grouped so that a left
  product shared by several terms is formed once. The matvec then walks
  the plan: one GEMM per group and one `addmm_` per term, on blocks too
  small to fill the card, so this path is host-bound there.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import prod, sqrt
from typing import Dict, Tuple

import numpy as np
import torch

from ..linalg.gmres import linsolve_info
from ..linalg.lanczos import eigsh_smallest
from ..tensors.ops import lq_pos, qr_pos
from ..utils.sync import to_host
from .su2 import SU2Bond, clebsch_gordan2


# ----------------------------------------------------------------------------
# Dense Clebsch-Gordan data (numpy, probing/embedding only)
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cg(tj1: int, tj2: int, tJ: int) -> np.ndarray:
    """CG tensor C[m1, m2, M] = <j1 m1, j2 m2 | J M> (indices over 2m in
    -2j..2j step 2)."""
    d1, d2, dJ = tj1 + 1, tj2 + 1, tJ + 1
    C = np.zeros((d1, d2, dJ))
    for i1, tm1 in enumerate(range(-tj1, tj1 + 1, 2)):
        for i2, tm2 in enumerate(range(-tj2, tj2 + 1, 2)):
            tM = tm1 + tm2
            if abs(tM) <= tJ and (tJ + tM) % 2 == 0:
                C[i1, i2, (tM + tJ) // 2] = clebsch_gordan2(
                    tj1, tm1, tj2, tm2, tJ, tM)
    return C


def _admissible(tj1: int, tj2: int, tJ: int) -> bool:
    return abs(tj1 - tj2) <= tJ <= tj1 + tj2 and (tj1 + tj2 + tJ) % 2 == 0


@lru_cache(maxsize=None)
def _site_basis(tjl: int, tjp: int, tjr: int) -> np.ndarray:
    """Unit-Frobenius-norm basis tensor T[ml, mp, mr] for a site block."""
    return _cg(tjl, tjp, tjr) / sqrt(tjr + 1)


@lru_cache(maxsize=None)
def _env_basis(tj_bra: int, tk: int, tj_ket: int) -> np.ndarray:
    """Unit-norm basis E[m_bra, q, m_ket] for an environment block carrying
    MPO channel irrep k (k=0 reduces to delta/sqrt(d_bra), matching the
    bond-matrix basis)."""
    C = _cg(tj_ket, tk, tj_bra)            # [m_ket, q, m_bra]
    return np.transpose(C, (2, 1, 0)) / sqrt(tj_bra + 1)


@lru_cache(maxsize=None)
def _op_tensor(tjs: int, tk: int) -> np.ndarray:
    """Unit-norm irreducible tensor operator T[q, s, t] on the physical
    spin (s = out, t = in)."""
    C = _cg(tjs, tk, tjs)                  # [t, q, s]
    T = np.transpose(C, (1, 2, 0))
    return T / np.linalg.norm(T)


@lru_cache(maxsize=None)
def _w_entry_dense(tka: int, tkop: int, tkb: int, tjs: int) -> np.ndarray:
    """Dense channel form W[qa, qb, s, t] of one FSM entry: the operator's
    q index is fused with the incoming channel via CG into the outgoing."""
    if not _admissible(tka, tkop, tkb):
        raise ValueError((tka, tkop, tkb))
    C = _cg(tka, tkop, tkb)                # [qa, qop, qb]
    T = _op_tensor(tjs, tkop)              # [qop, s, t]
    return np.einsum("aob,ost->abst", C, T)


# ----------------------------------------------------------------------------
# Reduced block containers
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _layout(shapes):
    """((start, stop) per block, total size) of blocks laid end to end."""
    offs, pos = [], 0
    for s in shapes:
        n = prod(s)
        offs.append((pos, pos + n))
        pos += n
    return tuple(offs), pos


@lru_cache(maxsize=None)
def _key_index(keys):
    return {k: i for i, k in enumerate(keys)}


class RBlocks:
    """Static-keyed blocks in one flat tensor: `keys` are tuples of spin
    labels, `shapes` the multiplicity-matrix shape of each block, `flat`
    the blocks' entries end to end. `vals` are views into `flat`, so a
    Krylov solver can run on `flat` alone (its inner product is the sum of
    the blocks' Frobenius products)."""

    __slots__ = ("keys", "shapes", "flat", "_vals")

    def __init__(self, keys, shapes, flat):
        self.keys = tuple(keys)
        self.shapes = tuple(tuple(int(n) for n in s) for s in shapes)
        self.flat = flat
        self._vals = None

    @staticmethod
    def from_blocks(keys, blocks, dtype=None, device=None) -> "RBlocks":
        blocks = list(blocks)
        if blocks:
            flat = torch.cat([b.reshape(-1) for b in blocks])
        else:
            flat = torch.zeros(0, dtype=dtype, device=device)
        return RBlocks(keys, [b.shape for b in blocks], flat)

    @staticmethod
    def zeros(keys, shapes, dtype, device) -> "RBlocks":
        shapes = tuple(tuple(s) for s in shapes)
        return RBlocks(keys, shapes, torch.zeros(
            _layout(shapes)[1], dtype=dtype, device=device))

    def like(self, flat) -> "RBlocks":
        """The same structure over other entries."""
        return RBlocks(self.keys, self.shapes, flat)

    @property
    def vals(self):
        if self._vals is None:
            offs, _ = _layout(self.shapes)
            self._vals = tuple(self.flat[a:b].view(s)
                               for (a, b), s in zip(offs, self.shapes))
        return self._vals

    def __getitem__(self, key):
        return self.vals[_key_index(self.keys)[key]]

    def __contains__(self, key):
        return key in _key_index(self.keys)

    def get(self, key, default=None):
        i = _key_index(self.keys).get(key)
        return default if i is None else self.vals[i]

    def items(self):
        return zip(self.keys, self.vals)

    def to(self, *args, **kw) -> "RBlocks":
        return self.like(self.flat.to(*args, **kw))

    @property
    def dtype(self):
        return self.flat.dtype

    @property
    def device(self):
        return self.flat.device


def _bond_sectors(bond: SU2Bond) -> Tuple[Tuple[int, int], ...]:
    """((2j, mult), ...) with unique, sorted 2j."""
    acc: Dict[int, int] = {}
    for tj, m in bond.multiplets:
        acc[tj] = acc.get(tj, 0) + m
    return tuple(sorted(acc.items()))


def site_keys(bond_l: SU2Bond, tjp: int, bond_r: SU2Bond):
    return tuple((tjl, tjr)
                 for tjl, _ in _bond_sectors(bond_l)
                 for tjr, _ in _bond_sectors(bond_r)
                 if _admissible(tjl, tjp, tjr))


def env_keys(bond: SU2Bond, tk: int):
    """(2j_bra, 2j_ket) pairs admissible for a channel-k environment."""
    secs = _bond_sectors(bond)
    return tuple((tjb, tjk) for tjb, _ in secs for tjk, _ in secs
                 if _admissible(tjk, tk, tjb))


def _randn(shape, dtype, device, generator):
    if dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _generator(generator, device, seed=0):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return generator


def random_site(bond: SU2Bond, tjp: int, dtype=torch.float64, device="cuda",
                generator: torch.Generator = None) -> RBlocks:
    """Gaussian reduced site tensor on a uniform bond, drawn from
    `generator` (seeded 0 when None) on `device`."""
    secs = dict(_bond_sectors(bond))
    keys = site_keys(bond, tjp, bond)
    shapes = [(secs[tjl], secs[tjr]) for tjl, tjr in keys]
    g = _generator(generator, device)
    flat = _randn((_layout(tuple(shapes))[1],), dtype, device, g)
    return RBlocks(keys, shapes, flat)


def identity_c(bond: SU2Bond, dtype=torch.float64,
               device="cuda") -> RBlocks:
    """Reduced coefficients of the dense identity on the bond."""
    secs = _bond_sectors(bond)
    return RBlocks.from_blocks(
        tuple((tj, tj) for tj, _ in secs),
        [sqrt(tj + 1) * torch.eye(m, dtype=dtype, device=device)
         for tj, m in secs])


def rho_from_c(C: RBlocks, side: str) -> RBlocks:
    """Reduced density matrix from the reduced bond matrix: right cap
    rho_R = C C^dag, left cap rho_L = C^dag C (dense), as k=0 env blocks."""
    vals = []
    for (tj, _), M in C.items():
        P = M @ M.mH if side == "right" else M.mH @ M
        vals.append(P / sqrt(tj + 1))
    return RBlocks.from_blocks(C.keys, vals)


def tree_dot(a: RBlocks, b: RBlocks):
    """<a, b> over all blocks (conjugate-linear in a), a 0-dim tensor."""
    return torch.vdot(a.flat, b.flat)


def tree_norm(x: RBlocks):
    return torch.linalg.vector_norm(x.flat)


def tree_normalize(x: RBlocks) -> RBlocks:
    return x.like(x.flat / torch.clamp(tree_norm(x), min=1e-30))


# ----------------------------------------------------------------------------
# Dense embedding / restriction (tests + probing; host numpy)
# ----------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().resolve_conj().numpy()


def _sector_offsets(bond: SU2Bond):
    """{2j: (offset, mult)} assuming sector-major dense layout."""
    out = {}
    pos = 0
    for tj, m in _bond_sectors(bond):
        out[tj] = (pos, m)
        pos += m * (tj + 1)
    return out


def embed_site(B: RBlocks, bond_l: SU2Bond, tjp: int,
               bond_r: SU2Bond) -> np.ndarray:
    offL, offR = _sector_offsets(bond_l), _sector_offsets(bond_r)
    Dl, Dr, d = bond_l.dim, bond_r.dim, tjp + 1
    A = np.zeros((Dl, d, Dr), _np(B.flat).dtype)
    for (tjl, tjr), blk in B.items():
        (l0, nl), (r0, nr) = offL[tjl], offR[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _site_basis(tjl, tjp, tjr)
        blkT = np.einsum("ab,lpr->alpbr", _np(blk), T)
        A[l0:l0 + nl * dl, :, r0:r0 + nr * dr] = blkT.reshape(
            nl * dl, d, nr * dr)
    return A


def restrict_site(A: np.ndarray, bond_l: SU2Bond, tjp: int,
                  bond_r: SU2Bond, device="cuda") -> RBlocks:
    offL, offR = _sector_offsets(bond_l), _sector_offsets(bond_r)
    keys = site_keys(bond_l, tjp, bond_r)
    vals = []
    for (tjl, tjr) in keys:
        (l0, nl), (r0, nr) = offL[tjl], offR[tjr]
        dl, dr = tjl + 1, tjr + 1
        T = _site_basis(tjl, tjp, tjr)
        view = np.asarray(A)[l0:l0 + nl * dl, :, r0:r0 + nr * dr].reshape(
            nl, dl, tjp + 1, nr, dr)
        vals.append(torch.as_tensor(np.einsum("alpbr,lpr->ab", view, T),
                                    device=device))
    return RBlocks.from_blocks(keys, vals)


def embed_env(G: RBlocks, bond: SU2Bond, tk: int) -> np.ndarray:
    """Dense (D, dk, D) channel environment [bra, q, ket]."""
    off = _sector_offsets(bond)
    D = bond.dim
    E = np.zeros((D, tk + 1, D), _np(G.flat).dtype)
    for (tjb, tjk), blk in G.items():
        (b0, nb), (k0, nk) = off[tjb], off[tjk]
        db, dk = tjb + 1, tjk + 1
        T = _env_basis(tjb, tk, tjk)
        blkT = np.einsum("ab,xqy->axqby", _np(blk), T)
        E[b0:b0 + nb * db, :, k0:k0 + nk * dk] = blkT.reshape(
            nb * db, tk + 1, nk * dk)
    return E


def embed_c(C: RBlocks, bond: SU2Bond) -> np.ndarray:
    return embed_env(C, bond, 0)[:, 0, :]


def restrict_env(E: np.ndarray, bond: SU2Bond, tk: int,
                 device="cuda") -> RBlocks:
    off = _sector_offsets(bond)
    keys = env_keys(bond, tk)
    vals = []
    for (tjb, tjk) in keys:
        (b0, nb), (k0, nk) = off[tjb], off[tjk]
        db, dk = tjb + 1, tjk + 1
        T = _env_basis(tjb, tk, tjk)
        view = np.asarray(E)[b0:b0 + nb * db, :, k0:k0 + nk * dk].reshape(
            nb, db, tk + 1, nk, dk)
        vals.append(torch.as_tensor(np.einsum("axqby,xqy->ab", view, T),
                                    device=device))
    return RBlocks.from_blocks(keys, vals)


# ----------------------------------------------------------------------------
# Reduced MPO
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReducedMPO:
    """SU(2)-reduced FSM MPO: `channels[a]` is the irrep 2k carried by FSM
    level a; `entries` are (a, b, 2k_op, weight) with the operator the
    unit-norm spin-2k_op irreducible tensor on the physical spin. Upper
    triangular; levels 0 and w-1 are identity channels (2k=0) with implicit
    diagonal identity entries, matching the MPOHamiltonian FSM convention."""

    tjp: int
    channels: Tuple[int, ...]
    entries: Tuple[Tuple[int, int, int, float], ...]

    @property
    def odim(self):
        return len(self.channels)

    def entries_into(self, b):
        return tuple(e for e in self.entries if e[1] == b and e[0] != b)

    def entries_from(self, a):
        return tuple(e for e in self.entries if e[0] == a and e[1] != a)

    def dense_fsm(self) -> np.ndarray:
        """Dense FSM W[A, B, s, t] with channel levels expanded to their
        (2k+1) spherical components (for cross-checks against the dense
        MPOHamiltonian path)."""
        d = self.tjp + 1
        dims = [tk + 1 for tk in self.channels]
        offs = np.concatenate([[0], np.cumsum(dims)]).astype(int)
        wD = int(offs[-1])
        W = np.zeros((wD, wD, d, d))
        eye = np.eye(d)
        for lvl in (0, self.odim - 1):
            W[offs[lvl], offs[lvl]] += eye
        for (a, b, tkop, wgt) in self.entries:
            blk = wgt * _w_entry_dense(self.channels[a], tkop,
                                       self.channels[b], self.tjp)
            W[offs[a]:offs[a + 1], offs[b]:offs[b + 1]] += blk
        return W


def _spin_ss(tjs: int):
    """S.S on two spin-(tjs/2) sites, real in the Sz basis."""
    d = tjs + 1
    j = tjs / 2.0
    mz = np.array([j - n for n in range(d)])
    sp = np.zeros((d, d))
    for n in range(1, d):
        m = mz[n]
        sp[n - 1, n] = sqrt(j * (j + 1) - m * (m + 1))
    sx, sy_i = (sp + sp.T) / 2.0, (sp - sp.T) / 2.0  # sy_i = i*Sy (real)
    return (np.kron(sx, sx) - np.kron(sy_i, sy_i)
            + np.kron(np.diag(mz), np.diag(mz)))


def heisenberg_reduced(tjs: int = 2, J: float = 1.0) -> ReducedMPO:
    """Spin-(tjs/2) Heisenberg chain  H = J sum_i S_i . S_{i+1}  as a
    3-level reduced FSM (identity, one k=1 channel, identity). The channel
    weight is calibrated numerically against S.S on two sites."""
    d = tjs + 1
    ss = _spin_ss(tjs)
    Wd = _w_entry_dense(0, 2, 2, tjs)[0]             # [qb, s, t]
    Wd2 = _w_entry_dense(2, 2, 0, tjs)[:, 0]         # [qa, s, t]
    h2 = np.einsum("qsu,qtv->stuv", Wd, Wd2).reshape(d * d, d * d)
    ratio = ss.reshape(-1) @ h2.reshape(-1) / (h2.reshape(-1) @
                                               h2.reshape(-1))
    return ReducedMPO(tjp=tjs, channels=(0, 2, 0),
                      entries=((0, 1, 2, J * ratio), (1, 2, 2, 1.0)))


def bilinear_biquadratic_reduced(tjs: int = 2, theta: float = 0.0
                                 ) -> ReducedMPO:
    """H = sum_i cos(theta) S.S + sin(theta) (S.S)^2 via the isotropic
    channel decomposition  sum_k c_k sum_q T^k_q (T^k_q)^dag  (k=0,1,2)."""
    ss = _spin_ss(tjs)
    target = (np.cos(theta) * ss + np.sin(theta) * (ss @ ss))
    chans, paths = [], []
    for tk in (0, 2, 4):
        if tk > 2 * tjs:
            continue
        Wa = _w_entry_dense(0, tk, tk, tjs)[0]       # [qb, s, t]
        Wb = _w_entry_dense(tk, tk, 0, tjs)[:, 0]    # [qa, s, t]
        paths.append(np.einsum("qsu,qtv->stuv", Wa, Wb).reshape(-1))
        chans.append(tk)
    M = np.stack(paths, axis=1)
    coeffs, *_ = np.linalg.lstsq(M, target.reshape(-1), rcond=None)
    resid = np.linalg.norm(M @ coeffs - target.reshape(-1))
    if resid > 1e-10:
        raise ValueError(f"two-site term not isotropic (residual {resid})")
    channels = (0,) + tuple(chans) + (0,)
    w = len(channels)
    entries = []
    for i, (tk, c) in enumerate(zip(chans, coeffs)):
        entries.append((0, 1 + i, tk, float(c)))
        entries.append((1 + i, w - 1, tk, 1.0))
    return ReducedMPO(tjp=tjs, channels=channels, entries=tuple(entries))


# ----------------------------------------------------------------------------
# Structure-coefficient probing (host numpy, cached per spin structure)
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _probe_transfer_left(tka, tkop, tkb, tjp, tjx, tjy, tjm, tjn) -> float:
    """out[(jm,jn)] += coeff * Abra^dag gl Aket for one FSM entry: probe the
    dense contraction at unit multiplicity."""
    if not (_admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)
            and _admissible(tjy, tka, tjx) and _admissible(tjn, tkb, tjm)):
        return 0.0
    E_in = _env_basis(tjx, tka, tjy)       # [mx, qa, my]
    W = _w_entry_dense(tka, tkop, tkb, tjp)  # [qa, qb, s, t]
    Ab = _site_basis(tjx, tjp, tjm)        # [mx, s, mm]
    Ak = _site_basis(tjy, tjp, tjn)        # [my, t, mn]
    out = np.einsum("xay,abst,xsm,ytn->mbn", E_in, W, Ab, Ak, optimize=True)
    E_out = _env_basis(tjm, tkb, tjn)
    return float(np.einsum("mbn,mbn->", out, E_out))


@lru_cache(maxsize=None)
def _probe_transfer_right(tka, tkop, tkb, tjp, tjm, tjn, tjx, tjy) -> float:
    """out[(jx,jy)] += coeff * Abra gr Aket^T (right-moving transfer):
    gr block at (jm_bra, jn_ket), site blocks (jx->jm) and (jy->jn)."""
    if not (_admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)
            and _admissible(tjn, tkb, tjm) and _admissible(tjy, tka, tjx)):
        return 0.0
    E_in = _env_basis(tjm, tkb, tjn)       # [mm, qb, mn]
    W = _w_entry_dense(tka, tkop, tkb, tjp)
    Ab = _site_basis(tjx, tjp, tjm)        # [mx, s, mm]
    Ak = _site_basis(tjy, tjp, tjn)        # [my, t, mn]
    out = np.einsum("mbn,abst,xsm,ytn->xay", E_in, W, Ab, Ak, optimize=True)
    E_out = _env_basis(tjx, tka, tjy)
    return float(np.einsum("xay,xay->", out, E_out))


@lru_cache(maxsize=None)
def _probe_ac(tka, tkop, tkb, tjp, tjx, tjy, tjn, tjr) -> float:
    """AC' block (jx, jr) += coeff * gl[(jx,jy)] B[(jy,jn)] gr[(jr,jn)]^T."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjn, tkb, tjr)
            and _admissible(tjy, tjp, tjn) and _admissible(tjx, tjp, tjr)):
        return 0.0
    Gl = _env_basis(tjx, tka, tjy)         # [mx, qa, my]
    W = _w_entry_dense(tka, tkop, tkb, tjp)
    X = _site_basis(tjy, tjp, tjn)         # [my, t, mn]
    Gr = _env_basis(tjr, tkb, tjn)         # [mr, qb, mn]
    out = np.einsum("xay,abst,ytn,rbn->xsr", Gl, W, X, Gr, optimize=True)
    T = _site_basis(tjx, tjp, tjr)
    return float(np.einsum("xsr,xsr->", out, T))


@lru_cache(maxsize=None)
def _probe_ac_identity(tjp, tjx, tjy, tjn, tjr) -> float:
    """AC' coefficient for the implicit diagonal identity entries of the
    FSM (levels 0 and w-1): k=0 environments, W = I_d."""
    if not (tjx == tjy and tjr == tjn and _admissible(tjy, tjp, tjn)
            and _admissible(tjx, tjp, tjr)):
        return 0.0
    Gl = _env_basis(tjx, 0, tjy)[:, 0]     # [mx, my]
    X = _site_basis(tjy, tjp, tjn)         # [my, t, mn]
    Gr = _env_basis(tjr, 0, tjn)[:, 0]     # [mr, mn]
    out = np.einsum("xy,ytn,rn->xtr", Gl, X, Gr, optimize=True)
    T = _site_basis(tjx, tjp, tjr)
    return float(np.einsum("xsr,xsr->", out, T))


@lru_cache(maxsize=None)
def _probe_c(tka, tjx, tjy, tjr) -> float:
    """C' block (jx) += coeff * gl[(jx,jy)] C[jy] gr[(jr=jx,jy)]^T at one
    channel level (gl and gr share the level, q contracted through)."""
    if not (_admissible(tjy, tka, tjx) and _admissible(tjy, tka, tjr)
            and tjx == tjr):
        return 0.0
    Gl = _env_basis(tjx, tka, tjy)
    Cb = np.eye(tjy + 1) / sqrt(tjy + 1)
    Gr = _env_basis(tjr, tka, tjy)
    out = np.einsum("xay,yn,ran->xr", Gl, Cb, Gr, optimize=True)
    T = np.eye(tjx + 1) / sqrt(tjx + 1)
    return float(np.einsum("xr,xr->", out, T))


@lru_cache(maxsize=None)
def _probe_plain_left(tjp, tjx, tjm, tjy, tjn) -> float:
    """Plain (identity-channel) transfer coefficient: k=0 env, W = I_d."""
    if not (_admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)
            and tjx == tjy and tjm == tjn):
        return 0.0
    E_in = _env_basis(tjx, 0, tjy)[:, 0]   # [mx, my]
    Ab = _site_basis(tjx, tjp, tjm)
    Ak = _site_basis(tjy, tjp, tjn)
    out = np.einsum("xy,xsm,ysn->mn", E_in, Ab, Ak, optimize=True)
    E_out = _env_basis(tjm, 0, tjn)[:, 0]
    return float(np.einsum("mn,mn->", out, E_out))


@lru_cache(maxsize=None)
def _probe_plain_right(tjp, tjx, tjm, tjy, tjn) -> float:
    if not (_admissible(tjx, tjp, tjm) and _admissible(tjy, tjp, tjn)
            and tjx == tjy and tjm == tjn):
        return 0.0
    E_in = _env_basis(tjm, 0, tjn)[:, 0]
    Ab = _site_basis(tjx, tjp, tjm)
    Ak = _site_basis(tjy, tjp, tjn)
    out = np.einsum("mn,xsm,ysn->xy", E_in, Ab, Ak, optimize=True)
    E_out = _env_basis(tjx, 0, tjy)[:, 0]
    return float(np.einsum("xy,xy->", out, E_out))


# ----------------------------------------------------------------------------
# Term plans and their executor
# ----------------------------------------------------------------------------

def _ident(x):
    return x


def _adj(x):
    return x.mH


def _conj(x):
    return x.conj()


def _tr(x):
    return x.mT


def _group(terms):
    """Group raw terms (c, o, la, li, mb, mi, rb, ri) by their left product
    (la, li, mb, mi), in order of first appearance. Returns a tuple of
    ((la, li, mb, mi), ((c, o, rb, ri), ...)) and the term count."""
    groups: Dict[tuple, list] = {}
    for c, o, la, li, mb, mi, rb, ri in terms:
        groups.setdefault((la, li, mb, mi), []).append((c, o, rb, ri))
    return tuple((k, tuple(v)) for k, v in groups.items()), len(terms)


def _run(plan, out: RBlocks, Ls, lf, Ms, Rs, rf) -> RBlocks:
    """out.blocks[o] += c * lf(Ls[la][li]) @ Ms[mb][mi] @ rf(Rs[rb][ri]) for
    every term of `plan`, in place; Ls, Ms, Rs are lists of RBlocks."""
    ov = out.vals
    Lv = [x.vals for x in Ls]
    Mv = [x.vals for x in Ms]
    Rv = [x.vals for x in Rs]
    for (la, li, mb, mi), items in plan:
        t = lf(Lv[la][li]) @ Mv[mb][mi]
        for c, o, rb, ri in items:
            ov[o].addmm_(t, rf(Rv[rb][ri]), alpha=c)
    return out


def _by_first(keys):
    out: Dict[int, list] = {}
    for i, k in enumerate(keys):
        out.setdefault(k[0], []).append(i)
    return out


def _by_second(keys):
    out: Dict[int, list] = {}
    for i, k in enumerate(keys):
        out.setdefault(k[1], []).append(i)
    return out


# ----------------------------------------------------------------------------
# Runtime reduced kernels
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _plan_plain_left(v_keys, b_keys, bbar_keys, b_shapes, tjp):
    bidx, vidx = _key_index(b_keys), _key_index(v_keys)
    bbidx = _key_index(bbar_keys)
    raw, out_keys = [], {}
    for (tjx, tjy) in v_keys:
        for (tjl, tjm) in b_keys:
            if tjl != tjx:
                continue
            c = _probe_plain_left(tjp, tjx, tjm, tjy, tjm)
            if abs(c) < 1e-14 or (tjy, tjm) not in bidx:
                continue
            key = (tjm, tjm)
            if key not in out_keys:
                out_keys[key] = (b_shapes[bbidx[(tjx, tjm)]][1],
                                 b_shapes[bidx[(tjy, tjm)]][1])
            raw.append((c, key, bbidx[(tjx, tjm)], vidx[(tjx, tjy)],
                        bidx[(tjy, tjm)]))
    keys = tuple(sorted(out_keys))
    oidx = _key_index(keys)
    plan = _group([(c, oidx[k], 0, i, 0, j, 0, r) for c, k, i, j, r in raw])
    return keys, tuple(out_keys[k] for k in keys), plan


def rtransfer_left_plain(v: RBlocks, B: RBlocks, Bbar: RBlocks,
                         tjp: int) -> RBlocks:
    """Identity-channel left transfer: v' = sum Abra^dag v Aket."""
    keys, shapes, (plan, _) = _plan_plain_left(v.keys, B.keys, Bbar.keys,
                                               B.shapes, tjp)
    out = RBlocks.zeros(keys, shapes, v.dtype, v.device)
    return _run(plan, out, [Bbar], _adj, [v], [B], _ident)


@lru_cache(maxsize=None)
def _plan_plain_right(v_keys, b_keys, bbar_keys, b_shapes, tjp):
    bidx, vidx = _key_index(b_keys), _key_index(v_keys)
    bbidx = _key_index(bbar_keys)
    raw, out_keys = [], {}
    for (tjm, tjn) in v_keys:
        for (tjx, tjm2) in b_keys:
            if tjm2 != tjm:
                continue
            c = _probe_plain_right(tjp, tjx, tjm, tjx, tjn)
            if abs(c) < 1e-14 or (tjx, tjn) not in bidx:
                continue
            key = (tjx, tjx)
            if key not in out_keys:
                out_keys[key] = (b_shapes[bbidx[(tjx, tjm)]][0],
                                 b_shapes[bidx[(tjx, tjn)]][0])
            raw.append((c, key, bbidx[(tjx, tjm)], vidx[(tjm, tjn)],
                        bidx[(tjx, tjn)]))
    keys = tuple(sorted(out_keys))
    oidx = _key_index(keys)
    plan = _group([(c, oidx[k], 0, i, 0, j, 0, r) for c, k, i, j, r in raw])
    return keys, tuple(out_keys[k] for k in keys), plan


def rtransfer_right_plain(v: RBlocks, B: RBlocks, Bbar: RBlocks,
                          tjp: int) -> RBlocks:
    keys, shapes, (plan, _) = _plan_plain_right(v.keys, B.keys, Bbar.keys,
                                                B.shapes, tjp)
    out = RBlocks.zeros(keys, shapes, v.dtype, v.device)
    return _run(plan, out, [Bbar], _conj, [v], [B], _tr)


def _env_zero(bond_secs, tk, like) -> RBlocks:
    """Zero channel-tk environment on the bond sectors, in the dtype and on
    the device of `like` (an RBlocks or a tensor)."""
    secs = dict(bond_secs)
    keys = tuple(sorted((tb, tn) for tb in secs for tn in secs
                        if _admissible(tn, tk, tb)))
    return RBlocks.zeros(keys, [(secs[tb], secs[tn]) for tb, tn in keys],
                         like.dtype, like.device)


@lru_cache(maxsize=None)
def _plan_transfer_left(gl_keys, entry, mpo, b_keys, out_keys):
    a, b, tkop, wgt = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx, bfirst = _key_index(out_keys), _by_first(b_keys)
    raw = []
    for gi, (tjx, tjy) in enumerate(gl_keys):
        for bi in bfirst.get(tjx, ()):
            tjm = b_keys[bi][1]
            for bj in bfirst.get(tjy, ()):
                tjn = b_keys[bj][1]
                if (tjm, tjn) not in oidx:
                    continue
                c = _probe_transfer_left(tka, tkop, tkb, mpo.tjp,
                                         tjx, tjy, tjm, tjn)
                if abs(c) < 1e-14:
                    continue
                raw.append((wgt * c, oidx[(tjm, tjn)], 0, bi, 0, gi, 0, bj))
    return _group(raw)


def _acc_transfer_left(gl, entry, mpo, B, out):
    plan, _ = _plan_transfer_left(gl.keys, entry, mpo, B.keys, out.keys)
    return _run(plan, out, [B], _adj, [gl], [B], _ident)


def rtransfer_left_entry(gl: RBlocks, entry, mpo: ReducedMPO, B: RBlocks,
                         out: RBlocks) -> RBlocks:
    """out + one FSM entry's left transfer (channel of the target level)."""
    return _acc_transfer_left(gl, entry, mpo, B, out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_transfer_right(gr_keys, entry, mpo, b_keys, out_keys):
    a, b, tkop, wgt = entry
    tka, tkb = mpo.channels[a], mpo.channels[b]
    oidx, bsecond = _key_index(out_keys), _by_second(b_keys)
    raw = []
    for gi, (tjm, tjn) in enumerate(gr_keys):
        for bi in bsecond.get(tjm, ()):
            tjx = b_keys[bi][0]
            for bj in bsecond.get(tjn, ()):
                tjy = b_keys[bj][0]
                if (tjx, tjy) not in oidx:
                    continue
                c = _probe_transfer_right(tka, tkop, tkb, mpo.tjp,
                                          tjm, tjn, tjx, tjy)
                if abs(c) < 1e-14:
                    continue
                raw.append((wgt * c, oidx[(tjx, tjy)], 0, bi, 0, gi, 0, bj))
    return _group(raw)


def _acc_transfer_right(gr, entry, mpo, B, out):
    plan, _ = _plan_transfer_right(gr.keys, entry, mpo, B.keys, out.keys)
    return _run(plan, out, [B], _conj, [gr], [B], _tr)


def rtransfer_right_entry(gr: RBlocks, entry, mpo: ReducedMPO, B: RBlocks,
                          out: RBlocks) -> RBlocks:
    return _acc_transfer_right(gr, entry, mpo, B, out.like(out.flat.clone()))


@lru_cache(maxsize=None)
def _plan_ac(gl_keys, gr_keys, mpo, b_keys):
    w = mpo.odim
    entries = mpo.entries + ((0, 0, 0, None), (w - 1, w - 1, 0, None))
    oidx, bfirst = _key_index(b_keys), _by_first(b_keys)
    raw = []
    for (a, b, tkop, wgt) in entries:
        tka, tkb = mpo.channels[a], mpo.channels[b]
        grsecond = _by_second(gr_keys[b])
        for gi, (tjx, tjy) in enumerate(gl_keys[a]):
            for bi in bfirst.get(tjy, ()):
                tjn = b_keys[bi][1]
                for ri in grsecond.get(tjn, ()):
                    tjr = gr_keys[b][ri][0]
                    if (tjx, tjr) not in oidx:
                        continue
                    if wgt is None:
                        c = _probe_ac_identity(mpo.tjp, tjx, tjy, tjn, tjr)
                    else:
                        c = wgt * _probe_ac(tka, tkop, tkb, mpo.tjp,
                                            tjx, tjy, tjn, tjr)
                    if abs(c) < 1e-14:
                        continue
                    raw.append((c, oidx[(tjx, tjr)], a, gi, 0, bi, b, ri))
    return _group(raw)


def rac_apply(gls, grs, mpo: ReducedMPO, B: RBlocks) -> RBlocks:
    """Reduced effective AC Hamiltonian: sum over FSM entries (a,b) of
    gl[a] W[ab] B gr[b], the identity levels included through their k=0
    entries (0,0) and (w-1,w-1)."""
    plan, _ = _plan_ac(tuple(g.keys for g in gls), tuple(g.keys for g in grs),
                       mpo, B.keys)
    return _run(plan, B.like(torch.zeros_like(B.flat)), gls, _ident, [B],
                grs, _tr)


def rac_terms(gls, grs, mpo: ReducedMPO, B: RBlocks):
    """(GEMM terms, GEMMs) of one `rac_apply` on this block structure: each
    term is one `addmm_`, each group of terms sharing a left factor one
    more product."""
    plan, n = _plan_ac(tuple(g.keys for g in gls), tuple(g.keys for g in grs),
                       mpo, B.keys)
    return n, n + len(plan)


@lru_cache(maxsize=None)
def _plan_c(gl_keys, gr_keys, mpo, c_keys):
    oidx = _key_index(c_keys)
    raw = []
    for a in range(mpo.odim):
        tka = mpo.channels[a]
        gridx = _key_index(gr_keys[a])
        for gi, (tjx, tjy) in enumerate(gl_keys[a]):
            if (tjy, tjy) not in oidx:
                continue
            ri = gridx.get((tjx, tjy))
            if ri is None or (tjx, tjx) not in oidx:
                continue
            c = _probe_c(tka, tjx, tjy, tjx)
            if abs(c) < 1e-14:
                continue
            raw.append((c, oidx[(tjx, tjx)], a, gi, 0, oidx[(tjy, tjy)],
                        a, ri))
    return _group(raw)


def rc_apply(gls, grs, mpo: ReducedMPO, C: RBlocks) -> RBlocks:
    """Reduced zero-site Hamiltonian: sum over levels a of gl[a] C gr[a]
    with the channel index contracted through."""
    plan, _ = _plan_c(tuple(g.keys for g in gls), tuple(g.keys for g in grs),
                      mpo, C.keys)
    return _run(plan, C.like(torch.zeros_like(C.flat)), gls, _ident, [C],
                grs, _tr)


# ----------------------------------------------------------------------------
# Reduced uniform gauging (single-site unit cell)
# ----------------------------------------------------------------------------

def _stack_left(B: RBlocks, tjr: int):
    """vstack of all blocks flowing into right sector tjr; returns
    (matrix, [(key, nl)])."""
    rows, meta = [], []
    for (tjl, tjr2), blk in B.items():
        if tjr2 == tjr:
            rows.append(blk)
            meta.append(((tjl, tjr2), blk.shape[0]))
    return torch.cat(rows, dim=0), meta


def _unstack_left(M, meta):
    out = {}
    pos = 0
    for key, nl in meta:
        out[key] = M[pos:pos + nl]
        pos += nl
    return out


def _stack_right(B: RBlocks, tjl: int):
    cols, meta = [], []
    for (tjl2, tjr), blk in B.items():
        if tjl2 == tjl:
            cols.append(blk)
            meta.append(((tjl2, tjr), blk.shape[1]))
    return torch.cat(cols, dim=1), meta


def _unstack_right(M, meta):
    out = {}
    pos = 0
    for key, nr in meta:
        out[key] = M[:, pos:pos + nr]
        pos += nr
    return out


def left_qr_reduced(B: RBlocks):
    """(AL, C): per right sector tjr, QR of the stacked blocks scaled so AL
    is exactly left-isometric in the dense sense (sum_jl AL^dag AL =
    (2jr+1) I in orthonormal-coefficient storage)."""
    tjrs = sorted({k[1] for k in B.keys})
    al = {}
    ckeys, cvals = [], []
    for tjr in tjrs:
        S, meta = _stack_left(B, tjr)
        sq = sqrt(tjr + 1)
        Q, R = qr_pos(S / sq)
        al.update({k: sq * v for k, v in _unstack_left(Q, meta).items()})
        ckeys.append((tjr, tjr))
        cvals.append(sq * R)
    AL = RBlocks.from_blocks(B.keys, [al[k] for k in B.keys])
    return AL, RBlocks.from_blocks(ckeys, cvals)


def right_lq_reduced(B: RBlocks):
    """(C, AR): per left sector tjl, LQ of the hstacked blocks; AR is
    exactly right-isometric in the dense sense."""
    tjls = sorted({k[0] for k in B.keys})
    ar = {}
    ckeys, cvals = [], []
    for tjl in tjls:
        S, meta = _stack_right(B, tjl)
        sq = sqrt(tjl + 1)
        L, Q = lq_pos(S / sq)
        ar.update({k: sq * v for k, v in _unstack_right(Q, meta).items()})
        ckeys.append((tjl, tjl))
        cvals.append(sq * L)
    AR = RBlocks.from_blocks(B.keys, [ar[k] for k in B.keys])
    return RBlocks.from_blocks(ckeys, cvals), AR


def rmul_c_right(B: RBlocks, C: RBlocks) -> RBlocks:
    """Reduced blocks of A . C_dense (bond matrix on the right leg)."""
    return RBlocks.from_blocks(B.keys, [
        blk @ (C[(tjr, tjr)] / sqrt(tjr + 1)) for (tjl, tjr), blk in B.items()])


def rmul_c_left(C: RBlocks, B: RBlocks) -> RBlocks:
    return RBlocks.from_blocks(B.keys, [
        (C[(tjl, tjl)] / sqrt(tjl + 1)) @ blk for (tjl, tjr), blk in B.items()])


def uniform_gauge_reduced(A: RBlocks, tjp: int, tol=1e-13, maxiter=200):
    """(AL, AR, AC, C) from a raw reduced site tensor: alternating
    C A -> AL C' QR iteration (and the mirror), single-site unit cell.
    Each iteration reads its change on the host."""
    keys_c = tuple(sorted({(k[1], k[1]) for k in A.keys}))
    sector_dim = {k[1]: s[1] for k, s in zip(A.keys, A.shapes)}
    C = tree_normalize(RBlocks.from_blocks(keys_c, [
        torch.eye(sector_dim[tj], dtype=A.dtype, device=A.device)
        for (tj, _) in keys_c]))
    AL = A
    for _ in range(maxiter):
        AL, C_new = left_qr_reduced(rmul_c_left(C, A))
        C_new = tree_normalize(C_new)
        err = to_host(torch.linalg.vector_norm(C_new.flat - C.flat))[0]
        C = C_new
        if err < tol:
            break
    # right gauge from AL: AC = AL C_R with C_R the right fixed point
    CR = C
    for _ in range(maxiter):
        CR_new, AR = right_lq_reduced(rmul_c_right(AL, CR))
        CR_new = tree_normalize(CR_new)
        err = to_host(torch.linalg.vector_norm(CR_new.flat - CR.flat))[0]
        CR = CR_new
        if err < tol:
            break
    AC = rmul_c_right(AL, CR)
    return AL, AR, AC, CR


def regauge_acc_reduced(AC: RBlocks, C: RBlocks) -> RBlocks:
    """AL = argmin |AC - AL C|: per right sector, Q_AC Q_C^dag."""
    tjrs = sorted({k[1] for k in AC.keys})
    al = {}
    for tjr in tjrs:
        S, meta = _stack_left(AC, tjr)
        QA, _ = qr_pos(S)
        QC, _ = qr_pos(C[(tjr, tjr)])
        Q = QA @ QC.mH
        al.update({k: sqrt(tjr + 1) * v
                   for k, v in _unstack_left(Q, meta).items()})
    return RBlocks.from_blocks(AC.keys, [al[k] for k in AC.keys])


def regauge_cac_reduced(C: RBlocks, AC: RBlocks) -> RBlocks:
    """AR = argmin |AC - C AR| via LQ (mirror)."""
    tjls = sorted({k[0] for k in AC.keys})
    ar = {}
    for tjl in tjls:
        S, meta = _stack_right(AC, tjl)
        _, QA = lq_pos(S)
        _, QC = lq_pos(C[(tjl, tjl)])
        Q = QC.mH @ QA
        ar.update({k: sqrt(tjl + 1) * v
                   for k, v in _unstack_right(Q, meta).items()})
    return RBlocks.from_blocks(AC.keys, [ar[k] for k in AC.keys])


# ----------------------------------------------------------------------------
# Reduced infinite Hamiltonian environments (single-site unit cell)
# ----------------------------------------------------------------------------

def _bond_sectors_from_blocks(B: RBlocks):
    secs = {}
    for (tjl, tjr), s in zip(B.keys, B.shapes):
        secs[tjl] = s[0]
        secs[tjr] = s[1]
    return tuple(sorted(secs.items()))


def identity_c_from_blocks(B: RBlocks) -> RBlocks:
    secs = _bond_sectors_from_blocks(B)
    return RBlocks.from_blocks(
        tuple((tj, tj) for tj, _ in secs),
        [sqrt(tj + 1) * torch.eye(n, dtype=B.dtype, device=B.device)
         for tj, n in secs])


def _sub_pair(x: RBlocks, cap: RBlocks, eye: RBlocks) -> RBlocks:
    """x - <cap, x> * eye (rank-1 regularization on the identity channel;
    all three share the k=0 diagonal key structure)."""
    assert x.keys == cap.keys == eye.keys, (x.keys, cap.keys, eye.keys)
    return x.like(x.flat - tree_dot(cap, x) * eye.flat)


def reduced_ham_envs(AL: RBlocks, AR: RBlocks, C: RBlocks,
                     mpo: ReducedMPO, tjp: int, tol=1e-12,
                     gl_init=None, gr_init=None):
    """(gls, grs, e_density, resid): FSM-level-walked reduced environments,
    the geometric series on the identity levels solved by the shared
    restarted GMRES on the flat blocks. e_density is a 0-dim tensor, resid
    a host float."""
    w = mpo.odim
    secs = _bond_sectors_from_blocks(AL)
    cap_r = rho_from_c(C, "right")
    cap_l = rho_from_c(C, "left")
    eye_r = identity_c_from_blocks(AL)

    gls = [None] * w
    grs = [None] * w
    gls[0] = eye_r
    grs[w - 1] = eye_r
    resid = 0.0
    e_density = None

    # left walk: levels 1..w-1
    for b in range(1, w):
        out = _env_zero(secs, mpo.channels[b], AL)
        for entry in mpo.entries_into(b):
            _acc_transfer_left(gls[entry[0]], entry, mpo, AL, out)
        if b == w - 1:
            # identity diagonal: geometric series, regularized
            e_density = tree_dot(cap_r, out).real
            F_reg = _sub_pair(out, cap_r, eye_r)

            def mv_reg(x, _t=out):
                Tx = rtransfer_left_plain(_t.like(x), AL, AL, tjp)
                return _sub_pair(Tx, cap_r, eye_r).flat

            guess = None if gl_init is None else _sub_pair(
                gl_init[b], cap_r, eye_r).flat
            x0, r = linsolve_info(mv_reg, F_reg.flat, x0=guess, a0=1.0,
                                  a1=-1.0, tol=tol, restart=12, maxiter=100,
                                  stall_exit=True)
            resid = max(resid, r)
            gls[b] = out.like(x0)
        else:
            gls[b] = out  # zero diagonal (strictly upper FSM interior)

    # right walk: levels w-2..0
    for a in range(w - 2, -1, -1):
        out = _env_zero(secs, mpo.channels[a], AR)
        for entry in mpo.entries_from(a):
            _acc_transfer_right(grs[entry[1]], entry, mpo, AR, out)
        if a == 0:
            F_reg = _sub_pair(out, cap_l, eye_r)

            def mv_reg(x, _t=out):
                Tx = rtransfer_right_plain(_t.like(x), AR, AR, tjp)
                return _sub_pair(Tx, cap_l, eye_r).flat

            guess = None if gr_init is None else _sub_pair(
                gr_init[a], cap_l, eye_r).flat
            x0, r = linsolve_info(mv_reg, F_reg.flat, x0=guess, a0=1.0,
                                  a1=-1.0, tol=tol, restart=12, maxiter=100,
                                  stall_exit=True)
            resid = max(resid, r)
            grs[a] = out.like(x0)
        else:
            grs[a] = out
    return gls, grs, e_density, resid


# ----------------------------------------------------------------------------
# Reduced VUMPS
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2ReducedState:
    """Uniform reduced MPS (single-site unit cell)."""
    AL: RBlocks
    AR: RBlocks
    AC: RBlocks
    C: RBlocks
    tjp: int

    @staticmethod
    def random(bond: SU2Bond, tjp: int, dtype=torch.float64, device="cuda",
               generator: torch.Generator = None) -> "SU2ReducedState":
        A = random_site(bond, tjp, dtype, device, generator)
        AL, AR, AC, C = uniform_gauge_reduced(A, tjp)
        return SU2ReducedState(AL, AR, tree_normalize(AC),
                               tree_normalize(C), tjp)


def _eig_blocks(op, x: RBlocks, m, restarts, tol):
    """Smallest eigenpair of the reduced operator op (RBlocks -> RBlocks)
    from x: restarted local-reorthogonalized Lanczos on the flat blocks."""
    res = eigsh_smallest(lambda v: op(x.like(v)).flat, x.flat, m, restarts,
                         tol, reorth="local")
    return res, x.like(res.eigenvector)


def reduced_vumps_iteration(AL, AR, AC, C, mpo: ReducedMPO, tjp: int,
                            inner_tol: float, m: int, restarts: int,
                            gl_guess=None, gr_guess=None):
    """One reduced VUMPS iteration: (AL, AR, AC, C, eps, e, resid, gls,
    grs), eps and e 0-dim tensors, resid a host float."""
    gls, grs, e, resid = reduced_ham_envs(
        AL, AR, C, mpo, tjp, tol=1e-12, gl_init=gl_guess, gr_init=gr_guess)
    _, ACn = _eig_blocks(lambda x: rac_apply(gls, grs, mpo, x), AC, m,
                         restarts, inner_tol)
    _, Cn = _eig_blocks(lambda x: rc_apply(gls, grs, mpo, x), C, m,
                        restarts, inner_tol)
    ACn, Cn = tree_normalize(ACn), tree_normalize(Cn)
    ALn = regauge_acc_reduced(ACn, Cn)
    ARn = regauge_cac_reduced(Cn, ACn)
    eps = torch.linalg.vector_norm(ACn.flat - rmul_c_right(ALn, Cn).flat)
    return ALn, ARn, ACn, Cn, eps, e, resid, gls, grs


def find_groundstate_su2_reduced(state: SU2ReducedState, mpo: ReducedMPO,
                                 tol=1e-8, maxiter=200, krylovdim=10,
                                 eig_maxrestarts=4, verbosity=0):
    """VUMPS in reduced coordinates. Returns (state, e_density, eps), both
    host floats. One host read per iteration brings back (eps, e)."""
    from ..config import matmul_precision
    from ..utils.dynamictols import updatetol
    from ..utils.logging import IterLog, logger

    tjp = state.tjp
    log = IterLog("VUMPS(SU2-reduced)", verbosity)
    AL, AR, AC, C = state.AL, state.AR, state.AC, state.C
    eps, e = 1.0, 0.0
    gls = grs = None
    it = 0
    with matmul_precision():
        for it in range(1, maxiter + 1):
            AL, AR, AC, C, eps_d, e_d, resid, gls, grs = \
                reduced_vumps_iteration(AL, AR, AC, C, mpo, tjp,
                                        updatetol(eps, it), krylovdim,
                                        eig_maxrestarts, gls, grs)
            eps, e = to_host(eps_d, e_d)
            if verbosity >= 2:
                log.conv(it, e, eps)
            if resid > 1e-6 and verbosity >= 1:
                logger.warning(f"SU2-reduced VUMPS it {it}: env GMRES "
                               f"residual {resid:.3e}")
            if eps < tol:
                break
        else:
            log.cancel(it, e, eps)
    return SU2ReducedState(AL, AR, AC, C, state.tjp), e, eps


def schmidt_spectrum_reduced(state: SU2ReducedState):
    """{2j: multiplet singular values} from the reduced bond matrix; each
    entry is a (2j+1)-fold degenerate dense Schmidt multiplet."""
    out = {}
    for (tj, _), M in state.C.items():
        s = np.linalg.svd(_np(M), compute_uv=False) / sqrt(tj + 1)
        out[tj] = np.sort(s)[::-1]
    return out
