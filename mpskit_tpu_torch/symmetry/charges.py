"""Abelian (U(1) / Z_n) symmetric states (counterpart of
mpskit_tpu/symmetry/charges.py).

Every virtual bond keeps the padded dense dimension D and carries a
static charge label vector c (length D, one abelian charge per bond
index). Charge conservation is the static mask

    mask[l, p, r] = (c_left[l] + q_phys[p] == c_right[r])

applied to every site tensor; the contractions stay dense. The labels and
masks are host numpy (int64 labels, boolean masks), built once and moved
to the state's device as boolean tensors by the solvers that use them.

The solvers are the port's own paths with the masks passed in: the masked
one-site sweep (`algorithms/dmrg.py::_dmrg_sweep_impl`, whose first
Krylov restart is kernel K1 for a float32 state on the card), the masked
VUMPS iteration, and a sector-resolved two-site DMRG whose per-sector SVD
splits run on the state's device over static per-bond index sets.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import VERBOSE_ITER, matmul_precision
from ..environments.finite import (
    FiniteEnv, compute_left_envs, compute_right_envs, left_boundary,
    right_boundary, stack_W,
)
from ..linalg.lanczos import eigsh_smallest
from ..states.finitemps import FiniteMPS, physical_bond_dims
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import leftorth
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from ..utils.sync import to_host, to_host_array

DEAD_LABEL = 10 ** 5  # labels >= this mark padded (dead) bond slots


def masked_split_dtype(dtype):
    """The dtype of the QR / LQ of a charge-masked sweep: float64
    (complex128) for a single-precision state, None (the state's own)
    otherwise. A float32 Householder QR of a masked tensor's
    rank-deficient, interleaved charge blocks puts up to 2e-2 of it off
    the mask, which the sweep's masking then drops (see
    `algorithms.dmrg._dmrg_sweep_impl`)."""
    if dtype == torch.float32:
        return torch.float64
    if dtype == torch.complex64:
        return torch.complex128
    return None


def _reduce(q, modulus):
    """Reduce a charge mod n (Z_n) or leave it (U(1), modulus None)."""
    return q if modulus is None else q % modulus


def _randn(shape, dtype, device, generator):
    if dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def assign_bond_charges(L: int, phys_charges: Sequence[int], D: int,
                        total: int = 0,
                        aux_charges: Sequence[int] = None,
                        modulus: int = None) -> List[np.ndarray]:
    """Static charge label vectors for the L+1 bonds of a finite chain with
    total charge `total`: bond i gets labels drawn from the attainable
    partial-sum charges, with multiplicities proportional to the number of
    paths, capped to D per bond and the physical rank. Bond 0 carries
    charge 0, bond L carries `total`; padded slots carry the bond-dependent
    dead label 10^6 (i + 1).

    aux_charges: optional per-site auxiliary charge fused onto the physical
    leg (site i's rule becomes c_left + q_phys + aux[i] == c_right).
    modulus: None for U(1); n for Z_n fusion."""
    phys = np.asarray(phys_charges, int)
    d = len(phys)
    dims = physical_bond_dims(L, d, D)
    aux = np.zeros(L, int) if aux_charges is None else np.asarray(
        [aux_charges[i % len(aux_charges)] for i in range(L)], int)
    total = _reduce(total, modulus)

    # forward path counts: ways to reach charge q after i sites
    fwd = [dict() for _ in range(L + 1)]
    fwd[0][0] = 1.0
    for i in range(L):
        for q, n in fwd[i].items():
            for p in phys:
                qn = _reduce(q + p + aux[i], modulus)
                fwd[i + 1][qn] = fwd[i + 1].get(qn, 0.0) + n
    # backward counts: ways from charge q at bond i to `total` at bond L
    bwd = [dict() for _ in range(L + 1)]
    bwd[L][total] = 1.0
    for i in range(L - 1, -1, -1):
        for q, n in bwd[i + 1].items():
            for p in phys:
                qn = _reduce(q - p - aux[i], modulus)
                bwd[i][qn] = bwd[i].get(qn, 0.0) + n

    charges = []
    for i in range(L + 1):
        live = sorted(set(fwd[i]) & set(bwd[i]))
        cap = int(dims[i])
        # per-sector Schmidt-rank bound: min(paths from the left, paths
        # from the right); the cap trims sectors by their path weight
        bound = {q: min(fwd[i][q], bwd[i][q]) for q in live
                 if fwd[i][q] > 0 and bwd[i][q] > 0}
        if not bound:
            charges.append(np.full(D, 10**6 * (i + 1), int))
            continue
        if sum(bound.values()) <= cap:
            alloc = {q: int(b) for q, b in bound.items()}
        else:
            weights = {q: fwd[i][q] * bwd[i][q] for q in bound}
            totw = sum(weights.values())
            alloc = {q: min(int(bound[q]),
                            max(1, int(np.floor(cap * weights[q] / totw))))
                     for q in bound}
            order = sorted(bound, key=lambda q: -weights[q])
            while sum(alloc.values()) > cap:
                q = min((x for x in alloc if alloc[x] > 0),
                        key=lambda x: weights[x])
                alloc[q] -= 1
            guard = 0
            while sum(alloc.values()) < cap and guard < 10 * cap:
                guard += 1
                grew = False
                for q in order:
                    if (alloc.get(q, 0) < bound[q]
                            and sum(alloc.values()) < cap):
                        alloc[q] = alloc.get(q, 0) + 1
                        grew = True
                if not grew:
                    break
        # a bond-dependent pad: a constant one could satisfy pad + q_phys +
        # aux == pad when the shifts cancel
        lab = np.full(D, 10**6 * (i + 1), int)
        pos = 0
        for q in sorted(alloc, key=lambda q: -alloc[q]):
            n = alloc[q]
            lab[pos: pos + n] = q
            pos += n
        charges.append(lab)
    return charges


def charge_masks_finite(bond_charges: List[np.ndarray],
                        phys_charges: Sequence[int],
                        aux_charges: Sequence[int] = None,
                        modulus: int = None) -> np.ndarray:
    """(L, D, d, D) boolean conservation masks. Under Z_n the dead slots
    (labels >= DEAD_LABEL) are gated out explicitly: the mod reduction
    would alias them onto live charges."""
    L = len(bond_charges) - 1
    D = bond_charges[0].shape[0]
    phys = np.asarray(phys_charges, int)
    masks = np.zeros((L, D, len(phys), D), bool)
    for i in range(L):
        a = 0 if aux_charges is None else int(
            aux_charges[i % len(aux_charges)])
        cl = bond_charges[i][:, None, None]
        cp = phys[None, :, None] + a
        cr = bond_charges[i + 1][None, None, :]
        if modulus is None:
            masks[i] = (cl + cp) == cr
        else:
            live = (cl < DEAD_LABEL) & (cr < DEAD_LABEL)
            masks[i] = ((cl + cp - cr) % modulus == 0) & live
    return masks


def flux_masks_finite(bond_charges: List[np.ndarray],
                      phys_charges: Sequence[int], sector: int,
                      modulus: int = None) -> np.ndarray:
    """(L, D, d, D) boolean masks of a site tensor carrying charge flux
    `sector`: c_left + q_phys == c_right + sector (mod n). A B tensor
    supported here raises the chain's total charge by `sector`."""
    L = len(bond_charges) - 1
    D = bond_charges[0].shape[0]
    phys = np.asarray(phys_charges, int)
    masks = np.zeros((L, D, len(phys), D), bool)
    for i in range(L):
        cl = bond_charges[i][:, None, None]
        cp = phys[None, :, None]
        cr = bond_charges[i + 1][None, None, :]
        live = (cl < DEAD_LABEL) & (cr < DEAD_LABEL)
        if modulus is None:
            masks[i] = ((cl + cp) == (cr + sector)) & live
        else:
            masks[i] = ((cl + cp - cr - sector) % modulus == 0) & live
    return masks


@dataclasses.dataclass(frozen=True)
class SymmetricFiniteMPS:
    """A FiniteMPS constrained to an abelian charge sector: the dense state
    plus static bond charge labels (L+1 int arrays of length D) and
    physical charges."""

    state: FiniteMPS
    bond_charges: Tuple[np.ndarray, ...]
    phys_charges: Tuple[int, ...]
    modulus: int = None  # None = U(1); n = Z_n fusion

    @property
    def masks(self) -> np.ndarray:
        return charge_masks_finite(list(self.bond_charges),
                                   list(self.phys_charges),
                                   modulus=self.modulus)

    def flux_masks(self, sector: int) -> np.ndarray:
        """Charged-excitation masks (see flux_masks_finite)."""
        return flux_masks_finite(list(self.bond_charges),
                                 list(self.phys_charges), sector,
                                 modulus=self.modulus)

    @staticmethod
    def random(L: int, phys_charges: Sequence[int], D: int, total: int = 0,
               dtype=torch.complex128, modulus: int = None, device="cuda",
               generator: torch.Generator = None) -> "SymmetricFiniteMPS":
        """A random state of total charge `total`, on the card unless
        `device` says otherwise; `generator` must live on `device` (None:
        the global generator)."""
        bond_charges = assign_bond_charges(L, phys_charges, D, total,
                                           modulus=modulus)
        masks = torch.as_tensor(charge_masks_finite(
            bond_charges, phys_charges, modulus=modulus), device=device)
        As = _randn((L, D, len(phys_charges), D), dtype, device, generator)
        psi = FiniteMPS.from_tensors(As * masks)
        # re-mask after gauging (rounding only)
        psi = FiniteMPS(psi.ALs * masks, psi.ARs * masks,
                        psi.AC * masks[0], 0)
        return SymmetricFiniteMPS(psi, tuple(bond_charges),
                                  tuple(int(q) for q in phys_charges),
                                  modulus)


def _labels_from_counts(counts: dict, D: int) -> np.ndarray:
    tot = sum(counts.values())
    order = sorted(counts, key=lambda q: -counts[q])
    alloc = {}
    for q in order:
        alloc[q] = max(1, int(round(D * counts[q] / tot)))
    while sum(alloc.values()) > D:
        q = min((x for x in alloc if alloc[x] > 0), key=lambda x: counts[x])
        alloc[q] -= 1
        if alloc[q] == 0:
            del alloc[q]
    while sum(alloc.values()) < D:
        for q in order:
            if q in alloc and sum(alloc.values()) < D:
                alloc[q] += 1
    lab = np.zeros(D, int)
    pos = 0
    for q in sorted(alloc, key=lambda q: -alloc[q]):
        lab[pos: pos + alloc[q]] = q
        pos += alloc[q]
    return lab


def uniform_bond_charges_cell(L: int, D: int, phys_charges: Sequence[int],
                              window: int = None,
                              modulus: int = None) -> List[np.ndarray]:
    """Charge labels for the L bonds of a uniform unit cell (bond i right
    of site i), with sector dimensions from the path counts of a
    half-window. When every physical charge is odd (spin-1/2 with charges
    +-1) the bond parity alternates site by site, so L must be even."""
    phys = np.asarray(phys_charges, int)
    if window is None:
        window = max(2, int(np.ceil(np.log(D) / np.log(len(phys)))) + 2)
    window += window % 2  # even window -> parity-0 counts

    def counts_after(n):
        counts = {0: 1.0}
        for _ in range(n):
            new = {}
            for q, m in counts.items():
                for p in phys:
                    qn = _reduce(q + p, modulus)
                    new[qn] = new.get(qn, 0.0) + m
            counts = new
        return counts

    all_odd = modulus is None and bool(np.all(phys % 2 != 0))
    even_lab = _labels_from_counts(counts_after(window), D)
    if not all_odd:
        return [even_lab.copy() for _ in range(L)]
    if L % 2 != 0:
        raise ValueError("odd physical charges need an even unit cell "
                         "(alternating bond parity)")
    odd_lab = _labels_from_counts(counts_after(window + 1), D)
    # bond i has parity (i+1) mod 2 relative to bond L-1 (even by choice)
    return [odd_lab.copy() if i % 2 == 0 else even_lab.copy()
            for i in range(L)]


def uniform_charge_masks(bond_charges: List[np.ndarray],
                         phys_charges: Sequence[int], modulus: int = None):
    """(A_mask (L, D, d, D), C_mask (L, D, D)) boolean arrays for the
    unit-cell bonds; site i's left bond is bond (i-1) mod L."""
    L = len(bond_charges)
    D = bond_charges[0].shape[0]
    phys = np.asarray(phys_charges, int)
    A = np.zeros((L, D, len(phys), D), bool)
    C = np.zeros((L, D, D), bool)
    for i in range(L):
        cl = bond_charges[(i - 1) % L][:, None, None]
        cp = phys[None, :, None]
        cr = bond_charges[i][None, None, :]
        cb = bond_charges[i]
        if modulus is None:
            A[i] = (cl + cp) == cr
            C[i] = cb[:, None] == cb[None, :]
        else:
            live = (cl < DEAD_LABEL) & (cr < DEAD_LABEL)
            A[i] = ((cl + cp - cr) % modulus == 0) & live
            liveC = (cb[:, None] < DEAD_LABEL) & (cb[None, :] < DEAD_LABEL)
            C[i] = ((cb[:, None] - cb[None, :]) % modulus == 0) & liveC
    return A, C


def _mask_infinite(psi: InfiniteMPS, A_mask, C_mask) -> InfiniteMPS:
    Am, Cm = A_mask.to(psi.dtype), C_mask.to(psi.dtype)
    return InfiniteMPS(psi.AL * Am, psi.AR * Am, psi.AC * Am, psi.C * Cm)


@dataclasses.dataclass(frozen=True)
class SymmetricInfiniteMPS:
    """A uniform MPS constrained to an abelian sector: per-bond static
    charge labels over the unit cell (zero net flux per cell)."""

    state: InfiniteMPS
    bond_charges: Tuple[np.ndarray, ...]  # L arrays (D,), bond i right of site i
    phys_charges: Tuple[int, ...]
    modulus: int = None  # None = U(1); n = Z_n fusion

    @property
    def masks(self):
        """(A_mask (L, D, d, D), C_mask (L, D, D)), host boolean arrays."""
        return uniform_charge_masks(list(self.bond_charges),
                                    self.phys_charges, modulus=self.modulus)

    def device_masks(self):
        """`masks` as boolean tensors on the state's device."""
        A_mask, C_mask = self.masks
        dev = self.state.device
        return (torch.as_tensor(A_mask, device=dev),
                torch.as_tensor(C_mask, device=dev))

    def flux_masks(self, sector: int) -> np.ndarray:
        """(L, D, d, D) charged-excitation masks over the unit cell: B_i
        supported here carries charge flux `sector` between the
        surrounding ground-state bond labels."""
        L = len(self.bond_charges)
        D = self.bond_charges[0].shape[0]
        phys = np.asarray(self.phys_charges, int)
        out = np.zeros((L, D, len(phys), D), bool)
        for i in range(L):
            cl = self.bond_charges[(i - 1) % L][:, None, None]
            cp = phys[None, :, None]
            cr = self.bond_charges[i][None, None, :]
            live = (cl < DEAD_LABEL) & (cr < DEAD_LABEL)
            if self.modulus is None:
                out[i] = ((cl + cp) == (cr + sector)) & live
            else:
                out[i] = ((cl + cp - cr - sector) % self.modulus == 0) & live
        return out

    @staticmethod
    def random(L: int, phys_charges: Sequence[int], D: int,
               dtype=torch.complex128, modulus: int = None, device="cuda",
               generator: torch.Generator = None) -> "SymmetricInfiniteMPS":
        """A random gauge-fixed sector state, on the card unless `device`
        says otherwise; `generator` must live on `device`."""
        bonds = uniform_bond_charges_cell(L, D, phys_charges,
                                          modulus=modulus)
        A_mask, C_mask = (torch.as_tensor(m, device=device) for m in
                          uniform_charge_masks(bonds, phys_charges,
                                               modulus=modulus))
        A = _randn((L, D, len(phys_charges), D), dtype, device, generator)
        psi = InfiniteMPS.from_A(A * A_mask)
        return SymmetricInfiniteMPS(_mask_infinite(psi, A_mask, C_mask),
                                    tuple(bonds),
                                    tuple(int(q) for q in phys_charges),
                                    modulus)


def find_groundstate_symmetric_infinite(spsi: SymmetricInfiniteMPS, H,
                                        alg=None):
    """Sector-constrained VUMPS: the masked VUMPS iteration, then one
    re-canonicalization and a re-mask. Returns (SymmetricInfiniteMPS,
    envs, eps)."""
    from ..algorithms.vumps import VUMPS, _vumps_iteration_impl
    from ..environments.infinite_ham import hamiltonian_environments

    if alg is None:
        alg = VUMPS()
    psi = spsi.state
    A_mask, C_mask = spsi.device_masks()
    eps = 1.0
    env_guess = None
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            psi, eps_dev, env_guess, _ = _vumps_iteration_impl(
                psi, H, alg.krylovdim, alg.eig_maxrestarts, alg.gauge_tol,
                1e-12, inner_tol, A_mask=A_mask, C_mask=C_mask,
                env_guess=env_guess)
            eps = to_host(eps_dev)[0]
            if eps < alg.tol:
                break
        # the iterations regauge locally: re-canonicalize once, re-mask
        psi = InfiniteMPS.from_AL(psi.AL, psi.C[psi.period - 1],
                                  tol=alg.gauge_tol)
        psi = _mask_infinite(psi, A_mask, C_mask)
        envs = hamiltonian_environments(psi, H, env_init=env_guess)
    return dataclasses.replace(spsi, state=psi), envs, eps


def find_groundstate_symmetric(spsi: SymmetricFiniteMPS, H, alg=None):
    """Charge-sector one-site DMRG: the conservation masks ride the sweep's
    masking hook. Returns (SymmetricFiniteMPS, envs, eps)."""
    from ..algorithms.dmrg import DMRG, _dmrg_sweep_impl

    if alg is None:
        alg = DMRG()
    psi = spsi.state.move_center(0)
    L, D = psi.length, psi.D
    dtype, device = psi.dtype, psi.device
    masks = torch.as_tensor(spsi.masks, device=device)
    # copies: the sweep updates its tensor arguments in place
    ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
    eps = 1.0
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        w = Ws.shape[1]
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))
        for it in range(1, alg.maxiter + 1):
            # sector-constrained solves keep the corrective local pass: the
            # masked H_eff has a large degenerate null space, and the
            # single-pass recurrence loses ~1e-6 of accuracy against ED
            ALs, ARs, AC, GRs, _, eps, _ = _dmrg_sweep_impl(
                ALs, ARs, AC, Ws, GRs, updatetol(eps, it), alg.krylovdim,
                alg.eig_maxrestarts, masks=masks, reorth="local",
                split_dtype=masked_split_dtype(dtype), sector_solve=True)
            if eps < alg.tol:
                break
        psi = FiniteMPS(ALs, ARs, AC, 0)
        GLs = compute_left_envs(ALs, Ws, left_boundary(w, D, dtype, device))
    return dataclasses.replace(spsi, state=psi), FiniteEnv(GLs, GRs), eps


def _sectors_of(labels, C: np.ndarray) -> dict:
    """{charge: Schmidt values above 1e-14} of the bond matrix C (host
    numpy) per live charge block."""
    out = {}
    for q in sorted(set(int(x) for x in labels if x < 10**6)):
        idx = np.where(labels == q)[0]
        s = np.linalg.svd(C[np.ix_(idx, idx)], compute_uv=False)
        out[q] = s[s > 1e-14]
    return out


def sector_entanglement_spectrum(spsi: SymmetricFiniteMPS, bond: int):
    """{charge: Schmidt values} across `bond`, host numpy arrays (the bond
    matrix is moved to the host once and split by charge block there)."""
    psi = spsi.state.move_center(max(bond - 1, 0))
    _, C = leftorth(psi.AC)
    return _sectors_of(np.asarray(spsi.bond_charges[bond]),
                       C.cpu().resolve_conj().numpy())


def sector_entanglement_spectrum_infinite(spsi: SymmetricInfiniteMPS,
                                          bond: int = -1):
    """{charge: Schmidt values} of the bond matrix C at a unit-cell bond."""
    L = len(spsi.bond_charges)
    bond = bond % L
    return _sectors_of(np.asarray(spsi.bond_charges[bond]),
                       spsi.state.C[bond].cpu().resolve_conj().numpy())


# ---------------------------------------------------------------------------
# Sector-resolved two-site DMRG (dynamic sector allocation)
# ---------------------------------------------------------------------------

def _sector_split(theta, cl: np.ndarray, cr: np.ndarray, phys: np.ndarray,
                  pad: int, modulus: int = None):
    """Split a two-site tensor theta (D, d, d, D) at its middle bond with one
    SVD per charge sector, keeping the global top-D Schmidt values (each
    sector capped by its block rank).

    Rows (l, p1) carry middle charge cl[l] + phys[p1], columns (p2, r)
    carry cr[r] - phys[p2], both reduced mod n for Z_n; theta is
    block-diagonal across the middle charge. Rows and columns of a dead
    (padded) label take part in no sector. The index sets are host numpy; the blocks, their SVDs
    (cuSOLVER `gesvd` on the card) and the new tensors stay on theta's
    device, and one host read per bond brings back the singular values for
    the selection. Returns (AL (D,d,D), S (D,), AR (D,d,D), labels_mid
    (D,), err); unused slots get the pad label and zero columns."""
    D, d = theta.shape[0], theta.shape[1]
    dev = theta.device
    rdt = theta.real.dtype if theta.is_complex() else theta.dtype
    row_live = np.repeat(cl < DEAD_LABEL, d)                  # (D*d,)
    col_live = np.tile(cr < DEAD_LABEL, d)                    # (d*D,)
    rowq = _reduce(cl[:, None] + phys[None, :], modulus).reshape(-1)
    colq = _reduce(cr[None, :] - phys[:, None], modulus).reshape(-1)
    M = theta.reshape(D * d, d * D)
    live = sorted(set(rowq[row_live].tolist())
                  & set(colq[col_live].tolist()))
    svd_kw = {"driver": "gesvd"} if theta.is_cuda else {}
    blocks = []
    for q in live:
        ri = torch.as_tensor(np.where(row_live & (rowq == q))[0],
                             device=dev)
        ci = torch.as_tensor(np.where(col_live & (colq == q))[0],
                             device=dev)
        U, s, Vh = torch.linalg.svd(M[ri][:, ci], full_matrices=False,
                                    **svd_kw)
        blocks.append((q, ri, ci, U, s, Vh))
    host = to_host_array(torch.linalg.vector_norm(M) ** 2,
                         *[b[4] for b in blocks]).real.astype(np.float64)
    total2, pos = float(host[0]), 1
    svals = {}
    for q, ri, ci, U, s, Vh in blocks:
        sv = host[pos: pos + s.shape[0]]
        pos += s.shape[0]
        keepable = int(np.sum(sv > 1e-14 * max(1.0, sv[0] if len(sv)
                                                else 0.0)))
        if keepable:
            svals[q] = (ri, ci, U, s, Vh, sv[:keepable])
    # global top-D selection across sectors
    allvals = sorted(((float(v), q, k) for q, b in svals.items()
                      for k, v in enumerate(b[5])), reverse=True)
    counts = {}
    for _, q, _ in allvals[:D]:
        counts[q] = counts.get(q, 0) + 1
    labels_mid = np.full(D, pad, int)
    AL = torch.zeros((D * d, D), dtype=theta.dtype, device=dev)
    AR = torch.zeros((D, d * D), dtype=theta.dtype, device=dev)
    S = torch.zeros(D, dtype=rdt, device=dev)
    pos = 0
    kept2 = 0.0
    for q in sorted(counts):
        n = counts[q]
        ri, ci, U, s, Vh, sv = svals[q]
        labels_mid[pos: pos + n] = q
        AL[ri, pos: pos + n] = U[:, :n]
        AR[pos: pos + n, ci] = Vh[:n]
        S[pos: pos + n] = s[:n]
        kept2 += float(np.sum(sv[:n] ** 2))
        pos += n
    err = float(np.sqrt(max(total2 - kept2, 0.0) / max(total2, 1e-300)))
    S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
    return (AL.reshape(D, d, D), S, AR.reshape(D, d, D), labels_mid, err)


def _theta_mask(cl: np.ndarray, cr: np.ndarray, phys: np.ndarray,
                modulus: int = None) -> np.ndarray:
    """(D, d, d, D) boolean sector mask of a two-site tensor between bonds
    of labels cl and cr: cl + p1 + p2 == cr (mod n for Z_n), on live
    labels only."""
    live = (cl[:, None, None, None] < DEAD_LABEL) & \
        (cr[None, None, None, :] < DEAD_LABEL)
    q = (cl[:, None, None, None] + phys[None, :, None, None]
         + phys[None, None, :, None] - cr[None, None, None, :])
    return (_reduce(q, modulus) == 0) & live


def find_groundstate_symmetric_dmrg2(spsi: SymmetricFiniteMPS, H, alg=None):
    """Sector-resolved two-site DMRG with dynamic sector allocation: every
    bond split re-derives how many Schmidt vectors each charge sector
    keeps (global top-D across sectors); the path-count labels of
    `assign_bond_charges` only seed the start. Returns
    (SymmetricFiniteMPS with the new bond labels, envs, eps). A Z_n state
    is split by its charges mod n and keeps its modulus (the JAX package
    splits by unreduced charges and drops the modulus)."""
    from ..algorithms.derivatives import ac2_apply
    from ..algorithms.dmrg2 import DMRG2

    if alg is None:
        alg = DMRG2()
    psi = spsi.state.move_center(0)
    L, D = psi.length, psi.D
    dtype, device = psi.dtype, psi.device
    phys = np.asarray(spsi.phys_charges, int)
    bonds = [np.asarray(c, int).copy() for c in spsi.bond_charges]
    ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC

    log = IterLog("DMRG2(U1)", alg.verbosity)
    eps, lam_prev = 1.0, None
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        w = Ws.shape[1]
        GRs = list(compute_right_envs(ARs, Ws,
                                      right_boundary(w, D, dtype, device)))
        GLs = [left_boundary(w, D, dtype, device)] * (L + 1)

        def solve(i, theta, inner_tol):
            # the solve runs in the sector (x -> m * H(m * x) from m * theta):
            # an unmasked Krylov space drifts to a lower foreign sector
            # (ROADMAP.md, F6)
            GL, W1, W2, GR = GLs[i], Ws[i], Ws[i + 1], GRs[i + 2]
            m = torch.as_tensor(_theta_mask(bonds[i], bonds[i + 2], phys,
                                            spsi.modulus),
                                device=device).to(dtype)
            res = eigsh_smallest(
                lambda x: m * ac2_apply(GL, W1, W2, GR, m * x), m * theta,
                alg.krylovdim, alg.eig_maxrestarts, inner_tol)
            AL, S, AR, labq, _ = _sector_split(
                res.eigenvector, bonds[i], bonds[i + 2], phys,
                pad=10**6 * (i + 2), modulus=spsi.modulus)
            bonds[i + 1] = labq
            return res.eigenvalue, AL, S, AR

        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            for i in range(L - 1):
                theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[i + 1])
                lam, AL, S, AR = solve(i, theta, inner_tol)
                ALs[i] = AL
                AC = S.to(dtype)[:, None, None] * AR
                GLs[i + 1] = transfer_left_mpo(GLs[i], Ws[i], AL, AL)
            for i in range(L - 2, -1, -1):
                theta = torch.einsum("lpm,mqr->lpqr", ALs[i], AC)
                lam, AL, S, AR = solve(i, theta, inner_tol)
                ARs[i + 1] = AR
                AC = AL * S.to(dtype)[None, None, :]
                GRs[i + 1] = transfer_right_mpo(GRs[i + 2], Ws[i + 1], AR,
                                                AR)
            eps = abs(lam - lam_prev) if lam_prev is not None else 1.0
            lam_prev = lam
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            if eps < alg.tol:
                break
        psi = FiniteMPS(ALs, ARs, AC, 0)
        envs = FiniteEnv(
            compute_left_envs(ALs, Ws, left_boundary(w, D, dtype, device)),
            compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device)))
    return (SymmetricFiniteMPS(psi, tuple(bonds), spsi.phys_charges,
                               spsi.modulus), envs, eps)
