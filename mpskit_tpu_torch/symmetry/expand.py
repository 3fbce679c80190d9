"""Sector-aware bond expansion for abelian-symmetric states (counterpart
of mpskit_tpu/symmetry/expand.py): the expansion vectors are chosen per
charge sector and the bond charge labels are EXTENDED with the charges of
the chosen vectors, so a symmetric state keeps its labels through bond
growth.

The two-site residual of the infinite OptimalExpand is computed on the
state's device and split by charge sector on the host (numpy SVDs of the
sector blocks, a construction-time step as in the JAX package). The
full-rank noise on the new block comes from a `torch.Generator` (seeded 3
on the state's device unless the caller passes one) where the JAX package
draws `np.random.default_rng(3)`: the same distribution, other numbers.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from ..config import matmul_precision
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from .charges import (
    DEAD_LABEL, SymmetricFiniteMPS, SymmetricInfiniteMPS, _mask_infinite,
    assign_bond_charges, uniform_charge_masks,
)


def _pad(arr, D_new: int, axes):
    pads = [0, 0] * arr.ndim
    for ax in axes:
        # torch's pad lists the last axis first
        pads[2 * (arr.ndim - 1 - ax) + 1] = D_new - arr.shape[ax]
    return torch.nn.functional.pad(arr, pads)


def expand_symmetric_finite(spsi: SymmetricFiniteMPS, extra: int,
                            H=None) -> SymmetricFiniteMPS:
    """Grow every bond by (up to) `extra` slots, appending the charge labels
    that the path-count allocation at the larger D adds. The represented
    state is unchanged (the new slots are zero); H is accepted for
    signature parity."""
    psi = spsi.state.move_center(0)
    L, D = psi.length, psi.D
    D_new = D + extra
    target = assign_bond_charges(L, list(spsi.phys_charges), D_new,
                                 modulus=spsi.modulus)
    new_bonds = []
    for i in range(L + 1):
        old = np.asarray(spsi.bond_charges[i])
        live_old = Counter(int(q) for q in old if q < DEAD_LABEL)
        want = Counter(int(q) for q in target[i] if q < DEAD_LABEL)
        fresh = sorted((want - live_old).elements())[:extra]
        lab = np.full(D_new, 10 ** 6 * (i + 1), int)
        lab[:D] = old
        lab[D: D + len(fresh)] = fresh
        new_bonds.append(lab)
    out = SymmetricFiniteMPS(psi, tuple(new_bonds), spsi.phys_charges,
                             spsi.modulus)
    m = torch.as_tensor(out.masks, device=psi.device)
    return dataclasses.replace(out, state=FiniteMPS(
        _pad(psi.ALs, D_new, (1, 3)) * m, _pad(psi.ARs, D_new, (1, 3)) * m,
        _pad(psi.AC, D_new, (0, 2)) * m[0], 0))


def _sector_directions(R: np.ndarray, cl, cr, phys, modulus, extra: int):
    """The `extra` globally largest per-sector singular directions of the
    two-site residual R (D, d, d, D): [(singular value, charge, (D, d)
    left vector)], largest first."""
    D, d = R.shape[0], R.shape[1]
    row_q = cl[:, None] + phys[None, :]          # (D, d)
    col_q = cr[None, :] - phys[:, None]          # (d, D)
    if modulus is not None:
        row_q, col_q = row_q % modulus, col_q % modulus
    row_live = cl[:, None] < DEAD_LABEL
    col_live = cr[None, :] < DEAD_LABEL
    cands = []
    for a in sorted({int(q) for q, lv in zip(row_q.ravel(), row_live.ravel())
                     if lv}):
        rm = (row_q == a) & row_live
        cm = (col_q == a) & col_live
        M = (R * rm[:, :, None, None] * cm[None, None, :, :]).reshape(
            D * d, d * D)
        if not np.any(M):
            continue
        U, S, _ = np.linalg.svd(M, full_matrices=False)
        for k in range(min(len(S), extra)):
            if S[k] > 1e-14:
                cands.append((float(S[k]), a, U[:, k].reshape(D, d)))
    cands.sort(key=lambda t: -t[0])
    return cands[:extra]


def expand_symmetric_infinite(spsi: SymmetricInfiniteMPS, extra: int,
                              H=None, envs=None,
                              generator: torch.Generator = None
                              ) -> SymmetricInfiniteMPS:
    """Sector-aware OptimalExpand (H given) or RandExpand (H None) of a
    uniform symmetric state.

    OptimalExpand: per bond, the two-site derivative residual projected on
    the left and right tangent complements is charge-block-diagonal (rows
    (l, p) carry q(l) + q(p), columns (q, r) carry q(r) - q(q)); each
    sector block gets its own SVD, and the globally largest singular values
    pick the new directions and their charges, appended to the bond's
    labels. RandExpand replicates the most occupied live sectors of each
    bond."""
    from ..algorithms.derivatives import ac2_apply
    from ..environments.finite import stack_W
    from ..environments.infinite_ham import hamiltonian_environments

    psi = spsi.state
    L, D, d = psi.period, psi.D, psi.physicaldim
    D_new = D + extra
    dtype, device = psi.dtype, psi.device
    phys = np.asarray(spsi.phys_charges, int)
    new_dirs = [None] * L          # per bond: (D, d, e) charge-pure columns
    new_labels = [[] for _ in range(L)]

    if H is not None:
        with matmul_precision():
            if envs is None:
                envs = hamiltonian_environments(psi, H)
            Ws = stack_W(H, L, dtype, device)
            for i in range(L):
                j = (i + 1) % L
                theta = torch.einsum("lpm,mqr->lpqr", psi.AC[i], psi.AR[j])
                h2 = ac2_apply(envs.GLs[i], Ws[i], Ws[j], envs.GRs[j], theta)
                # tangent-complement projections in B-space form (exact also
                # for the rank-deficient masked gauges)
                z = torch.einsum("lpm,lpqr->mqr", psi.AL[i].conj(), h2)
                R = h2 - torch.einsum("lpm,mqr->lpqr", psi.AL[i], z)
                y = torch.einsum("lpqr,mqr->lpm", R, psi.AR[j].conj())
                R = R - torch.einsum("lpm,mqr->lpqr", y, psi.AR[j])
                take = _sector_directions(
                    R.cpu().resolve_conj().numpy(),
                    np.asarray(spsi.bond_charges[(i - 1) % L]),
                    np.asarray(spsi.bond_charges[j]), phys, spsi.modulus,
                    extra)
                if take:
                    new_dirs[i] = torch.as_tensor(
                        np.stack([u for _, _, u in take], axis=-1),
                        device=device)
                new_labels[i] = [a for _, a, _ in take]
    else:
        for i in range(L):
            live = Counter(int(q) for q in spsi.bond_charges[i]
                           if q < DEAD_LABEL)
            order = [q for q, _ in live.most_common()]
            new_labels[i] = [order[k % len(order)] for k in range(extra)]

    bonds_new = []
    for i in range(L):
        lab = np.full(D_new, 10 ** 6 * (i + 2), int)
        lab[:D] = np.asarray(spsi.bond_charges[i])
        lab[D: D + len(new_labels[i])] = new_labels[i]
        bonds_new.append(lab)
    A_mask, C_mask = (torch.as_tensor(m, device=device) for m in
                      uniform_charge_masks(bonds_new, spsi.phys_charges,
                                           modulus=spsi.modulus))
    A_new = torch.zeros((L, D_new, d, D_new), dtype=dtype, device=device)
    A_new[:, :D, :, :D] = psi.AL
    for i in range(L):
        if new_dirs[i] is not None:
            A_new[i, :D, :, D: D + new_dirs[i].shape[2]] = new_dirs[i]
    # charge-pure noise keeps the new block full rank (only where the new
    # conservation mask allows it)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(3)
    rdt = torch.empty((), dtype=dtype).real.dtype
    noise = 1e-6 * torch.randn(A_new.shape, generator=generator, dtype=rdt,
                               device=device)
    grow = torch.zeros_like(A_mask)
    grow[:, D:] = True
    grow[:, :, :, D:] = True
    A_new = A_new + (noise * (A_mask & grow)).to(dtype)
    psi_new = _mask_infinite(InfiniteMPS.from_A(A_new), A_mask, C_mask)
    return SymmetricInfiniteMPS(psi_new, tuple(bonds_new),
                                spsi.phys_charges, spsi.modulus)


def changebonds_symmetric(spsi, H=None, alg=None, extra: int = None,
                          envs=None):
    """Bond expansion of a symmetric state: OptimalExpand (needs H) or
    RandExpand by `alg`, or `extra` slots (optimal when H is given)."""
    from ..algorithms.changebonds import OptimalExpand, RandExpand

    if alg is not None:
        if isinstance(alg, OptimalExpand):
            extra, optimal = alg.dims, True
        elif isinstance(alg, RandExpand):
            extra, optimal = alg.dims, False
        else:
            raise TypeError(type(alg))
    else:
        optimal = H is not None
    if isinstance(spsi, SymmetricFiniteMPS):
        return expand_symmetric_finite(spsi, extra, H)
    if isinstance(spsi, SymmetricInfiniteMPS):
        return expand_symmetric_infinite(spsi, extra,
                                         H if optimal else None, envs=envs)
    raise TypeError(type(spsi))
