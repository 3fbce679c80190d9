"""Fibonacci-anyon boundary states of the PyTorch port (counterpart of
mpskit_tpu/symmetry/fibonacci.py), used by the hard-hexagon transfer MPO
(`models.statmech.hard_hexagon_fibonacci`).

Anyonic tensors live in the orthonormal fusion-path basis: a virtual bond
is a dense padded index with a static sector label per slot (0 = vacuum,
1 = tau), the physical leg of a boundary MPS over tau-anyons is the path
height after the site, and a symmetric tensor is a dense tensor times a
static boolean mask (tau x tau = 1 + tau makes every hom space at most
one-dimensional). The contractions are the dense ones of the boundary
VUMPS (`algorithms/statmech.py`), run with the masks; only the trace
readouts change: the entanglement entropy takes the quantum trace
S = -sum_a d_a sum_i p_{a,i} log p_{a,i}, sum_a d_a sum_i p_{a,i} = 1.

Labels and masks are host numpy data; the masks move to the state's
device once per call. The random starts draw from a `torch.Generator`
on the state's device (None: seeded 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .category import (
    bond_labels as _cat_bond_labels, chain_masks as _cat_chain_masks,
    fibonacci_category, quantum_entropy as _cat_entropy,
    quantum_schmidt as _cat_schmidt,
)

PHI = (1.0 + np.sqrt(5.0)) / 2.0
QDIMS = np.array([1.0, PHI])  # d_1, d_tau
CATEGORY = fibonacci_category()
# height-pair basis of the hard-hexagon MPO bond (y = upper path height,
# x = height after the threaded horizontal tau): x in y (x) tau
FIB_PAIRS = ((0, 1), (1, 0), (1, 1))


def _host(t) -> np.ndarray:
    """A tensor's values as a host numpy array."""
    return t.detach().cpu().resolve_conj().numpy()


def _generator(generator, device, seed: int = 0):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return generator


def _randn(shape, dtype, device, generator):
    if dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def masked_state(A, A_mask, C_mask):
    """Gauge-fix raw masked tensors A (L, D, d, D) and re-apply the masks
    (numpy booleans) to AL, AR, AC and C."""
    from ..states.infinitemps import InfiniteMPS

    psi = InfiniteMPS.from_A(A)
    Am = torch.as_tensor(A_mask, device=A.device).to(A.dtype)
    Cm = torch.as_tensor(C_mask, device=A.device).to(A.dtype)
    return InfiniteMPS(psi.AL * Am, psi.AR * Am, psi.AC * Am, psi.C * Cm)


def fib_allowed(a: int, b: int) -> bool:
    """b in a (x) tau: every height step is allowed except 1 -> 1."""
    return bool(CATEGORY.N[a, 1, b])


def fibonacci_bond_labels(D: int) -> np.ndarray:
    """Static sector labels of a dense bond of dimension D, n_tau / n_1 ->
    phi (the asymptotic fusion-path count ratio); vacuum slots first."""
    return _cat_bond_labels(CATEGORY, D)


def fibonacci_masks(labels: np.ndarray, L: int = 1):
    """(A_mask (L, D, 2, D), C_mask (L, D, D)) of an L-site cell with
    uniform labels: physical index = height after the site; bond slots of
    equal sector couple in C."""
    return _cat_chain_masks(CATEGORY, 1, labels, L)


def fibonacci_env_mask(labels: np.ndarray) -> np.ndarray:
    """(w=3, D, D) sector alignment of GL / GR against the hard-hexagon
    MPO: GL[m=(y, x), l_bra, l_ket] lives on label(l_bra) == y and
    label(l_ket) == x."""
    D = labels.shape[0]
    M = np.zeros((len(FIB_PAIRS), D, D), bool)
    for k, (y, x) in enumerate(FIB_PAIRS):
        M[k] = (labels[:, None] == y) & (labels[None, :] == x)
    return M


@dataclasses.dataclass(frozen=True)
class FibonacciInfiniteMPS:
    """A uniform boundary MPS over tau-anyons in the fusion-path basis: the
    dense InfiniteMPS and the static bond sector labels."""

    state: object                 # InfiniteMPS
    labels: Tuple[int, ...]

    @property
    def masks(self):
        return fibonacci_masks(np.asarray(self.labels, int),
                               self.state.period)

    @staticmethod
    def random(D: int, L: int = 3, dtype=torch.float64, device="cuda",
               generator: torch.Generator = None) -> "FibonacciInfiniteMPS":
        """Masked random start, on the card unless `device` says otherwise.
        L=3 by default: the hard-hexagon fixed point carries the triangular
        lattice's 3-sublattice rotation, which a one-site cell represents
        only through the masked path."""
        labels = fibonacci_bond_labels(D)
        A_mask, C_mask = fibonacci_masks(labels, L)
        gen = _generator(generator, device)
        A = _randn((L, D, 2, D), dtype, device, gen)
        A = A * torch.as_tensor(A_mask, device=device).to(dtype)
        return FibonacciInfiniteMPS(masked_state(A, A_mask, C_mask),
                                    tuple(int(x) for x in labels))

    def grow(self, D_new: int, noise: float = 1e-3,
             generator: torch.Generator = None) -> "FibonacciInfiniteMPS":
        """Embed into a larger bond (the k-th slot of sector a goes to the
        k-th new slot of a) and seed the new directions with masked noise:
        the sector-aware counterpart of RandExpand."""
        old = np.asarray(self.labels, int)
        new = fibonacci_bond_labels(D_new)
        perm = np.zeros(len(old), int)
        for a in (0, 1):
            old_idx = np.where(old == a)[0]
            new_idx = np.where(new == a)[0]
            if len(new_idx) < len(old_idx):
                raise ValueError("grow() cannot shrink a sector")
            perm[old_idx] = new_idx[:len(old_idx)]
        psi = self.state
        L, dtype, device = psi.period, psi.dtype, psi.device
        A_mask, C_mask = fibonacci_masks(new, L)
        idx = torch.as_tensor(perm, device=device)
        rows = torch.zeros((L, D_new, 2, len(old)), dtype=dtype,
                           device=device)
        rows[:, idx] = psi.AL
        A = torch.zeros((L, D_new, 2, D_new), dtype=dtype, device=device)
        A[..., idx] = rows
        Am = torch.as_tensor(A_mask, device=device).to(dtype)
        gen = _generator(generator, device)
        A = (A + noise * _randn(A.shape, dtype, device, gen) * Am) * Am
        return FibonacciInfiniteMPS(masked_state(A, A_mask, C_mask),
                                    tuple(int(x) for x in new))


def anyonic_schmidt(spsi: FibonacciInfiniteMPS):
    """{sector: probabilities p_{a,i}} of bond 0 with the quantum-trace
    normalization sum_a d_a sum_i p_{a,i} = 1."""
    return _cat_schmidt(CATEGORY, np.asarray(spsi.labels, int),
                        _host(spsi.state.C[0]))


def anyonic_entropy(spsi: FibonacciInfiniteMPS) -> float:
    """Quantum-trace entanglement entropy of bond 0,
    S = -sum_a d_a sum_i p_{a,i} log p_{a,i}."""
    return _cat_entropy(CATEGORY, np.asarray(spsi.labels, int),
                        _host(spsi.state.C[0]))


def leading_boundary_fibonacci(spsi: FibonacciInfiniteMPS, O, alg=None):
    """Sector-constrained boundary VUMPS of an anyonic transfer MPO in the
    fusion-path basis: 10 masked VOMPS steps pull the random start into
    the basin of the dominant boundary (the eigensolver-driven iterations
    can otherwise lock onto a subdominant real fixed point of the critical
    transfer), then masked VUMPS_Boundary iterations, then the masked,
    real-selecting environments seeded by the last iteration's fixed
    points. Returns (FibonacciInfiniteMPS, envs,
    eps)."""
    from ..algorithms.statmech import (
        VUMPS_Boundary, _boundary_vomps_iteration, _boundary_vumps_iteration,
    )
    from ..config import VERBOSE_ITER, matmul_precision
    from ..environments.infinite_mpo import mpo_environments, stack_O
    from ..utils.dynamictols import updatetol
    from ..utils.logging import IterLog
    from ..utils.sync import to_host

    if alg is None:
        alg = VUMPS_Boundary(tol=1e-6)
    psi = spsi.state
    dev = psi.device
    A_mask, C_mask = (torch.as_tensor(m, device=dev) for m in spsi.masks)
    env_mask = torch.as_tensor(
        fibonacci_env_mask(np.asarray(spsi.labels, int)), device=dev)
    Os = stack_O(O, psi.period, psi.dtype, dev)
    log = IterLog("leading_boundary_fib", alg.verbosity)
    eps = 1.0
    GLg = GRg = None
    with matmul_precision():
        for _ in range(10):
            psi, _, GLg, GRg, _ = _boundary_vomps_iteration(
                psi, Os, alg.gauge_tol, 1e-12, GL_guess=GLg, GR_guess=GRg,
                A_mask=A_mask, C_mask=C_mask, env_mask=env_mask)
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            psi, eps_dev, GLg, GRg, diag = _boundary_vumps_iteration(
                psi, Os, alg.krylovdim, alg.gauge_tol, 1e-12, inner_tol,
                GL_guess=GLg, GR_guess=GRg, A_mask=A_mask, C_mask=C_mask,
                env_mask=env_mask)
            log.solver_warn(it, diag[:2], inner_tol)
            eps = to_host(eps_dev)[0]
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(alg.maxiter, 0.0, eps)
        # seeded by the last iteration's fixed points: from the default
        # seed (ones + identity) the real-pair selection can land on
        # another real eigenvalue of the critical channel (lambda 0.42-0.74
        # in place of 0.88 after short runs; the JAX package seeds none)
        envs = mpo_environments(psi, Os, GL0=GLg, GR0=GRg, env_mask=env_mask,
                                select_real=True)
    return dataclasses.replace(spsi, state=psi), envs, eps


def anyonic_entropy_state(psi, bond: int = 0, rank_tol: float = 1e-6):
    """Quantum-trace entanglement entropy of an UNMASKED boundary MPS of an
    anyonic (path-basis) transfer MPO, its sector split recovered from the
    dense tensors (host SVDs): the vacuum subspace of bond i is the row
    space of AL[i][:, 0, :], and each Schmidt vector of C_i goes to the
    sector carrying its dominant weight. Exact for one-cell masked states;
    approximate for the 3-cell hard-hexagon fixed point, whose Z3
    sublattice twist mixes the sectors at the few-percent level. Returns
    (S, {sector: probabilities})."""
    AL = _host(psi.AL[bond % psi.period])
    C = _host(psi.C[bond % psi.period])
    _, s0, V0 = np.linalg.svd(AL[:, 0, :])
    r0 = int(np.sum(s0 > rank_tol * max(s0[0], 1e-300)))
    P0 = V0[:r0].conj().T @ V0[:r0]          # projector onto sector 0
    Us, s, _ = np.linalg.svd(C)
    w0 = np.einsum("ik,ij,jk->k", Us.conj(), P0, Us).real
    sector = (w0 < 0.5).astype(int)          # 1 = tau
    p = s * s
    p = p / float(np.sum(QDIMS[sector] * p))
    S = 0.0
    for a in (0, 1):
        pa = p[sector == a]
        pa = pa[pa > 1e-300]
        S -= QDIMS[a] * float(np.sum(pa * np.log(pa)))
    return S, {0: p[sector == 0], 1: p[sector == 1]}
