"""Non-abelian SU(2)-symmetric uniform states in the dense-projector form
(counterpart of mpskit_tpu/symmetry/su2.py).

Every virtual bond keeps its dense dimension D, laid out as complete SU(2)
multiplets with static (j, m) labels. An SU(2)-invariant site tensor lies
in the intertwiner space spanned by Clebsch-Gordan tensors; the static
orthonormal basis Q (D d D, n_red), built once on the host in numpy,
turns the symmetry into two products, P(A) = Q (Q^dag vec A). The VUMPS
iteration is the port's own dense one with the projector applied where
the JAX package applies it. The projector is (D d D x n_red), so this
path is for small bonds; `su2_reduced.py` is the fast path.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import factorial, sqrt
from typing import Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------------
# Clebsch-Gordan coefficients (exact, integer-factorial arithmetic on 2j)
# ----------------------------------------------------------------------------

def _f(n2: int) -> int:
    """factorial(n2/2) for even n2 (callers guarantee integrality)."""
    assert n2 % 2 == 0 and n2 >= 0, n2
    return factorial(n2 // 2)


@lru_cache(maxsize=None)
def clebsch_gordan2(tj1: int, tm1: int, tj2: int, tm2: int,
                    tJ: int, tM: int) -> float:
    """<j1 m1, j2 m2 | J M> with all spins given as 2j (integers)."""
    if tm1 + tm2 != tM:
        return 0.0
    if not (abs(tj1 - tj2) <= tJ <= tj1 + tj2):
        return 0.0
    if abs(tm1) > tj1 or abs(tm2) > tj2 or abs(tM) > tJ:
        return 0.0
    if (tj1 + tm1) % 2 or (tj2 + tm2) % 2 or (tJ + tM) % 2:
        return 0.0

    pref = (tJ + 1) * (
        _f(tJ + tj1 - tj2) * _f(tJ - tj1 + tj2) * _f(tj1 + tj2 - tJ)
    ) / _f(tj1 + tj2 + tJ + 2)
    pref *= (_f(tJ + tM) * _f(tJ - tM) * _f(tj1 - tm1) * _f(tj1 + tm1)
             * _f(tj2 - tm2) * _f(tj2 + tm2))

    total = 0.0
    # k runs over integers with all factorial args nonnegative
    k_min = max(0, (tj2 - tm1 - tJ) // 2, (tj1 + tm2 - tJ) // 2)
    k_max = min((tj1 + tj2 - tJ) // 2, (tj1 - tm1) // 2, (tj2 + tm2) // 2)
    for k in range(k_min, k_max + 1):
        denom = (factorial(k)
                 * _f(tj1 + tj2 - tJ - 2 * k)
                 * _f(tj1 - tm1 - 2 * k)
                 * _f(tj2 + tm2 - 2 * k)
                 * _f(tJ - tj2 + tm1 + 2 * k)
                 * _f(tJ - tj1 - tm2 + 2 * k))
        total += (-1.0) ** k / denom
    return sqrt(pref) * total


# ----------------------------------------------------------------------------
# Bond structure: complete multiplets with static (j, m) labels
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2Bond:
    """A virtual bond as an ordered list of SU(2) multiplets.

    multiplets: tuple of (2j, multiplicity). Dense dimension is
    sum(mult * (2j+1)); indices are laid out multiplet-major."""

    multiplets: Tuple[Tuple[int, int], ...]

    @property
    def dim(self) -> int:
        return sum(m * (tj + 1) for tj, m in self.multiplets)

    @property
    def n_multiplets(self) -> int:
        return sum(m for _, m in self.multiplets)

    def labels(self):
        """(tj[D], tm[D], mult_id[D]): per dense index, 2j, 2m and a unique
        multiplet id."""
        tjs, tms, mids = [], [], []
        mid = 0
        for tj, mult in self.multiplets:
            for _ in range(mult):
                for tm in range(-tj, tj + 1, 2):
                    tjs.append(tj)
                    tms.append(tm)
                    mids.append(mid)
                mid += 1
        return (np.asarray(tjs, int), np.asarray(tms, int),
                np.asarray(mids, int))

    def multiplet_slices(self):
        """[(mid, tj, start, stop)] dense index ranges per multiplet."""
        out = []
        pos = 0
        mid = 0
        for tj, mult in self.multiplets:
            for _ in range(mult):
                out.append((mid, tj, pos, pos + tj + 1))
                pos += tj + 1
                mid += 1
        return out


def build_A_projector(left: SU2Bond, tjp: int, right: SU2Bond) -> np.ndarray:
    """Orthonormal intertwiner basis Q of shape (Dl * d * Dr, n_red) for
    site tensors A[l, p, r] (phys = single spin-(tjp/2) irrep)."""
    Dl, Dr = left.dim, right.dim
    d = tjp + 1
    cols = []
    for (al, tjl, l0, l1) in left.multiplet_slices():
        for (br, tjr, r0, r1) in right.multiplet_slices():
            if not (abs(tjl - tjp) <= tjr <= tjl + tjp):
                continue
            T = np.zeros((Dl, d, Dr))
            for il, tml in enumerate(range(-tjl, tjl + 1, 2)):
                for ip, tmp in enumerate(range(-tjp, tjp + 1, 2)):
                    tmr = tml + tmp
                    if abs(tmr) > tjr:
                        continue
                    ir = (tmr + tjr) // 2
                    T[l0 + il, ip, r0 + ir] = clebsch_gordan2(
                        tjl, tml, tjp, tmp, tjr, tmr)
            v = T.reshape(-1)
            n = np.linalg.norm(v)
            if n > 1e-12:
                cols.append(v / n)
    if not cols:
        raise ValueError("no admissible fusion channels: bond structures "
                         "are incompatible with the physical spin")
    return np.stack(cols, axis=1)


def build_C_projector(bond: SU2Bond) -> np.ndarray:
    """Orthonormal basis QC (D * D, n_red) of Hom(V, V) intertwiners:
    identity blocks between equal-spin multiplets (Schur)."""
    D = bond.dim
    cols = []
    sl = bond.multiplet_slices()
    for (a, tja, a0, a1) in sl:
        for (b, tjb, b0, b1) in sl:
            if tja != tjb:
                continue
            T = np.zeros((D, D))
            for k in range(tja + 1):
                T[a0 + k, b0 + k] = 1.0
            cols.append(T.reshape(-1) / sqrt(tja + 1))
    return np.stack(cols, axis=1)


def project_A(A, Q):
    """P(A) = unvec(Q (Q^dag vec A)): the exact SU(2) covariance scrub."""
    v = A.reshape(-1)
    return (Q @ (Q.mH @ v)).reshape(A.shape)


def project_C(C, QC):
    v = C.reshape(-1)
    return (QC @ (QC.mH @ v)).reshape(C.shape)


def _projectors(spsi, dtype, device):
    Q = torch.as_tensor(build_A_projector(spsi.bond, spsi.tjp, spsi.bond),
                        device=device).to(dtype)
    QC = torch.as_tensor(build_C_projector(spsi.bond),
                         device=device).to(dtype)
    return Q, QC


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-30)


# ----------------------------------------------------------------------------
# SU(2)-symmetric uniform MPS + VUMPS driver
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SU2InfiniteMPS:
    """Uniform MPS over a single-site unit cell with SU(2)-multiplet bond
    structure (same bond on every cell boundary)."""

    state: object                 # InfiniteMPS (period 1)
    bond: SU2Bond
    tjp: int                      # physical 2j

    @staticmethod
    def random(bond: SU2Bond, tjp: int, dtype=torch.float64, device="cuda",
               generator: torch.Generator = None) -> "SU2InfiniteMPS":
        """A random covariant state: Gaussian coefficients in the
        intertwiner basis, drawn from `generator` (seeded 0 when None) on
        the state's device, then gauge-fixed and projected."""
        from ..states.infinitemps import InfiniteMPS

        D, d = bond.dim, tjp + 1
        Q = torch.as_tensor(build_A_projector(bond, tjp, bond),
                            device=device).to(dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        rdt = torch.empty((), dtype=dtype).real.dtype
        coeffs = torch.randn(Q.shape[1], generator=generator, dtype=rdt,
                             device=device)
        A = (Q @ coeffs.to(dtype)).reshape(1, D, d, D)
        return SU2InfiniteMPS(InfiniteMPS.from_A(A), bond, tjp).project()

    def project(self) -> "SU2InfiniteMPS":
        from ..states.infinitemps import InfiniteMPS

        psi = self.state
        Q, QC = _projectors(self, psi.dtype, psi.device)
        AL = project_A(psi.AL[0], Q)[None]
        AR = project_A(psi.AR[0], Q)[None]
        # renormalize (projection shrinks norms by the roundoff leakage)
        AC = _unit(project_A(psi.AC[0], Q))[None]
        C = _unit(project_C(psi.C[0], QC))[None]
        return dataclasses.replace(self, state=InfiniteMPS(AL, AR, AC, C))


def _su2_vumps_iteration(psi, H, Ws, Q, QC, env_guess, inner_tol, m,
                         restarts, gauge_tol):
    from ..algorithms.derivatives import ac_apply, c_apply
    from ..environments.infinite_ham import hamiltonian_environments
    from ..linalg.lanczos import eigsh_smallest
    from ..states.gauging import regauge_ACC
    from ..states.infinitemps import InfiniteMPS

    envs = hamiltonian_environments(psi, H, tol=1e-12, env_init=env_guess)
    GL, GR, W = envs.GLs[0], envs.GRs[0], Ws[0]
    res_ac = eigsh_smallest(lambda x: ac_apply(GL, W, GR, x), psi.AC[0], m,
                            restarts, inner_tol, reorth="local")
    res_c = eigsh_smallest(lambda x: c_apply(GL, GR, x), psi.C[0], m,
                           restarts, inner_tol, reorth="local")
    AC = _unit(project_A(res_ac.eigenvector, Q))
    C = _unit(project_C(res_c.eigenvector, QC))
    AL = project_A(regauge_ACC(AC, C), Q)
    eps = torch.linalg.vector_norm(AC - torch.einsum("lpm,mr->lpr", AL, C))
    new = InfiniteMPS.from_AL(AL[None], C, tol=gauge_tol)
    new = InfiniteMPS(project_A(new.AL[0], Q)[None],
                      project_A(new.AR[0], Q)[None],
                      project_A(new.AC[0], Q)[None],
                      project_C(new.C[0], QC)[None])
    return new, eps, envs


def find_groundstate_su2_vumps(spsi: SU2InfiniteMPS, H, alg=None):
    """SU(2)-projected VUMPS: the dense VUMPS iteration with the
    intertwiner projector applied to (AC, C) after the local eigensolves
    and to the regauged unit cell, keeping the state exactly SU(2)
    covariant. Returns (SU2InfiniteMPS, envs, eps)."""
    from ..algorithms.vumps import VUMPS
    from ..config import matmul_precision
    from ..environments.finite import stack_W
    from ..environments.infinite_ham import hamiltonian_environments
    from ..utils.dynamictols import updatetol
    from ..utils.sync import to_host

    if alg is None:
        alg = VUMPS()
    psi = spsi.state
    Q, QC = _projectors(spsi, psi.dtype, psi.device)
    eps = 1.0
    env_guess = None
    with matmul_precision():
        Ws = stack_W(H, 1, psi.dtype, psi.device)
        for it in range(1, alg.maxiter + 1):
            psi, eps_dev, env_guess = _su2_vumps_iteration(
                psi, H, Ws, Q, QC, env_guess, updatetol(eps, it),
                alg.krylovdim, alg.eig_maxrestarts, alg.gauge_tol)
            eps = to_host(eps_dev)[0]
            if eps < alg.tol:
                break
        envs = hamiltonian_environments(psi, H, env_init=env_guess)
    return dataclasses.replace(spsi, state=psi), envs, eps


def _multiplicity_matrices(spsi: SU2InfiniteMPS):
    """Per-spin multiplicity matrices M_j[a, b] of the bond matrix C
    (C = sum_j M_j (x) I_{2j+1} in the multiplet-aligned basis)."""
    C = spsi.state.C[0].detach().cpu().resolve_conj().numpy()
    groups = {}
    for (mid, tj, a0, a1) in spsi.bond.multiplet_slices():
        groups.setdefault(tj, []).append((a0, a1))
    mats = {}
    for tj, sls in groups.items():
        n = len(sls)
        M = np.zeros((n, n), C.dtype)
        for ia, (a0, a1) in enumerate(sls):
            for ib, (b0, b1) in enumerate(sls):
                # average the diagonal of the (2j+1)x(2j+1) identity block
                M[ia, ib] = np.trace(C[a0:a1, b0:b1]) / (tj + 1)
        mats[tj] = M
    return mats


def su2_schmidt_spectrum(spsi: SU2InfiniteMPS):
    """{2j: multiplet singular values} of the bond matrix C; each value
    stands for a (2j+1)-fold degenerate dense Schmidt multiplet."""
    return {tj: np.sort(np.linalg.svd(M, compute_uv=False))[::-1]
            for tj, M in _multiplicity_matrices(spsi).items()}


def su2_dense_schmidt_degeneracies(spsi: SU2InfiniteMPS, atol=1e-10):
    """Check that the dense Schmidt spectrum of C splits into exactly
    degenerate (2j+1)-multiplets; returns (ok, dense_spectrum)."""
    C = spsi.state.C[0].detach().cpu().resolve_conj().numpy()
    s_dense = np.sort(np.linalg.svd(C, compute_uv=False))[::-1]
    expected = []
    for tj, vals in su2_schmidt_spectrum(spsi).items():
        for v in vals:
            expected += [v] * (tj + 1)
    expected = np.sort(np.asarray(expected))[::-1]
    ok = (len(expected) == len(s_dense)
          and np.allclose(s_dense, expected, atol=atol))
    return ok, s_dense
