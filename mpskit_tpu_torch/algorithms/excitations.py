"""Quasiparticle excitations (counterpart of
mpskit_tpu/algorithms/excitations.py: the infinite and finite
QuasiparticleAnsatz, the momentum-batched dispersion and the
`excitations` dispatcher).

The QP effective Hamiltonian per site is three ac_apply-shaped
contractions: B in the center against (GL, GR), B to the left against
(lB, GR) with the ground AR as ket, and B to the right against (GL, rB)
with the ground AL as ket, projected back onto the null-space basis.
Every Krylov matvec rebuilds the momentum-phased B-environments, so an
infinite matvec runs one cyclic GMRES solve per non-zero diagonal level
of the MPO on each side, each with one host read per Arnoldi step. The
deflation overlaps of `_solve_qp` stay on the device.

The JAX package vmaps the dispersion over momenta; here
`excitations_infinite_batched` is `excitations_infinite`'s host loop over
the momenta, every solve from the same seeded start vector unless a
generator is given. A transfer MPO (DenseMPO) goes to
`excitations_statmech.excitations_boundary`. A charge sector (`sector=`)
restricts the search on a SymmetricFiniteMPS (in B-space) or a
SymmetricInfiniteMPS (in X-space); a ReducedMPO goes to the SU(2)
reduced quasiparticles (`symmetry/su2_reduced_qp.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Defaults, matmul_precision
from ..environments.finite import (
    compute_left_envs, compute_right_envs, left_boundary, right_boundary,
    stack_W,
)
from ..environments.infinite_ham import hamiltonian_environments
from ..environments.qp import (
    qp_left_envs, qp_left_envs_finite, qp_left_envs_finite_B, qp_right_envs,
    qp_right_envs_finite, qp_right_envs_finite_B,
)
from ..linalg.arnoldi import smallest_eigs_arnoldi
from ..linalg.lanczos import eigsh_smallest
from ..operators.mpo import DenseMPO, MPOHamiltonian
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.quasiparticle import FiniteQP, LeftGaugedQP, _randn
from ..symmetry.charges import SymmetricFiniteMPS, SymmetricInfiniteMPS
from ..symmetry.su2_reduced import ReducedMPO
from ..utils.sync import to_host
from .derivatives import ac_apply

@dataclasses.dataclass(frozen=True)
class QuasiparticleAnsatz:
    """Same fields and defaults as the JAX package's. solver: "lanczos"
    for an (effectively) Hermitian H_eff, "arnoldi" for the
    smallest-real-part restarted Arnoldi."""

    tol: float = 1e-8
    krylovdim: int = Defaults.krylovdim
    maxrestarts: int = 40
    env_tol: float = 1e-10
    verbosity: int = Defaults.verbosity
    solver: str = "lanczos"


def _qp_eigsolve(mv, x0, alg: QuasiparticleAnsatz):
    """The QP eigensolve that alg.solver names."""
    if alg.solver == "arnoldi":
        return smallest_eigs_arnoldi(mv, x0, alg.krylovdim, alg.maxrestarts,
                                     alg.tol)
    return eigsh_smallest(mv, x0, alg.krylovdim, alg.maxrestarts, alg.tol)


def _flux_projector(VLs, fmask):
    """Orthogonal projector on X-space onto charge-flux-`sector` B tensors:
    B = VL X is masked by the flux mask (c_left + q_phys == c_right +
    sector) and pulled back through the null-space isometry. The ground
    tensors are exactly flux-0 (masked), so the flux decomposition commutes
    with VL VL^dag and this is the exact projector onto the sector part of
    the tangent space. Needs a full-rank AL (a converged
    SymmetricInfiniteMPS with all-live labels)."""
    fm = fmask.to(VLs.dtype)

    def proj(Xs):
        B = torch.einsum("ilpk,ikr->ilpr", VLs, Xs) * fm
        return torch.einsum("ilpk,ilpr->ikr", VLs.conj(), B)
    return proj


def _b_flux_projector(ALs, fmask):
    """Orthogonal projector on B-space: the flux mask composed with the left
    tangent gauge condition AL^dag B = 0. It works on the (L, D, d, D)
    excitation tensors directly: for symmetric gauges with exact zero
    columns (dead slots, unused sectors) a dense complete-QR null basis
    fills those columns with arbitrary vectors and misses tangent
    directions, while this form is exact whatever the rank. The two
    factors commute because AL is exactly masked."""
    fm = fmask.to(ALs.dtype)

    def proj(Bs):
        Bs = Bs * fm
        z = torch.einsum("ilpm,ilpr->imr", ALs.conj(), Bs)
        return Bs - torch.einsum("ilpm,imr->ilpr", ALs, z)
    return proj


def _generator(generator, device):
    """The caller's generator, or a seeded one on `device` so that a run
    repeats (the JAX package's default PRNGKey(0))."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def _deflated(base_mv, found, shift):
    """base_mv + shift * sum_k |x_k><x_k| over the found eigenvectors."""
    def mv(X):
        y = base_mv(X)
        for xf in found:
            y = y + shift * torch.vdot(xf.reshape(-1), X.reshape(-1)) * xf
        return y
    return mv


def _stack_energies(es):
    """Host eigenvalues as a CPU tensor, float64 (complex128 from the
    Arnoldi solver on a complex operator)."""
    return torch.from_numpy(np.array(es))


# ----------------------------------------------------------------------------
# infinite QP
# ----------------------------------------------------------------------------

def _qp_matvec_infinite(Xs, qp_template: LeftGaugedQP, H, GLs, GRs, Es,
                        env_tol):
    """H_eff - E applied to the stacked X blocks."""
    qp = dataclasses.replace(qp_template, Xs=Xs)
    L = qp.period
    Ws = stack_W(H, L, qp.left_gs.dtype, qp.left_gs.device)
    Bs = qp.bs()
    lBs = qp_left_envs(qp, GLs, H, tol=env_tol)
    rBs = qp_right_envs(qp, GRs, H, tol=env_tol)
    AL, AR = qp.left_gs.AL, qp.right_gs.AR
    out = []
    for i in range(L):
        y = ac_apply(GLs[i], Ws[i], GRs[i], Bs[i])
        y = y + ac_apply(lBs[i], Ws[i], GRs[i], AR[i])
        y = y + ac_apply(GLs[i], Ws[i], rBs[i], AL[i])
        y = y - Es[i] * Bs[i]
        out.append(torch.einsum("lpk,lpr->kr", qp.VLs[i].conj(), y))
    return torch.stack(out)


def _renorm_energies_infinite(psi: InfiniteMPS, H, envs):
    """<AC_i| H_AC |AC_i> / <AC_i|AC_i> per site, an (L,) real tensor."""
    Ws = stack_W(H, psi.period, psi.dtype, psi.device)
    es = []
    for i in range(psi.period):
        AC = psi.AC[i].reshape(-1)
        y = ac_apply(envs.GLs[i], Ws[i], envs.GRs[i], psi.AC[i]).reshape(-1)
        es.append(torch.vdot(AC, y).real / torch.vdot(AC, AC).real)
    return torch.stack(es)


def _solve_qp(qp0, H, GLs, GRs, Es, alg, num, proj=None, comp_shift=None):
    """Sequential deflation: the `num` smallest eigenpairs of H_eff, each
    found one shifted by 100 above the window. `proj`, an X-space
    projector (a charge sector), is applied around every matvec, and the
    sector's complement is lifted by `comp_shift`: under P H P it has
    eigenvalue 0, below every gap, and rounding leaks the Krylov space
    into it (the JAX package does not lift it and returns ~1e-20 for the
    Z_2 gap of the parity TFIM at D=6)."""
    es, xs = [], []

    def base_mv(X):
        if proj is None:
            return _qp_matvec_infinite(X, qp0, H, GLs, GRs, Es, alg.env_tol)
        PX = proj(X)
        return (proj(_qp_matvec_infinite(PX, qp0, H, GLs, GRs, Es,
                                         alg.env_tol))
                + comp_shift * (X - PX))

    for _ in range(num):
        res = _qp_eigsolve(_deflated(base_mv, tuple(xs), 100.0), qp0.Xs, alg)
        es.append(res.eigenvalue)
        xs.append(res.eigenvector)
    return es, xs


def excitations_infinite(H, alg: QuasiparticleAnsatz, momenta, psi,
                         envs=None, num: int = 1, generator=None,
                         right_gs=None, right_envs=None, sector=None):
    """QP excitation energies for one or several momenta. Returns
    (energies, qps): energies a (n_momenta, num) CPU tensor, qps one list
    of LeftGaugedQP per momentum. `generator` draws the start vectors (on
    psi's device); without one every momentum starts from the same seeded
    vector, as the JAX package's one key does.

    sector: the charge of the excitation; it needs a SymmetricInfiniteMPS,
    and the search is restricted to flux-`sector` B tensors
    (`_flux_projector`)."""
    fmask = None
    if isinstance(psi, SymmetricInfiniteMPS):
        if sector is not None:
            fmask = torch.as_tensor(psi.flux_masks(sector),
                                    device=psi.state.device)
        psi = psi.state
    elif sector is not None:
        raise TypeError("sector-resolved excitations need a "
                        "SymmetricInfiniteMPS (abelian bond charge labels)")
    elif not isinstance(psi, InfiniteMPS):
        raise TypeError(type(psi))
    with matmul_precision():
        if envs is None:
            envs = hamiltonian_environments(psi, H)
        if right_gs is not None and right_envs is None:
            right_envs = hamiltonian_environments(right_gs, H)
        if np.isscalar(momenta):
            momenta = [momenta]
        GLs = envs.GLs
        GRs = (envs if right_envs is None else right_envs).GRs
        Es = _renorm_energies_infinite(psi, H, envs)
        if right_gs is not None:
            Es = (Es + _renorm_energies_infinite(right_gs, H, right_envs)) / 2
        energies, qps = [], []
        for p in momenta:
            qp0 = LeftGaugedQP.random(psi, momentum=float(p),
                                      right_gs=right_gs,
                                      generator=_generator(generator,
                                                           psi.device))
            proj = comp_shift = None
            if fmask is not None:
                proj = _flux_projector(qp0.VLs, fmask)
                X0 = proj(qp0.Xs)
                n0, e_max = to_host(torch.linalg.vector_norm(X0),
                                    Es.abs().max())
                if not n0 > 1e-12:
                    raise ValueError(f"sector {sector} is unreachable from "
                                     "the state's bond labels")
                qp0 = dataclasses.replace(qp0, Xs=X0 / n0)
                comp_shift = 1e3 * (1.0 + e_max)
            es, xs = _solve_qp(qp0, H, GLs, GRs, Es, alg, num, proj,
                               comp_shift)
            energies.append(es)
            qps.append([dataclasses.replace(qp0, Xs=x) for x in xs])
    return _stack_energies(energies), qps


def excitations_infinite_batched(H, alg: QuasiparticleAnsatz, momenta, psi,
                                 envs=None, generator=None):
    """The dispersion over several momenta, the lowest energy at each
    (the JAX package vmaps these solves; here `excitations_infinite` loops
    over them). Needs a complex dtype. Returns energies (n_momenta,), a
    CPU tensor."""
    assert psi.dtype.is_complex, "momentum batching requires a complex dtype"
    return excitations_infinite(H, alg, momenta, psi, envs=envs,
                                generator=generator)[0][:, 0]


# ----------------------------------------------------------------------------
# finite QP
# ----------------------------------------------------------------------------

def _qp_matvec_finite(Xs, qp_template: FiniteQP, Ws, GLs, GRs, E0):
    qp = dataclasses.replace(qp_template, Xs=Xs)
    Bs = qp.bs()
    lBs = qp_left_envs_finite(qp, GLs, Ws)
    rBs = qp_right_envs_finite(qp, GRs, Ws)
    mask = qp.mask.to(Xs.dtype)
    out = []
    for i in range(qp.length):
        y = ac_apply(GLs[i], Ws[i], GRs[i + 1], Bs[i])
        y = y + ac_apply(lBs[i], Ws[i], GRs[i + 1], qp.ARs[i])
        y = y + ac_apply(GLs[i], Ws[i], rBs[i], qp.ALs[i])
        y = y - E0 * Bs[i]
        out.append(torch.einsum("lpk,lpr->kr", qp.VLs[i].conj(), y) * mask[i])
    return torch.stack(out)


def excitations_finite(H, alg: QuasiparticleAnsatz, psi: FiniteMPS,
                       envs=None, num: int = 1, generator=None, sector=None):
    """Finite-chain QP excitations. Returns (energies (num,) CPU tensor,
    list of FiniteQP). `envs` is accepted for signature parity: the
    environments are rebuilt in the full gauges, as in the JAX package.

    sector: the charge of the excitation relative to the ground state; it
    needs a SymmetricFiniteMPS, and the search runs in B-space
    (`_excitations_finite_B`), returning `_BQP`s."""
    fmask = cmask = None
    if isinstance(psi, SymmetricFiniteMPS):
        if sector is not None:
            dev = psi.state.device
            fmask = torch.as_tensor(psi.flux_masks(sector), device=dev)
            cmask = torch.as_tensor(psi.masks, device=dev)
        psi = psi.state
    elif sector is not None:
        raise TypeError("sector-resolved excitations need a "
                        "SymmetricFiniteMPS (abelian bond charge labels)")
    L, D = psi.length, psi.D
    gen = _generator(generator, psi.device)
    with matmul_precision():
        qp0 = FiniteQP.random(psi, generator=gen)
        if cmask is not None:
            # the full gauges come from unmasked QRs whose completions put
            # junk in the charge-forbidden columns: re-mask them (the
            # represented state is unchanged, and the projector and the
            # environments then see exactly charge-pure tensors)
            mk = cmask.to(psi.dtype)
            qp0 = dataclasses.replace(qp0, ALs=qp0.ALs * mk,
                                      ARs=qp0.ARs * mk)
        Ws = stack_W(H, L, psi.dtype, psi.device)
        w = Ws.shape[1]
        GLs = compute_left_envs(qp0.ALs, Ws,
                                left_boundary(w, D, psi.dtype, psi.device))
        GRs = compute_right_envs(qp0.ARs, Ws,
                                 right_boundary(w, D, psi.dtype, psi.device))
        # the ground energy from the full left environment
        E0 = GLs[L][w - 1, 0, 0].real
        E0_host = to_host(E0)[0]
        shift = 100.0 * max(1.0, abs(E0_host))
        if fmask is not None:
            es, qps = _excitations_finite_B(alg, qp0, Ws, GLs, GRs, E0,
                                            E0_host, fmask, num, gen, shift)
            return _stack_energies(es), qps

        def base_mv(X):
            return _qp_matvec_finite(X, qp0, Ws, GLs, GRs, E0)

        es, xs = [], []
        for _ in range(num):
            res = _qp_eigsolve(_deflated(base_mv, tuple(xs), shift), qp0.Xs,
                               alg)
            es.append(res.eigenvalue)
            xs.append(res.eigenvector)
    return _stack_energies(es), [dataclasses.replace(qp0, Xs=x) for x in xs]


@dataclasses.dataclass(frozen=True)
class _BQP:
    """A charged finite quasiparticle carrying its B tensors explicitly
    (the B-space counterpart of FiniteQP; `bs()` returns them)."""

    Bs: torch.Tensor    # (L, D, d, D)
    ALs: torch.Tensor
    ARs: torch.Tensor

    @property
    def length(self):
        return self.Bs.shape[0]

    def bs(self):
        return self.Bs


def _excitations_finite_B(alg, qp0, Ws, GLs, GRs, E0, E0_host, fmask, num,
                          generator, shift):
    """The charged-sector finite QP solve in B-space: the VL null basis of
    a rank-deficient symmetric gauge misses tangent directions, so the
    search runs on raw B tensors under the combined flux and tangent-gauge
    projector, with the sector's complement lifted far above the physical
    window so that Lanczos never drifts into it. Returns (host
    eigenvalues, list of _BQP)."""
    L, D, d = qp0.ALs.shape[0], qp0.ALs.shape[1], qp0.ALs.shape[2]
    Pi = _b_flux_projector(qp0.ALs, fmask)
    comp_shift = 1e3 * (1.0 + abs(E0_host))

    def base_mv(Bs):
        Bp = Pi(Bs)
        lBs = qp_left_envs_finite_B(Bp, qp0.ALs, qp0.ARs, GLs, Ws)
        rBs = qp_right_envs_finite_B(Bp, qp0.ALs, qp0.ARs, GRs, Ws)
        y = torch.stack([
            ac_apply(GLs[i], Ws[i], GRs[i + 1], Bp[i])
            + ac_apply(lBs[i], Ws[i], GRs[i + 1], qp0.ARs[i])
            + ac_apply(GLs[i], Ws[i], rBs[i], qp0.ALs[i])
            - E0 * Bp[i] for i in range(L)])
        # the sector's complement has raw eigenvalue 0 under Pi H Pi, below
        # any gap: lift it
        return Pi(y) + comp_shift * (Bs - Bp)

    B0 = Pi(_randn((L, D, d, D), qp0.ALs.dtype, qp0.ALs.device, generator))
    n0 = to_host(torch.linalg.vector_norm(B0))[0]
    if not n0 > 1e-12:
        raise ValueError("the sector is unreachable from the state's bond "
                         "labels")
    B0 = B0 / n0
    es, bs = [], []
    for _ in range(num):
        res = _qp_eigsolve(_deflated(base_mv, tuple(bs), shift), B0, alg)
        es.append(res.eigenvalue)
        b = Pi(res.eigenvector)
        bs.append(b / torch.linalg.vector_norm(b))
    return es, [_BQP(b, qp0.ALs, qp0.ARs) for b in bs]


# ----------------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------------

def _excitations_reduced(H, alg, args, kwargs):
    """excitations(ReducedMPO, QuasiparticleAnsatz(), momenta,
    SU2ReducedState, num=, generator=, sector=2j): the SU(2)-reduced
    quasiparticles in the spin sector/2 multiplet (default 2, the adjoint),
    as in the JAX package."""
    from ..symmetry.su2_reduced_qp import excitations_su2_reduced

    if not isinstance(alg, QuasiparticleAnsatz):
        raise TypeError(
            "ReducedMPO excitations support only QuasiparticleAnsatz, "
            f"got {type(alg).__name__}")
    momenta, psi = args[0], args[1]
    kwargs = dict(kwargs)
    tke = kwargs.pop("sector", 2)
    unknown = set(kwargs) - {"num", "generator"}
    if unknown:
        raise TypeError(
            f"excitations(ReducedMPO, ...): unsupported keyword(s) "
            f"{sorted(unknown)}; the reduced path accepts num/generator/"
            "sector")
    return excitations_su2_reduced(
        H, psi, momenta, tke=tke, tol=alg.tol, krylovdim=alg.krylovdim,
        maxrestarts=alg.maxrestarts, env_tol=alg.env_tol, **kwargs)


def excitations(H, alg, *args, **kwargs):
    """excitations(H, QuasiparticleAnsatz(), momenta, psi_inf, ...),
    excitations(H, QuasiparticleAnsatz(), psi_finite, ...),
    excitations(H, FiniteExcited(), psi_finite, ...), or for a transfer
    MPO excitations(O_dense, QuasiparticleAnsatz(), momenta, psi_boundary,
    envs=, generator=, krylovdim=, tol=) (`excitations_boundary`: the
    dominant eigenvalues relative to the boundary's, a CPU tensor), or for
    a ReducedMPO excitations(H, QuasiparticleAnsatz(), momenta,
    SU2ReducedState, num=, sector=2j) (`excitations_su2_reduced`)."""
    from .dmrgexcitation import FiniteExcited, excitations_dmrg

    if isinstance(H, DenseMPO) and isinstance(alg, QuasiparticleAnsatz):
        from .excitations_statmech import excitations_boundary

        return excitations_boundary(
            H, args[0], args[1],
            **{k: v for k, v in kwargs.items()
               if k in ("envs", "generator", "krylovdim", "tol")})
    if isinstance(H, DenseMPO):
        raise TypeError("excitations of a transfer MPO (DenseMPO) take "
                        f"QuasiparticleAnsatz, got {type(alg).__name__}")
    if isinstance(H, ReducedMPO):
        return _excitations_reduced(H, alg, args, kwargs)
    if not isinstance(H, MPOHamiltonian):
        raise TypeError(f"excitations of a {type(H).__name__}: H must be an "
                        "MPOHamiltonian, a ReducedMPO or a DenseMPO")
    if isinstance(alg, QuasiparticleAnsatz):
        if isinstance(args[0], (FiniteMPS, SymmetricFiniteMPS)):
            return excitations_finite(H, alg, *args, **kwargs)
        if len(args) < 2 and "psi" not in kwargs:
            raise TypeError(
                f"excitations on a {type(args[0]).__name__}: a finite state "
                "comes first, an infinite one after the momenta")
        return excitations_infinite(H, alg, *args, **kwargs)
    if isinstance(alg, FiniteExcited):
        return excitations_dmrg(H, alg, *args, **kwargs)
    raise TypeError(type(alg))
