"""The measurement toolbox (counterpart of
mpskit_tpu/algorithms/toolbox.py): entanglement spectra, entropies and
entropy profiles, the Galerkin residual, transfer spectra and correlation
lengths, the energy variance, exact diagonalization, periodic boundary
conditions and the fidelity susceptibility.

A WindowMPS's spectrum and entropy are its window's; its variance is the
two-site tangent variance with the infinite sides as boundaries. The
transfer spectrum of a SymmetricInfiniteMPS resolves charge sectors."""

from __future__ import annotations

import numpy as np
import torch

from ..environments.finite import (
    compute_right_envs, finite_environments, stack_W,
)
from ..environments.infinite_ham import hamiltonian_environments
from ..linalg.arnoldi import spectrum_arnoldi
from ..linalg.gmres import linsolve_cg
from ..linalg.lanczos import eigsh_smallest
from ..operators.lazysum import LazySum, MultipliedOperator
from ..operators.mpo import DenseMPO, MPOHamiltonian
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.quasiparticle import (
    FiniteQP, LeftGaugedQP, null_spaces, qp_to_finitemps,
)
from ..states.windowmps import WindowMPS
from ..symmetry.charges import SymmetricInfiniteMPS
from ..tensors.ops import leftnull, leftorth, rightnull, safe_xlogx
from ..transfermatrix.transfer import (
    mps_transfer_matvec_left, transfer_left_mpo,
)
from .derivatives import ac2_apply, ac_apply
from .excitations import (
    _deflated, _qp_matvec_infinite, _renorm_energies_infinite,
)
from .expval import expectation_value


def _normalized_svdvals(C):
    S = torch.linalg.svdvals(C)
    return S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)


def entanglement_spectrum(psi, bond: int = None):
    """Normalized Schmidt values across `bond`: for a FiniteMPS the bond
    right of site bond-1 (default the middle one), for an InfiniteMPS the
    singular values of C[bond] (default 0); a WindowMPS's are its
    window's."""
    if isinstance(psi, WindowMPS):
        psi = psi.window
    if isinstance(psi, FiniteMPS):
        if bond is None:
            bond = psi.length // 2
        if bond == 0:
            return torch.ones((1,), dtype=torch.float64, device=psi.device)
        return _normalized_svdvals(psi.move_center(bond - 1).bond_matrix())
    if isinstance(psi, InfiniteMPS):
        return _normalized_svdvals(psi.C[(bond or 0) % psi.period])
    raise TypeError(type(psi))


def entropy(psi, bond: int = None):
    """Von Neumann entanglement entropy at a bond (0-dim tensor)."""
    S = entanglement_spectrum(psi, bond)
    return -torch.sum(safe_xlogx(S ** 2))


def entropy_profile(psi: FiniteMPS):
    """The entanglement entropy at every interior bond x = 1..L-1 of a
    finite state, from one left-to-right gauge pass ((L-1,) tensor)."""
    out = []
    p = psi
    for x in range(1, psi.length):
        p = p.move_center(x - 1)
        S = _normalized_svdvals(p.bond_matrix())
        out.append(-torch.sum(safe_xlogx(S ** 2)))
    return torch.stack(out)


def _galerkin_site(GL, W, GR, AC, AL):
    y = ac_apply(GL, W, GR, AC)
    z = torch.einsum("lpm,lpr->mr", AL.conj(), y)
    return torch.linalg.vector_norm(y - torch.einsum("lpm,mr->lpr", AL, z))


def calc_galerkin(psi, H, envs=None):
    """The Galerkin residual ||(1 - P_tangent) H_eff AC|| at the center
    site of a FiniteMPS, the largest over the cell of an InfiniteMPS
    (0-dim tensor)."""
    if isinstance(psi, FiniteMPS):
        if envs is None:
            envs = finite_environments(psi, H)
        c = psi.center
        W = stack_W(H, psi.length, psi.dtype, psi.device)[c]
        AL, _ = leftorth(psi.AC)
        return _galerkin_site(envs.leftenv(c), W, envs.rightenv(c), psi.AC,
                              AL)
    if isinstance(psi, InfiniteMPS):
        if envs is None:
            envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, psi.period, psi.dtype, psi.device)
        return torch.stack([
            _galerkin_site(envs.GLs[i], Ws[i], envs.GRs[i], psi.AC[i],
                           psi.AL[i]) for i in range(psi.period)]).max()
    raise TypeError(type(psi))


# ----------------------------------------------------------------------------
# transfer spectra / correlation lengths
# ----------------------------------------------------------------------------

def _transfer_eigenvalues(psi: InfiniteMPS, num: int, krylovdim: int,
                          M=None):
    """Host complex128 numpy eigenvalues of the unit-cell AL transfer
    operator by descending magnitude: one Arnoldi factorization from
    1 + 0.1 rho_right, as in the JAX package. M (D, D) restricts the
    operator to the masked (charge-flux) subspace, masking its input and
    output; its start vector then gets a random part inside that subspace
    from a generator seeded 0 on psi's device (the JAX package draws
    PRNGKey(0))."""
    L, D = psi.period, psi.D
    v0 = (torch.eye(D, dtype=psi.dtype, device=psi.device)
          + 0.1 * psi.rho_right(L - 1))
    mv = mps_transfer_matvec_left(psi.AL, psi.AL)
    if M is not None:
        generator = torch.Generator(device=psi.device).manual_seed(0)
        rdt = psi.AL.real.dtype if psi.dtype.is_complex else psi.dtype
        v0 = (v0 + torch.randn((D, D), generator=generator, dtype=rdt,
                               device=psi.device).to(psi.dtype)) * M
        base = mv

        def mv(v):
            return base(v * M) * M
    lams, _ = spectrum_arnoldi(mv, v0, m=min(krylovdim, D * D), nev=num)
    return lams


def transfer_spectrum(psi, num: int = 5, krylovdim: int = 40, sector=None):
    """The `num` leading eigenvalues of the unit-cell AL transfer operator
    by descending magnitude (lambda_1 = 1 for a normalized state), a
    complex128 tensor on the state's device.

    sector: the charge flux of the transfer eigenvectors v, charge(bra) -
    charge(ket) = sector on the cell-boundary bond. It needs a
    SymmetricInfiniteMPS, whose bond labels confine the Arnoldi iteration
    to the flux subspace (padded labels excluded); sector=0 is the
    untwisted, charge-diagonal channel."""
    labels = None
    if isinstance(psi, SymmetricInfiniteMPS):
        labels = np.asarray(psi.bond_charges[len(psi.bond_charges) - 1])
        psi = psi.state
    elif not isinstance(psi, InfiniteMPS):
        raise TypeError(type(psi))
    if sector is not None and labels is None:
        raise ValueError(
            "sector-resolved transfer_spectrum needs a SymmetricInfiniteMPS "
            "(static bond charge labels)")
    M = None
    if sector is not None:
        live = labels < 10 ** 6
        flux = (labels[:, None] - labels[None, :] == sector) \
            & live[:, None] & live[None, :]
        M = torch.as_tensor(flux, device=psi.device).to(psi.dtype)
    return torch.from_numpy(_transfer_eigenvalues(
        psi, num, krylovdim, M)).to(psi.device)


def marek_gap(psi, num: int = 5, krylovdim: int = 40):
    """(epsilon, delta) as host floats: epsilon = -log|lambda_2| the
    inverse correlation length per unit cell, delta the gap to the next
    transfer eigenvalue (for extrapolations in D)."""
    lams = _transfer_eigenvalues(psi, max(num, 3), krylovdim)
    mags = np.abs(lams) / np.abs(lams[0])
    return float(-np.log(mags[1])), float(np.log(mags[1]) - np.log(mags[2]))


def correlation_length(psi, krylovdim: int = 40):
    """xi = L / epsilon in sites (a host float)."""
    eps, _ = marek_gap(psi, krylovdim=krylovdim)
    return psi.period / eps


# ----------------------------------------------------------------------------
# variance
# ----------------------------------------------------------------------------

def variance(psi, H, envs=None):
    """<H^2> - <H>^2 of a FiniteMPS, exact through the MPO product H @ H
    (a FiniteQP is embedded as a FiniteMPS first); for an InfiniteMPS the
    two-site tangent variance density summed over the cell, the norm of
    H_eff on each bond's two-site theta projected on both null spaces
    (0-dim real tensors); for a WindowMPS the same two-site tangent
    variance summed over the window's bonds, with the infinite sides'
    fixed points as boundary environments. A LazySum is materialized by
    `sum_materialized()`, a MultipliedOperator by `eval_at(0.0)`."""
    if isinstance(H, LazySum):
        return variance(psi, H.sum_materialized())
    if isinstance(H, MultipliedOperator):
        return variance(psi, H.eval_at(0.0))
    if isinstance(psi, WindowMPS):
        return _variance_window(psi, H)
    if isinstance(psi, FiniteQP):
        return variance(qp_to_finitemps(psi), H)
    if isinstance(psi, FiniteMPS):
        e = expectation_value(psi, H)
        return expectation_value(psi, H @ H).real - e.real ** 2
    if isinstance(psi, InfiniteMPS):
        if envs is None:
            envs = hamiltonian_environments(psi, H)
        L = psi.period
        Ws = stack_W(H, L, psi.dtype, psi.device)
        VLs = null_spaces(psi.AL)
        total = 0.0
        for i in range(L):
            j = (i + 1) % L
            theta = torch.einsum("lpm,mqr->lpqr", psi.AC[i], psi.AR[j])
            h2 = ac2_apply(envs.GLs[i], Ws[i], Ws[j], envs.GRs[j], theta)
            M = torch.einsum("lpk,lpqr,mqr->km", VLs[i].conj(), h2,
                             rightnull(psi.AR[j]).conj())
            total = total + torch.sum(M.abs() ** 2)
        return total
    raise TypeError(type(psi))


def _variance_window(psi, H):
    """The window's two-site tangent variance: on each bond (i, i+1) the
    norm of H_eff theta projected on the left null space of AL_i and the
    right null space of AR_{i+1}, with the center walked along."""
    p = psi.window.move_center(0)
    L = p.length
    Ws = stack_W(H, L, p.dtype, p.device)
    GL, GRL = psi.boundary_envs(H)
    GRs = compute_right_envs(p.ARs, Ws, GRL)
    total = torch.zeros((), dtype=p.AC.real.dtype, device=p.device)
    for i in range(L - 1):
        theta = torch.einsum("lpm,mqr->lpqr", p.AC, p.ARs[i + 1])
        h2 = ac2_apply(GL, Ws[i], Ws[i + 1], GRs[i + 2], theta)
        VL = leftnull(leftorth(p.AC)[0])
        M = torch.einsum("lpk,lpqr,mqr->km", VL.conj(), h2,
                         rightnull(p.ARs[i + 1]).conj())
        total = total + torch.sum(M.abs() ** 2)
        if i < L - 2:
            p = p.move_center(i + 1)
            GL = transfer_left_mpo(GL, Ws[i], p.ALs[i], p.ALs[i])
    return total


# ----------------------------------------------------------------------------
# exact diagonalization
# ----------------------------------------------------------------------------

def exact_diagonalization(H, L: int, num: int = 1, dtype=torch.complex128,
                          tol: float = 1e-12,
                          generator: torch.Generator = None, device="cuda"):
    """The `num` lowest states of H on L sites: restarted Lanczos on the
    middle-site effective Hamiltonian of a FiniteMPS at full bond
    dimension d^min(L/2, 10), each later state deflated against the ones
    found by a shift. Runs on `device` (the card unless the caller asks
    for the CPU); the random start comes from `generator` (None: seeded
    0, on `device`). Returns (energies, a (num,) float64 tensor on the
    device; the states, FiniteMPSs centered at L // 2)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = H.physicaldim
    mid = L // 2
    D = d ** min(mid, L - mid, 10)
    psi = FiniteMPS.random(L, d, D, dtype, device, generator).move_center(mid)
    envs = finite_environments(psi, H)
    W = stack_W(H, L, dtype, device)[mid]
    GL, GR = envs.leftenv(mid), envs.rightenv(mid)
    shift = 10.0 + float(np.linalg.norm(H.W)) * L

    def base(x):
        return ac_apply(GL, W, GR, x)

    energies, states, found = [], [], []
    for _ in range(num):
        res = eigsh_smallest(_deflated(base, tuple(found), shift), psi.AC,
                             m=30, maxrestarts=200, tol=tol)
        energies.append(res.eigenvalue)
        found.append(res.eigenvector)
        states.append(FiniteMPS(psi.ALs, psi.ARs, res.eigenvector, mid))
    return torch.tensor(energies, dtype=torch.float64, device=device), states


# ----------------------------------------------------------------------------
# periodic boundary conditions
# ----------------------------------------------------------------------------

def periodic_boundary_conditions(H: MPOHamiltonian, L: int) -> MPOHamiltonian:
    """H wrapped onto a ring of L sites (a multiple of its period), as an
    open-chain FSM. A term crossing the cut lends its FSM level b to the
    bond between sites L-1 and 0. Wrap channels (b, a, phase) carry the
    rest: the tail continues the FSM from level b at site 0 (a walks
    b -> end), waits on the identity, and the head replays the FSM's
    start (a walks start -> b) to close exactly at level b on the last
    site. Injection and closure are absorbed into the site-0 row and the
    site-(L-1) column, so the open chain's boundary vectors apply. Any
    upper-triangular FSM works: n-site terms, exponential interactions,
    several sites per cell. Host numpy."""
    P = H.period
    if L % P:
        raise ValueError(f"ring length {L} is not a multiple of the unit "
                         f"cell {P}")
    W = H.W
    w, d = H.odim, H.physicaldim
    mids = range(1, w - 1)

    extra = []
    for b in mids:
        extra += [("T", b, a) for a in range(b, w)]      # a = w-1 waits
        extra += [("H", b, a) for a in range(1, b + 1)]  # head levels <= b
    wn = w + len(extra)
    emap = {lbl: w - 1 + i for i, lbl in enumerate(extra)}

    def lvl(a):   # base levels keep their index; the end moves last
        return wn - 1 if a == w - 1 else a

    Ws = np.zeros((L, wn, wn, d, d), W.dtype)
    for i in range(L):
        Wi = W[i % P]
        for a in range(w):
            for b in range(w):
                Ws[i, lvl(a), lvl(b)] += Wi[a, b]
        for b in mids:
            for a in range(b, w - 1):          # tail progress
                for a2 in range(a, w):
                    Ws[i, emap[("T", b, a)], emap[("T", b, a2)]] += Wi[a, a2]
            Ws[i, emap[("T", b, w - 1)], emap[("T", b, w - 1)]] += \
                Wi[w - 1, w - 1]               # waiting on the identity
            for k in range(1, b + 1):          # head start, head progress
                Ws[i, emap[("T", b, w - 1)], emap[("H", b, k)]] += Wi[0, k]
                for k2 in range(k, b + 1):
                    Ws[i, emap[("H", b, k)], emap[("H", b, k2)]] += Wi[k, k2]
    # site 0 injects the tail's first operator from the lent level b
    for b in mids:
        for a2 in range(b, w):
            Ws[0, 0, emap[("T", b, a2)]] += W[0][b, a2]
    # site L-1 closes the head at level b (single-site heads from waiting)
    for b in mids:
        WL = W[(L - 1) % P]
        Ws[L - 1, emap[("T", b, w - 1)], wn - 1] += WL[0, b]
        for k in range(1, b + 1):
            Ws[L - 1, emap[("H", b, k)], wn - 1] += WL[k, b]
    # the wrap channels must not leak through the open boundaries
    for c in emap.values():
        Ws[0, c, :] = 0.0
        Ws[L - 1, :, c] = 0.0
    return MPOHamiltonian.from_dense_W(Ws).remove_orphans()


def periodic_boundary_conditions_densempo(O: DenseMPO, L: int) -> DenseMPO:
    """The ring trace of a DenseMPO as an open-chain host DenseMPO: the cut
    virtual index alpha rides along as a spectator, the middle tensors
    are block-diagonal copies O'[(a, alpha), (b, alpha)] = O[a, b], the
    first site emits alpha and the last closes it."""
    Os = [np.asarray(O.site(i)) for i in range(L)]
    w, d = Os[0].shape[0], Os[0].shape[2]
    first = np.zeros((1, w * w, d, d), Os[0].dtype)
    for al in range(w):
        for b in range(w):
            first[0, b * w + al] = Os[0][al, b]
    mids = []
    for i in range(1, L - 1):
        M = np.zeros((w * w, w * w, d, d), Os[i].dtype)
        for al in range(w):
            for a in range(w):
                for b in range(w):
                    M[a * w + al, b * w + al] = Os[i][a, b]
        mids.append(M)
    last = np.zeros((w * w, 1, d, d), Os[-1].dtype)
    for al in range(w):
        for a in range(w):
            last[a * w + al, 0] = Os[L - 1][a, al]
    return DenseMPO(tuple([first] + mids + [last]))


# ----------------------------------------------------------------------------
# fidelity susceptibility
# ----------------------------------------------------------------------------

def fidelity_susceptibility(psi: InfiniteMPS, H, Vs, envs=None,
                            tol: float = 1e-8):
    """Tangent-space linear response of an infinite ground state: solve
    (H_eff - E) x_a = P_T V_a |psi> for each perturbation V_a by
    conjugate gradient on the p = 0 quasiparticle operator, and return
    the Gram matrix <x_a, x_b> ((n, n) tensor on the state's device)."""
    if not isinstance(psi, InfiniteMPS):
        raise TypeError(f"fidelity_susceptibility takes an InfiniteMPS, not "
                        f"a {type(psi).__name__}")
    if envs is None:
        envs = hamiltonian_environments(psi, H)
    L = psi.period
    Es = _renorm_energies_infinite(psi, H, envs)
    qp0 = LeftGaugedQP.random(psi, momentum=0.0, generator=torch.Generator(
        device=psi.device).manual_seed(0))

    rhss = []
    for V in Vs:
        venvs = hamiltonian_environments(psi, V)
        Wv = stack_W(V, L, psi.dtype, psi.device)
        rhss.append(torch.stack([
            torch.einsum("lpk,lpr->kr", qp0.VLs[i].conj(),
                         ac_apply(venvs.GLs[i], Wv[i], venvs.GRs[i],
                                  psi.AC[i])) for i in range(L)]))

    def hmv(X):
        return _qp_matvec_infinite(X, qp0, H, envs.GLs, envs.GRs, Es, tol)

    # H_eff - E is Hermitian positive semidefinite on the tangent space
    sols = torch.stack([linsolve_cg(hmv, rhs, tol=tol) for rhs in rhss])
    flat = sols.reshape(len(Vs), -1)
    return flat.conj() @ flat.mT
