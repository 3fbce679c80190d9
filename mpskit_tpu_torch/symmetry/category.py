"""General fusion-category layer of the PyTorch port (a copy of
mpskit_tpu/symmetry/category.py: host numpy data, no device code) — the
counterpart of TensorKit's sector/fusion-tree machinery for arbitrary (multiplicity-free,
unitary) fusion categories (reference: TensorKit sectors used throughout,
e.g. `Vect[FibonacciAnyon]` in examples/classic2d/1.hard-hexagon/main.jl:7-8
and `Rep[SU₂]` in test/setup.jl:46-65).

This module abstracts what `symmetry/fibonacci.py` hand-codes for the
Fibonacci category into data-driven machinery that works for any
multiplicity-free unitary fusion category:

  * `FusionCategory` — static sector data: quantum dimensions, fusion
    multiplicities N[a,b,c] in {0,1}, and F-symbols
    [F^{abc}_d]_{e,f} (the recoupling (a⊗b)⊗c → a⊗(b⊗c)), with a
    numerical pentagon-equation validator.
  * masked-dense anyonic MPS support: `bond_labels` (split a dense bond
    by quantum-dimension proportions), `chain_masks` (A/C masks in the
    fusion-path basis: physical index = height after the site),
    `quantum_schmidt`/`quantum_entropy` (quantum-trace entanglement,
    S = -Σ_a d_a Σ_i p_{a,i} log p_{a,i}).
  * anyonic chains: the local projector onto fusion channel c of two
    neighboring chain anyons in the height basis (Feiguin et al.,
    PRL 98, 160409 (2007) "golden chain" construction),
        (P^{(c)})^{a, d}_{h, h'} = [F^{a x x}_d]_{h c} [F^{a x x}_d]*_{h' c},
    a dense path-basis Hamiltonian for ED oracles, and an
    `MPOHamiltonian` over the unconstrained height tensor basis (the
    valid-path sector is an invariant subspace — F-symbol elements
    vanish on inadmissible heights — so DMRG/VUMPS run unmodified).

All contractions remain dense device work; symmetry enters as static masks
and as the F-data used to *construct* operators, exactly like the
Fibonacci backend. The concrete categories provided: `fibonacci_category`
(golden chain / hard-hexagon), `ising_category` (Ising anyons σ, ψ),
`zn_category` (abelian degenerate case, a consistency anchor against
symmetry/charges.py).
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FusionCategory:
    """Multiplicity-free unitary fusion category, as plain static data.

    F convention: ``F[a, b, c, d]`` is the matrix of the recoupling
    (a⊗b)⊗c → a⊗(b⊗c) at total charge d, with row index e ∈ a⊗b (the
    left-associated intermediate) and column index f ∈ b⊗c (the
    right-associated intermediate):

        |(ab)e, c; d> = Σ_f  [F^{abc}_d]_{e f} |a, (bc)f; d>

    Entries for inadmissible (a,b,c,d,e,f) are zero.
    """

    name: str
    sectors: Tuple[str, ...]
    qdim: np.ndarray            # (n,)
    N: np.ndarray               # (n, n, n) in {0,1}: c in a (x) b
    F: np.ndarray               # (n, n, n, n, n, n): [F^{abc}_d]_{e,f}
    dual: Tuple[int, ...]       # a -> a-bar

    @property
    def n(self) -> int:
        return len(self.sectors)

    def fuse(self, a: int, b: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.where(self.N[a, b] > 0)[0])

    @property
    def total_qdim(self) -> float:
        """D = sqrt(Σ_a d_a²)."""
        return float(np.sqrt(np.sum(self.qdim ** 2)))

    # -- structural validators (used by tests; cheap, host-side) ---------

    def check_fusion(self) -> None:
        """Associativity of fusion multiplicities and unit axioms."""
        N = self.N
        # unit: sector 0 is the monoidal unit
        assert np.array_equal(N[0], np.eye(self.n, dtype=N.dtype))
        assert np.array_equal(N[:, 0], np.eye(self.n, dtype=N.dtype))
        # associativity: Σ_e N[a,b,e] N[e,c,d] == Σ_f N[b,c,f] N[a,f,d]
        lhs = np.einsum("abe,ecd->abcd", N, N)
        rhs = np.einsum("bcf,afd->abcd", N, N)
        assert np.array_equal(lhs, rhs), "fusion not associative"
        # duals: 0 in a (x) a-bar
        for a in range(self.n):
            assert N[a, self.dual[a], 0] == 1

    def check_unitarity(self, atol: float = 1e-12) -> None:
        """Every F-matrix block [F^{abc}_d] is unitary on its admissible
        support (the fusion-tree basis change is an isometry)."""
        for a, b, c, d in product(range(self.n), repeat=4):
            es = [e for e in self.fuse(a, b) if self.N[e, c, d]]
            fs = [f for f in self.fuse(b, c) if self.N[a, f, d]]
            if not es:
                continue
            M = self.F[a, b, c, d][np.ix_(es, fs)]
            assert M.shape[0] == M.shape[1], (a, b, c, d)
            err = np.max(np.abs(M @ M.conj().T - np.eye(len(es))))
            assert err < atol, (a, b, c, d, err)

    def check_pentagon(self, atol: float = 1e-12) -> None:
        """Pentagon equation (multiplicity-free form, Bonderson thesis
        eq. 2.68):

          [F^{fcd}_e]_{gl} [F^{abl}_e]_{fk}
              = Σ_h [F^{abc}_g]_{fh} [F^{ahd}_e]_{gk} [F^{bcd}_k]_{hl}
        """
        n, F, N = self.n, self.F, self.N

        def adm(a, b, c):
            return N[a, b, c] > 0

        for a, b, c, d, e in product(range(n), repeat=5):
            for f in self.fuse(a, b):
                for g in self.fuse(f, c):
                    if not adm(g, d, e):
                        continue
                    for l in self.fuse(c, d):
                        if not adm(f, l, e):
                            continue
                        for k in self.fuse(b, l):
                            if not adm(a, k, e):
                                continue
                            lhs = F[f, c, d, e][g, l] * F[a, b, l, e][f, k]
                            rhs = sum(
                                F[a, b, c, g][f, h] * F[a, h, d, e][g, k]
                                * F[b, c, d, k][h, l]
                                for h in range(n))
                            assert abs(lhs - rhs) < atol, (
                                (a, b, c, d, e, f, g, k, l), lhs, rhs)

    # -- anyonic chain building blocks -----------------------------------

    def chain_projector(self, x: int, channel: int) -> np.ndarray:
        """The local projector onto fusion channel `channel` of two
        neighboring chain anyons x, in the height basis (Feiguin et al.):

            P[a, d, h, h'] = [F^{a x x}_d]_{h c} [F^{a x x}_d]*_{h' c}

        acting on height h_i (→ h'_i) with fixed neighbors a = h_{i-1},
        d = h_{i+1}. Elements vanish off the admissible-path support, so
        the valid-path subspace is invariant.
        """
        Fx = self.F[:, x, x, :]          # (a, d, e, f)
        col = Fx[:, :, :, channel]       # (a, d, h)
        return np.einsum("adh,adk->adhk", col, col.conj())

    def chain_local_term(self, x: int, channel: int) -> np.ndarray:
        """The 3-site local operator O[(p1 p2 p3), (p1' p2' p3')] over the
        *unconstrained* height tensor basis: diagonal in the outer heights,
        `chain_projector` on the middle one. Feed to
        `MPOHamiltonian.from_local`."""
        n = self.n
        P = self.chain_projector(x, channel)
        O = np.einsum("aA,adhk,dD->ahdAkD", np.eye(n), P, np.eye(n))
        return O.reshape(n ** 3, n ** 3).reshape((n,) * 6)

    def path_basis(self, x: int, L: int, left: int | None = 0,
                   right: int | None = None) -> np.ndarray:
        """All admissible height sequences (h_1 .. h_L) of a chain of L
        anyons x: h_1 ∈ left ⊗ x if `left` is fixed (default: vacuum),
        otherwise any sector admitting some predecessor; consecutive
        heights satisfy h_{i+1} ∈ h_i ⊗ x; optionally h_L == right.
        Returns an (n_paths, L) int array."""
        if left is None:
            starts = [h for h in range(self.n)
                      if any(self.N[a, x, h] for a in range(self.n))]
        else:
            starts = list(self.fuse(left, x))
        paths = [[h] for h in starts]
        for _ in range(L - 1):
            paths = [p + [h] for p in paths for h in self.fuse(p[-1], x)]
        if right is not None:
            paths = [p for p in paths if p[-1] == right]
        return np.asarray(paths, int).reshape(-1, L)

    def chain_hamiltonian_dense(self, x: int, channel: int, L: int,
                                coupling: float = -1.0,
                                left: int | None = 0,
                                right: int | None = None) -> tuple:
        """Dense ED oracle: H = coupling · Σ_{i=2}^{L-1} P^{(channel)}_i in
        the admissible path basis (windows fully inside h_1..h_L, matching
        `MPOHamiltonian.from_local`'s finite-chain window convention).
        Returns (H, paths)."""
        paths = self.path_basis(x, L, left=left, right=right)
        npz = len(paths)
        index = {tuple(p): i for i, p in enumerate(map(tuple, paths))}
        P = self.chain_projector(x, channel)
        H = np.zeros((npz, npz), self.F.dtype)
        for i, p in enumerate(map(list, paths)):
            for site in range(1, L - 1):
                a, h, d = p[site - 1], p[site], p[site + 1]
                for hp in range(self.n):
                    amp = P[a, d, hp, h]
                    if amp == 0.0:
                        continue
                    q = list(p)
                    q[site] = hp
                    j = index.get(tuple(q))
                    if j is not None:
                        H[j, i] += coupling * amp
        return H, paths

    def chain_mpo(self, x: int, channel: int, coupling: float = -1.0,
                  period: int = 1, dtype=np.float64):
        """`MPOHamiltonian` of the anyonic chain over the height tensor
        basis (physical dimension = number of sectors): H = coupling ·
        Σ_i P^{(channel)}_i. The admissible-path sector is invariant; with
        coupling < 0 the ground state lies inside it."""
        from ..operators.mpo import MPOHamiltonian

        O = coupling * self.chain_local_term(x, channel)
        return MPOHamiltonian.from_local(O.astype(dtype), period=period)


@dataclasses.dataclass(frozen=True)
class BraidedCategory(FusionCategory):
    """Fusion category + braiding: R-symbols ``R[a, b, c]`` = the phase
    picked up when exchanging a and b fused to c (multiplicity-free, so
    each R^{ab}_c is a scalar; zero on inadmissible triples).

    The reference gets this data from TensorKit sector types
    (`FibonacciAnyon`, `IsingAnyon`, `SU2Irrep` braiding, used through the
    braiding tensor τ in @plansor contractions and `twist`); here it is
    plain static data with numerical validators, feeding the topological
    invariants (twists, S-matrix, chiral central charge) that classify the
    anyon content of a chain.
    """

    R: np.ndarray = None        # (n, n, n) complex: R^{ab}_c

    # -- validators -------------------------------------------------------

    def check_hexagon(self, atol: float = 1e-12) -> None:
        """Both hexagon equations (multiplicity-free form, Bonderson
        thesis eq. 2.87 and its R→R⁻¹ mirror):

          R^{ca}_e [F^{acb}_d]_{eg} R^{cb}_g
              = Σ_f [F^{cab}_d]_{ef} R^{cf}_d [F^{abc}_d]_{fg}

          (R^{ac}_e)⁻¹ [F^{acb}_d]_{eg} (R^{bc}_g)⁻¹
              = Σ_f [F^{cab}_d]_{ef} (R^{fc}_d)⁻¹ [F^{abc}_d]_{fg}
        """
        n, F, R, N = self.n, self.F, self.R, self.N
        for a, b, c, d in product(range(n), repeat=4):
            for e in self.fuse(c, a):
                if not N[e, b, d]:
                    continue
                for g in self.fuse(c, b):
                    if not N[a, g, d]:
                        continue
                    lhs1 = R[c, a, e] * F[a, c, b, d][e, g] * R[c, b, g]
                    lhs2 = (F[a, c, b, d][e, g]
                            / (R[a, c, e] * R[b, c, g]))
                    rhs1 = rhs2 = 0.0
                    for f in self.fuse(a, b):
                        if not N[c, f, d]:
                            continue
                        pre = F[c, a, b, d][e, f] * F[a, b, c, d][f, g]
                        rhs1 += pre * R[c, f, d]
                        rhs2 += pre / R[f, c, d]
                    assert abs(lhs1 - rhs1) < atol, (
                        "hexagon", (a, b, c, d, e, g), lhs1, rhs1)
                    assert abs(lhs2 - rhs2) < atol, (
                        "inverse hexagon", (a, b, c, d, e, g), lhs2, rhs2)

    def check_ribbon(self, atol: float = 1e-12) -> None:
        """Monodromy = twists: R^{ba}_c R^{ab}_c = θ_c / (θ_a θ_b)."""
        th = self.twists()
        for a, b in product(range(self.n), repeat=2):
            for c in self.fuse(a, b):
                lhs = self.R[b, a, c] * self.R[a, b, c]
                rhs = th[c] / (th[a] * th[b])
                assert abs(lhs - rhs) < atol, ((a, b, c), lhs, rhs)

    # -- topological invariants -------------------------------------------

    def twists(self) -> np.ndarray:
        """Topological spins θ_a = e^{2πi h_a} = (1/d_a) Σ_c d_c R^{aa}_c."""
        return np.array([
            sum(self.qdim[c] * self.R[a, a, c] for c in self.fuse(a, a))
            / self.qdim[a] for a in range(self.n)])

    def s_matrix(self) -> np.ndarray:
        """Modular S: S_ab = (1/D) Σ_c N[ā,b,c] d_c θ_c/(θ_a θ_b).
        Unitary iff the braiding is non-degenerate (modular category)."""
        th = self.twists()
        S = np.zeros((self.n, self.n), complex)
        for a, b in product(range(self.n), repeat=2):
            for c in self.fuse(self.dual[a], b):
                S[a, b] += self.qdim[c] * th[c] / (th[a] * th[b])
        return S / self.total_qdim

    def is_modular(self, atol: float = 1e-10) -> bool:
        S = self.s_matrix()
        return bool(np.max(np.abs(S @ S.conj().T - np.eye(self.n))) < atol)

    def central_charge(self) -> float:
        """Chiral central charge c mod 8 from the Gauss sum
        Σ_a d_a² θ_a = D e^{2πi c/8}."""
        gauss = np.sum(self.qdim ** 2 * self.twists())
        return float(np.angle(gauss) * 4 / np.pi) % 8.0

    def frobenius_schur(self, a: int) -> int:
        """FS indicator ϰ_a = d_a [F^{a ā a}_a]_{0,0} ∈ {+1, −1} for
        self-dual a (distinguishes e.g. Ising σ (+1) from su(2)₂ spin-½
        (−1), which share fusion rules)."""
        v = self.qdim[a] * self.F[a, self.dual[a], a, a][0, 0]
        k = int(np.sign(np.real(v)))
        assert abs(v - k) < 1e-10, "non-unimodular FS indicator"
        return k


# ---------------------------------------------------------------------------
# Concrete categories
# ---------------------------------------------------------------------------

def _fill_trivial_F(N: np.ndarray) -> np.ndarray:
    """Start from the 'all admissible F-elements are +1' gauge; categories
    with genuinely nontrivial associators overwrite blocks afterwards."""
    n = N.shape[0]
    F = np.zeros((n, n, n, n, n, n))
    for a, b, c, d in product(range(n), repeat=4):
        for e in range(n):
            if not (N[a, b, e] and N[e, c, d]):
                continue
            for f in range(n):
                if N[b, c, f] and N[a, f, d]:
                    F[a, b, c, d, e, f] = 1.0
    return F


def fibonacci_category() -> FusionCategory:
    """Sectors (1, τ); τ⊗τ = 1 ⊕ τ; d_τ = φ. The nontrivial associator is
    [F^{τττ}_τ] = [[1/φ, 1/√φ], [1/√φ, -1/φ]] in the (1, τ) basis."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    N = np.zeros((2, 2, 2), int)
    N[0, 0, 0] = N[0, 1, 1] = N[1, 0, 1] = 1
    N[1, 1, 0] = N[1, 1, 1] = 1
    F = _fill_trivial_F(N)
    F[1, 1, 1, 1] = np.array([[1 / phi, 1 / np.sqrt(phi)],
                              [1 / np.sqrt(phi), -1 / phi]])
    return FusionCategory("Fibonacci", ("1", "tau"),
                          np.array([1.0, phi]), N, F, (0, 1))


def ising_category() -> FusionCategory:
    """Sectors (1, σ, ψ); σ⊗σ = 1 ⊕ ψ, σ⊗ψ = σ, ψ⊗ψ = 1; d_σ = √2.
    Nontrivial associators: [F^{σσσ}_σ] = H/√2 on (1, ψ), and
    [F^{σψσ}_1]? — the standard gauge has [F^{ψσψ}_σ] = [F^{σψσ}_{..}]
    sign −1 on the ψ-threading blocks."""
    N = np.zeros((3, 3, 3), int)
    for a in range(3):
        N[0, a, a] = N[a, 0, a] = 1
    N[1, 1, 0] = N[1, 1, 2] = 1        # σσ = 1 + ψ
    N[1, 2, 1] = N[2, 1, 1] = 1        # σψ = ψσ = σ
    N[2, 2, 0] = 1                     # ψψ = 1
    F = _fill_trivial_F(N)
    s = 1.0 / np.sqrt(2.0)
    # [F^{σσσ}_σ]_{e f}, e,f ∈ {1, ψ} = {0, 2}
    F[1, 1, 1, 1] = 0.0
    F[1, 1, 1, 1, 0, 0] = s
    F[1, 1, 1, 1, 0, 2] = s
    F[1, 1, 1, 1, 2, 0] = s
    F[1, 1, 1, 1, 2, 2] = -s
    # ψ threading through σ: [F^{ψσψ}_σ] = [F^{σψσ}_ψ] = −1
    F[2, 1, 2, 1, 1, 1] = -1.0
    F[1, 2, 1, 2, 1, 1] = -1.0
    return FusionCategory("Ising", ("1", "sigma", "psi"),
                          np.array([1.0, np.sqrt(2.0), 1.0]), N, F,
                          (0, 1, 2))


def zn_category(nz: int) -> FusionCategory:
    """Abelian Z_n: a⊗b = a+b mod n, all d = 1, trivial associator — the
    degenerate anchor matching the masked abelian backend
    (symmetry/charges.py)."""
    N = np.zeros((nz, nz, nz), int)
    for a in range(nz):
        for b in range(nz):
            N[a, b, (a + b) % nz] = 1
    F = _fill_trivial_F(N)
    return FusionCategory(f"Z{nz}", tuple(str(i) for i in range(nz)),
                          np.ones(nz), N, F,
                          tuple((-a) % nz for a in range(nz)))


def _braid(cat: FusionCategory, R: np.ndarray, name=None) -> BraidedCategory:
    return BraidedCategory(name or cat.name, cat.sectors, cat.qdim, cat.N,
                           cat.F, cat.dual, np.asarray(R, complex))


def fibonacci_braided() -> BraidedCategory:
    """Fibonacci MTC: R^{ττ}_1 = e^{-4πi/5}, R^{ττ}_τ = e^{3πi/5}
    (the chirality with θ_τ = e^{4πi/5}, h_τ = 2/5, c = 14/5)."""
    cat = fibonacci_category()
    R = np.zeros((2, 2, 2), complex)
    for a, b in product(range(2), repeat=2):
        for c in cat.fuse(a, b):
            R[a, b, c] = 1.0
    R[1, 1, 0] = np.exp(-4j * np.pi / 5)
    R[1, 1, 1] = np.exp(3j * np.pi / 5)
    return _braid(cat, R)


def ising_braided() -> BraidedCategory:
    """Ising MTC: R^{σσ}_1 = e^{-iπ/8}, R^{σσ}_ψ = e^{3iπ/8},
    R^{σψ}_σ = R^{ψσ}_σ = -i, R^{ψψ}_1 = -1 (θ_σ = e^{iπ/8}, h_σ = 1/16,
    c = 1/2 — the chiral Ising anyon content)."""
    cat = ising_category()
    R = np.zeros((3, 3, 3), complex)
    for a, b in product(range(3), repeat=2):
        for c in cat.fuse(a, b):
            R[a, b, c] = 1.0
    R[1, 1, 0] = np.exp(-1j * np.pi / 8)
    R[1, 1, 2] = np.exp(3j * np.pi / 8)
    R[1, 2, 1] = R[2, 1, 1] = -1j
    R[2, 2, 0] = -1.0
    return _braid(cat, R)


def zn_braided(nz: int, p: int = 1) -> BraidedCategory:
    """Z_n with the bilinear braiding R^{ab} = exp(2πi p·ab / n) (trivial
    associator; hexagon holds since R^{c,a}R^{c,b} = R^{c,a+b}). Modular
    iff gcd(2p, n)-degeneracy is absent (e.g. n odd, p coprime)."""
    cat = zn_category(nz)
    R = np.zeros((nz, nz, nz), complex)
    for a, b in product(range(nz), repeat=2):
        R[a, b, (a + b) % nz] = np.exp(2j * np.pi * p * a * b / nz)
    return _braid(cat, R, name=f"Z{nz}(p={p})")


# ---------------------------------------------------------------------------
# su(2)_k — quantum-group fusion categories (quantum 6j F-symbols)
# ---------------------------------------------------------------------------

def _qint(m: int, k: int) -> float:
    """Quantum integer [m]_q at q = e^{iπ/(k+2)}."""
    t = np.pi / (k + 2)
    return np.sin(m * t) / np.sin(t)


def _qfact(m: int, k: int) -> float:
    out = 1.0
    for i in range(2, m + 1):
        out *= _qint(i, k)
    return out


def su2k_category(k: int) -> FusionCategory:
    """su(2)_k: sectors are twice-spins a = 2j ∈ {0..k}; fusion is the
    truncated Clebsch-Gordan rule (triangle + a+b+c ≤ 2k); F-symbols are
    quantum 6j symbols at q = e^{iπ/(k+2)} (Kirillov–Reshetikhin):

      [F^{abc}_d]_{ef} = (-1)^{(a+b+c+d)/2} √([e+1][f+1]) {a/2 b/2 e/2;
                                                           c/2 d/2 f/2}_q

    k=1 reproduces the semion fusion ring (Z_2), k=2 the Ising fusion
    ring (with FS indicator −1 on spin-½ — the su(2)₂ ↔ Ising
    distinction), k=3 contains Fibonacci on its integer-spin subring.
    Validated by the pentagon/unitarity checks in tests."""
    n = k + 1
    N = np.zeros((n, n, n), int)
    for a, b in product(range(n), repeat=2):
        for c in range(abs(a - b), min(a + b, 2 * k - a - b) + 1, 2):
            N[a, b, c] = 1

    def tri(a, b, c):
        """Δ(abc) in twice-spin labels; arguments of the q-factorials are
        integers when (a,b,c) is admissible."""
        return np.sqrt(
            _qfact((-a + b + c) // 2, k) * _qfact((a - b + c) // 2, k)
            * _qfact((a + b - c) // 2, k)
            / _qfact((a + b + c) // 2 + 1, k))

    def sixj(a, b, e, c, d, f):
        """{a/2 b/2 e/2; c/2 d/2 f/2}_q, twice-spin arguments; assumes all
        four triads admissible."""
        pre = tri(a, b, e) * tri(e, c, d) * tri(b, c, f) * tri(a, f, d)
        t1, t2, t3, t4 = (a + b + e) // 2, (e + c + d) // 2, \
            (b + c + f) // 2, (a + f + d) // 2
        q1, q2, q3 = (a + b + c + d) // 2, (a + e + c + f) // 2, \
            (b + e + d + f) // 2
        tot = 0.0
        for z in range(max(t1, t2, t3, t4), min(q1, q2, q3) + 1):
            tot += ((-1.0) ** z * _qfact(z + 1, k)
                    / (_qfact(z - t1, k) * _qfact(z - t2, k)
                       * _qfact(z - t3, k) * _qfact(z - t4, k)
                       * _qfact(q1 - z, k) * _qfact(q2 - z, k)
                       * _qfact(q3 - z, k)))
        return pre * tot

    F = np.zeros((n, n, n, n, n, n))
    for a, b, c, d in product(range(n), repeat=4):
        for e in range(n):
            if not (N[a, b, e] and N[e, c, d]):
                continue
            for f in range(n):
                if not (N[b, c, f] and N[a, f, d]):
                    continue
                F[a, b, c, d, e, f] = (
                    (-1.0) ** ((a + b + c + d) // 2)
                    * np.sqrt(_qint(e + 1, k) * _qint(f + 1, k))
                    * sixj(a, b, e, c, d, f))

    qdim = np.array([_qint(a + 1, k) for a in range(n)])
    return FusionCategory(f"su2_{k}", tuple(f"{a}/2" if a % 2 else str(a // 2)
                                            for a in range(n)),
                          qdim, N, F, tuple(range(n)))


def su2k_braided(k: int) -> BraidedCategory:
    """su(2)_k with the standard braiding
    R^{ab}_c = (-1)^{(c-a-b)/2} q^{(c(c+2) - a(a+2) - b(b+2))/4},
    q = e^{iπ/(k+2)} — twists θ_a = e^{2πi h_a}, h_a = j(j+1)/(k+2),
    central charge 3k/(k+2) mod 8."""
    cat = su2k_category(k)
    n = k + 1
    q = np.exp(1j * np.pi / (k + 2))
    R = np.zeros((n, n, n), complex)
    for a, b in product(range(n), repeat=2):
        for c in cat.fuse(a, b):
            R[a, b, c] = ((-1.0) ** ((c - a - b) // 2)
                          * q ** ((c * (c + 2) - a * (a + 2)
                                   - b * (b + 2)) / 4))
    return _braid(cat, R)


# ---------------------------------------------------------------------------
# Masked-dense anyonic MPS helpers (generalizing symmetry/fibonacci.py)
# ---------------------------------------------------------------------------

def bond_labels(cat: FusionCategory, D: int,
                sectors: Tuple[int, ...] | None = None) -> np.ndarray:
    """Static sector labels for a dense bond of dimension D, split
    proportionally to the quantum dimensions (the asymptotic fusion-path
    count ratio — matches the reference's `virtual_space(D)` splitting).
    Every listed sector gets ≥1 slot; slots are ordered by sector index."""
    if sectors is None:
        sectors = tuple(range(cat.n))
    d = cat.qdim[list(sectors)]
    raw = D * d / d.sum()
    counts = np.maximum(1, np.round(raw).astype(int))
    while counts.sum() > D:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < D:
        counts[np.argmax(raw - counts)] += 1
    lab = np.concatenate([np.full(c, s, int)
                          for s, c in zip(sectors, counts)])
    return lab


def chain_masks(cat: FusionCategory, x: int, labels: np.ndarray,
                L: int = 1):
    """(A_mask (L, D, n, D), C_mask (L, D, D)) for a boundary MPS over
    chain anyon x in the fusion-path basis (physical index = height after
    the site): A[l, p, r] is supported on p == label_r and
    label_r ∈ label_l ⊗ x; C couples equal sectors.

    `labels` may be (D,) — one static sector split shared by every bond —
    or (L, D) — **per-bond labels**, `labels[i]` labeling the bond to the
    RIGHT of site i (needed whenever the fusion graph of x is bipartite/
    k-partite, e.g. the Ising σ chain where heights alternate {1,ψ} / σ,
    so no uniform split exists)."""
    labels = np.asarray(labels, int)
    n = cat.n
    adm = cat.N[:, x, :] > 0           # (a, b): b in a⊗x
    if labels.ndim == 1:
        labels = np.broadcast_to(labels, (L, labels.shape[0]))
    assert labels.shape[0] == L, (labels.shape, L)
    D = labels.shape[1]
    A = np.zeros((L, D, n, D), bool)
    C = np.zeros((L, D, D), bool)
    for i in range(L):
        left, right = labels[i - 1], labels[i]
        A[i] = (right[None, None, :] == np.arange(n)[None, :, None]) \
            & adm[np.ix_(left, right)][:, None, :]
        C[i] = right[:, None] == right[None, :]
    return A, C


def chain_bond_labels(cat: FusionCategory, x: int, D: int, L: int,
                      seed: Tuple[int, ...] | None = None) -> np.ndarray:
    """Per-bond static sector labels (L, D) for a period-L chain of anyons
    x: the allowed sector set of each bond is propagated around the unit
    cell (S_{i+1} = ∪_{a∈S_i} a⊗x) until periodic, then each bond's D
    slots are split among its allowed sectors by quantum dimension
    (`bond_labels`). `seed` fixes bond 0's sector set (default: the
    limit-cycle set reached from all sectors — the stationary support).

    Raises if no period-L-consistent assignment exists (e.g. odd L for a
    bipartite fusion graph like the Ising σ chain)."""
    step = lambda S: frozenset(
        c for a in S for c in cat.fuse(a, x))
    if seed is None:
        S = frozenset(range(cat.n))
        for _ in range(4 * cat.n + 4 * L):
            S = step(S)
    else:
        S = frozenset(int(a) for a in seed)
    # roll S forward until the L-step map returns to it (limit cycle)
    for _ in range(4 * cat.n + 4 * L):
        SL = S
        for _ in range(L):
            SL = step(SL)
        if SL == S:
            break
        S = step(S)
    else:
        raise ValueError(
            f"no period-{L} bond-sector assignment for anyon {x}")
    out = []
    for _ in range(L):
        S = step(S)                    # bond i sits AFTER site i
        out.append(bond_labels(cat, D, tuple(sorted(S))))
    return np.stack(out)


def quantum_schmidt(cat: FusionCategory, labels: np.ndarray,
                    C: np.ndarray) -> Dict[int, np.ndarray]:
    """{sector: probabilities} of a block-diagonal gauge matrix C with the
    quantum-trace normalization Σ_a d_a Σ_i p_{a,i} = 1."""
    labels = np.asarray(labels, int)
    C = np.asarray(C)
    out, norm = {}, 0.0
    for a in sorted(set(labels.tolist())):
        idx = np.where(labels == a)[0]
        s = np.linalg.svd(C[np.ix_(idx, idx)], compute_uv=False)
        p = s * s
        out[a] = p
        norm += cat.qdim[a] * float(p.sum())
    return {a: p / norm for a, p in out.items()}


def quantum_entropy(cat: FusionCategory, labels: np.ndarray,
                    C: np.ndarray) -> float:
    """S = -Σ_a d_a Σ_i p_{a,i} log p_{a,i} (quantum trace — what the
    reference's `entropy` computes for anyonic sectors)."""
    probs = quantum_schmidt(cat, labels, C)
    S = 0.0
    for a, p in probs.items():
        p = p[p > 1e-300]
        S -= cat.qdim[a] * float(np.sum(p * np.log(p)))
    return S
