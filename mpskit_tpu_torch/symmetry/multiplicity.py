"""(PyTorch port: a copy of mpskit_tpu/symmetry/multiplicity.py, host
numpy only.) Fusion categories with arbitrary multiplicities N[a,b,c] ≥ 1 — the
general case of TensorKit's sector machinery (reference: TensorKit
`FusionStyle = GenericFusion`, used for e.g. product categories and
`Rep[G]` of non-abelian finite groups; MPSKit consumes it transparently
through `TensorMap`, see e.g. reference src/operators/sparsempo/
sparsempo.jl:217-230 where fusion trees enter `isid` checks).

`symmetry/category.py` covers the multiplicity-free case (N ∈ {0,1}),
where every fusion vertex is unique and F-symbols are plain matrices
[F^{abc}_d]_{e,f}. Here each vertex (a,b → c) carries an N[a,b,c]-dim
multiplicity space, and the F-move becomes a unitary between
vertex-labelled tree bases:

    |((ab)c → d); e, α, β>  =  Σ_{f,μ,ν} [F^{abc}_d]_{(e,α,β),(f,μ,ν)}
                                  |(a(bc) → d); f, μ, ν>

with α ∈ (a,b→e), β ∈ (e,c→d), μ ∈ (b,c→f), ν ∈ (a,f→d). The pentagon
and hexagon equations gain multiplicity contractions (Bonderson, PhD
thesis 2007, eqs. 2.68 / 2.87 — general-multiplicity forms).

Besides the abstract data container + validators, this module provides a
**constructor that computes the data numerically** for Rep(G) of any
finite group G given explicit unitary irrep matrices: fusion
multiplicities from characters, orthonormal Clebsch-Gordan intertwiners
from group-averaged projectors, F-symbols from recoupling overlaps, and
the symmetric braiding (R-matrices on vertex spaces) from the flip map.
`rep_a4()` is the smallest genuinely multiplicity-bearing instance
(3 ⊗ 3 ⊃ 2·3 in A₄), `rep_s3()` the multiplicity-free anchor.

Everything is plain numpy static data (host-side); like category.py it
feeds masks/operator construction, not device kernels.
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .category import FusionCategory, BraidedCategory


@dataclasses.dataclass(frozen=True)
class MultiplicityCategory:
    """Unitary fusion category with arbitrary fusion multiplicities.

    ``F[a, b, c, d]`` has shape (n, m, m, n, m, m) indexed
    ``[e, α, β, f, μ, ν]`` where m = max multiplicity; entries outside
    the admissible vertex ranges (α ≥ N[a,b,e] etc.) are zero.
    """

    name: str
    sectors: Tuple[str, ...]
    qdim: np.ndarray            # (n,)
    N: np.ndarray               # (n, n, n) non-negative int
    F: np.ndarray               # (n,n,n,n, n,m,m, n,m,m)
    dual: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.sectors)

    @property
    def mmax(self) -> int:
        return int(self.F.shape[5])

    def fuse(self, a: int, b: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.where(self.N[a, b] > 0)[0])

    @property
    def total_qdim(self) -> float:
        return float(np.sqrt(np.sum(self.qdim ** 2)))

    # -- tree-basis index helpers ----------------------------------------

    def left_tree_basis(self, a, b, c, d) -> List[Tuple[int, int, int]]:
        """Admissible (e, α, β) rows of [F^{abc}_d]."""
        N = self.N
        return [(e, al, be)
                for e in self.fuse(a, b) if N[e, c, d]
                for al in range(N[a, b, e])
                for be in range(N[e, c, d])]

    def right_tree_basis(self, a, b, c, d) -> List[Tuple[int, int, int]]:
        """Admissible (f, μ, ν) columns of [F^{abc}_d]."""
        N = self.N
        return [(f, mu, nu)
                for f in self.fuse(b, c) if N[a, f, d]
                for mu in range(N[b, c, f])
                for nu in range(N[a, f, d])]

    def f_block(self, a, b, c, d) -> np.ndarray:
        """[F^{abc}_d] restricted to its admissible support (a square
        unitary matrix: rows = left tree basis, cols = right)."""
        rows = self.left_tree_basis(a, b, c, d)
        cols = self.right_tree_basis(a, b, c, d)
        M = np.zeros((len(rows), len(cols)), self.F.dtype)
        for i, (e, al, be) in enumerate(rows):
            for j, (f, mu, nu) in enumerate(cols):
                M[i, j] = self.F[a, b, c, d, e, al, be, f, mu, nu]
        return M

    # -- anyonic chains over the multiplicity tree basis -------------------

    def chain_projector(self, x: int, channel: int) -> np.ndarray:
        """Local projector onto fusion channel `channel` (ALL its vertex
        copies) of two neighboring chain anyons x, over the multiplicity
        tree basis — the N[a,b,c] > 1 generalization of
        `FusionCategory.chain_projector` (Feiguin et al. construction):

            P[a, d, (h,α,β), (h',α',β')] =
                Σ_{μν} [F^{axx}_d]_{(h,α,β),(c,μ,ν)}
                       [F^{axx}_d]*_{(h',α',β'),(c,μ,ν)}

        with α ∈ N[a,x,h] the vertex multiplicity entering height h (the
        physical multiplicity of the site) and β ∈ N[h,x,d] the one
        leaving it (the NEXT site's physical multiplicity). Entries
        vanish off the admissible support."""
        col = self.F[:, x, x, :, :, :, :, channel, :, :]
        # (a, d, h, α, β, μ, ν)
        return np.einsum("adhxyuv,adkzwuv->adhxykzw", col, col.conj())

    def chain_local_term(self, x: int, channel: int) -> np.ndarray:
        """3-site local operator over the unconstrained (height,
        multiplicity) tensor basis, physical dimension n·m per site
        (site i carries q_i = (h_i, μ_i), μ_i the multiplicity of the
        vertex h_{i-1} ⊗ x → h_i): diagonal in q_1 and in h_3, acting on
        (h_2, μ_2, μ_3). Feed to `MPOHamiltonian.from_local`."""
        n, m = self.n, self.mmax
        P = self.chain_projector(x, channel)    # (a,d,h,α,β,h',α',β')
        d = n * m
        O = np.zeros((d, d, d, d, d, d), complex)
        for a in range(n):
            for mu1 in range(m):
                q1 = a * m + mu1
                for dd in range(n):
                    for h in range(n):
                        for al in range(m):
                            for be in range(m):
                                for h2 in range(n):
                                    for al2 in range(m):
                                        for be2 in range(m):
                                            v = P[a, dd, h, al, be,
                                                  h2, al2, be2]
                                            if v == 0.0:
                                                continue
                                            O[q1, h * m + al, dd * m + be,
                                              q1, h2 * m + al2,
                                              dd * m + be2] = v
        if np.max(np.abs(O.imag)) < 1e-12:
            O = O.real.copy()
        return O

    def path_basis(self, x: int, L: int, left: int | None = 0,
                   right: int | None = None) -> np.ndarray:
        """Admissible (h_i, μ_i) sequences of a chain of L anyons x
        (μ_i < N[h_{i-1}, x, h_i]); returns (n_paths, L, 2) int."""
        N = self.N
        if left is None:
            starts = [(h, mu) for a in range(self.n)
                      for h in range(self.n) for mu in range(N[a, x, h])]
            starts = sorted(set(starts))
        else:
            starts = [(h, mu) for h in self.fuse(left, x)
                      for mu in range(N[left, x, h])]
        paths = [[s] for s in starts]
        for _ in range(L - 1):
            paths = [p + [(h, mu)] for p in paths
                     for h in self.fuse(p[-1][0], x)
                     for mu in range(N[p[-1][0], x, h])]
        if right is not None:
            paths = [p for p in paths if p[-1][0] == right]
        return np.asarray(paths, int).reshape(-1, L, 2)

    def chain_hamiltonian_dense(self, x: int, channel: int, L: int,
                                coupling: float = -1.0,
                                left: int | None = 0,
                                right: int | None = None) -> tuple:
        """Dense ED oracle over the admissible multiplicity-path basis:
        H = coupling · Σ_{i=2}^{L-1} P^{(channel)}_i (windows fully
        inside, matching `from_local`). Returns (H, paths)."""
        paths = self.path_basis(x, L, left=left, right=right)
        npz = len(paths)
        index = {tuple(map(tuple, p)): i for i, p in enumerate(paths)}
        P = self.chain_projector(x, channel)
        H = np.zeros((npz, npz), P.dtype)
        n, m = self.n, self.mmax
        for i, p in enumerate(paths):
            p = [tuple(q) for q in p]
            for site in range(1, L - 1):
                a = p[site - 1][0]
                h, al = p[site]
                d, be = p[site + 1]
                for h2 in range(n):
                    for al2 in range(m):
                        for be2 in range(m):
                            amp = P[a, d, h2, al2, be2, h, al, be]
                            if amp == 0.0:
                                continue
                            q = list(p)
                            q[site] = (h2, al2)
                            q[site + 1] = (d, be2)
                            j = index.get(tuple(q))
                            if j is not None:
                                H[j, i] += coupling * amp
        if np.max(np.abs(H.imag)) < 1e-12:
            H = H.real.copy()
        return H, paths

    def chain_mpo(self, x: int, channel: int, coupling: float = -1.0,
                  period: int = 1, dtype=np.float64):
        """`MPOHamiltonian` of the multiplicity anyonic chain over the
        (height, multiplicity) tensor basis (physical dimension n·m):
        H = coupling · Σ_i P^{(channel)}_i. The admissible-path sector
        is invariant (F elements vanish off support)."""
        from ..operators.mpo import MPOHamiltonian

        O = coupling * self.chain_local_term(x, channel)
        if np.iscomplexobj(O) and np.issubdtype(np.dtype(dtype),
                                                np.floating):
            assert np.max(np.abs(O.imag)) < 1e-12
            O = O.real
        return MPOHamiltonian.from_local(O.astype(dtype), period=period)

    # -- validators -------------------------------------------------------

    def check_fusion(self) -> None:
        N = self.N
        assert np.array_equal(N[0], np.eye(self.n, dtype=N.dtype))
        assert np.array_equal(N[:, 0], np.eye(self.n, dtype=N.dtype))
        lhs = np.einsum("abe,ecd->abcd", N, N)
        rhs = np.einsum("bcf,afd->abcd", N, N)
        assert np.array_equal(lhs, rhs), "fusion not associative"
        for a in range(self.n):
            assert N[a, self.dual[a], 0] == 1

    def check_unitarity(self, atol: float = 1e-10) -> None:
        for a, b, c, d in product(range(self.n), repeat=4):
            M = self.f_block(a, b, c, d)
            if M.shape[0] == 0:
                continue
            assert M.shape[0] == M.shape[1], (a, b, c, d, M.shape)
            err = np.max(np.abs(M @ M.conj().T - np.eye(M.shape[0])))
            assert err < atol, (a, b, c, d, err)

    def check_pentagon(self, atol: float = 1e-10) -> None:
        """General-multiplicity pentagon (Bonderson eq. 2.68):

          Σ_δ [F^{fcd}_e]_{(g,β,γ),(l,ν,δ)} [F^{abl}_e]_{(f,α,δ),(k,μ,λ)}
            = Σ_{h,σ,ψ,ρ} [F^{abc}_g]_{(f,α,β),(h,σ,ψ)}
                          [F^{ahd}_e]_{(g,ψ,γ),(k,ρ,λ)}
                          [F^{bcd}_k]_{(h,σ,ρ),(l,ν,μ)}

        for every admissible (a..e; f,α; g,β,γ; l,ν; k,μ,λ). Contractions
        run over the full padded multiplicity axes (inadmissible entries
        are zero), so einsum-style sums are safe.
        """
        n, F, N = self.n, self.F, self.N
        m = self.mmax
        for a, b, c, d, e in product(range(n), repeat=5):
            for f in self.fuse(a, b):
                for g in self.fuse(f, c):
                    if not N[g, d, e]:
                        continue
                    for l in self.fuse(c, d):
                        if not N[f, l, e]:
                            continue
                        for k in self.fuse(b, l):
                            if not N[a, k, e]:
                                continue
                            Fl = F[f, c, d, e]     # [g,β,γ, l,ν,δ]
                            Fab = F[a, b, l, e]    # [f,α,δ, k,μ,λ]
                            lhs = np.einsum(
                                "bgnd,admL->bgnamL",
                                Fl[g, :, :, l], Fab[f, :, :, k])
                            # lhs[β,γ,ν,α,μ,λ]
                            rhs = np.zeros_like(lhs)
                            for h in range(n):
                                F1 = F[a, b, c, g][f, :, :, h]  # [α,β,σ,ψ]
                                F2 = F[a, h, d, e][g, :, :, k]  # [ψ,γ,ρ,λ]
                                F3 = F[b, c, d, k][h, :, :, l]  # [σ,ρ,ν,μ]
                                rhs += np.einsum(
                                    "absp,pgrL,srnm->bgnamL",
                                    F1, F2, F3)
                            assert np.max(np.abs(lhs - rhs)) < atol, (
                                (a, b, c, d, e, f, g, l, k),
                                float(np.max(np.abs(lhs - rhs))))
            _ = m  # (documentation: padded axes length)

    @staticmethod
    def from_multiplicity_free(cat: FusionCategory) -> "MultiplicityCategory":
        """Embed an N ∈ {0,1} category (m = 1; F gains 4 singleton
        multiplicity axes)."""
        n = cat.n
        F = cat.F.reshape(n, n, n, n, n, 1, 1, n)[..., None, None]
        F = np.moveaxis(F, 7, 7)  # shape (n,n,n,n,n,1,1,n,1,1)
        return MultiplicityCategory(cat.name, cat.sectors, cat.qdim,
                                    cat.N.astype(int), F, cat.dual)


@dataclasses.dataclass(frozen=True)
class BraidedMultiplicityCategory(MultiplicityCategory):
    """+ braiding: ``R[a, b, c]`` is an (m, m) matrix on the fusion-vertex
    multiplicity space, [R^{ab}_c]_{μν} = coefficient of the exchanged
    vertex: braid(a,b) · |(ab → c), μ> = Σ_ν [R^{ab}_c]_{μν} |(ba → c), ν>.
    Zero-padded outside N[a,b,c] (rows) / N[b,a,c] (cols)."""

    R: np.ndarray = None        # (n, n, n, m, m) complex

    def check_hexagon(self, atol: float = 1e-10) -> None:
        """General-multiplicity hexagon (Bonderson eq. 2.87; reduces to
        category.BraidedCategory.check_hexagon when m = 1):

          Σ_{α',γ} [R^{ca}_e]_{αα'} [F^{acb}_d]_{(e,α',β),(g,γ,δ)}
                   [R^{cb}_g]_{γγ'}
            = Σ_{f,μ,ν,ν'} [F^{cab}_d]_{(e,α,β),(f,μ,ν)} [R^{cf}_d]_{νν'}
                           [F^{abc}_d]_{(f,μ,ν'),(g,γ',δ)}

        and the mirrored equation with every R replaced by R⁻¹ (the
        inverse braiding, i.e. the conjugate-transposed vertex matrices).
        """
        self._hexagon_one(self.R, atol, "hexagon")
        Rinv = np.einsum("abcmn->bacnm", self.R.conj())
        self._hexagon_one(Rinv, atol, "inverse hexagon")

    def _hexagon_one(self, R, atol, tag):
        n, F, N = self.n, self.F, self.N
        for a, b, c, d in product(range(n), repeat=4):
            for e in self.fuse(c, a):
                if not N[e, b, d]:
                    continue
                for g in self.fuse(c, b):
                    if not N[a, g, d]:
                        continue
                    # lhs[α,β, γ',δ]
                    lhs = np.einsum(
                        "ax,xbgd,gy->abyd",
                        R[c, a, e], F[a, c, b, d][e, :, :, g],
                        R[c, b, g])
                    rhs = np.zeros_like(lhs)
                    for f in self.fuse(a, b):
                        if not N[c, f, d]:
                            continue
                        rhs += np.einsum(
                            "abmn,nx,mxgd->abgd",
                            F[c, a, b, d][e, :, :, f], R[c, f, d],
                            F[a, b, c, d][f, :, :, g])
                    assert np.max(np.abs(lhs - rhs)) < atol, (
                        tag, (a, b, c, d, e, g),
                        float(np.max(np.abs(lhs - rhs))))

    def twists(self) -> np.ndarray:
        """θ_a = (1/d_a) Σ_c d_c tr[R^{aa}_c] (trace over the vertex
        multiplicity space)."""
        return np.array([
            sum(self.qdim[c] * np.trace(self.R[a, a, c])
                for c in self.fuse(a, a)) / self.qdim[a]
            for a in range(self.n)])

    def monodromy_is_trivial(self, atol: float = 1e-10) -> bool:
        """True for symmetric categories (Rep(G)): braiding twice is the
        identity on every vertex space, Σ_ν [R^{ab}_c]_{μν}[R^{ba}_c]_{νμ'}
        = δ_{μμ'}."""
        for a, b in product(range(self.n), repeat=2):
            for c in self.fuse(a, b):
                m = self.N[a, b, c]
                M = self.R[a, b, c][:m, :self.N[b, a, c]] \
                    @ self.R[b, a, c][:self.N[b, a, c], :m]
                if np.max(np.abs(M - np.eye(m))) > atol:
                    return False
        return True


def lift_braided(cat: BraidedCategory) -> BraidedMultiplicityCategory:
    """Embed a multiplicity-free braided category (m = 1)."""
    base = MultiplicityCategory.from_multiplicity_free(cat)
    R = cat.R.reshape(cat.n, cat.n, cat.n, 1, 1)
    return BraidedMultiplicityCategory(
        base.name, base.sectors, base.qdim, base.N, base.F, base.dual, R)


# ---------------------------------------------------------------------------
# Rep(G) from explicit unitary irreps
# ---------------------------------------------------------------------------

def _intertwiners(Ra: np.ndarray, Rb: np.ndarray, Rc: np.ndarray,
                  nabc: int) -> np.ndarray:
    """Orthonormal basis of Hom(c, a⊗b): isometries C[μ] of shape
    (d_a·d_b, d_c) with C[μ]† C[ν] = δ_{μν}·I, computed as the
    eigenvalue-1 eigenspace of the group-averaged projector
    P(X) = (1/|G|) Σ_g (R_a(g) ⊗ R_b(g)) X R_c(g)†."""
    G, da, _ = Ra.shape
    db, dc = Rb.shape[1], Rc.shape[1]
    # vec(X) with X of shape (da*db, dc): P acts as Σ_g kron(Ra⊗Rb, conj(Rc))
    AB = np.einsum("gij,gkl->gikjl", Ra, Rb).reshape(G, da * db, da * db)
    P = np.einsum("gxy,guv->xuyv", AB, Rc.conj()).reshape(
        da * db * dc, da * db * dc) / G
    w, V = np.linalg.eigh((P + P.conj().T) / 2)
    fixed = V[:, w > 0.5]
    # Hom_G(c, a⊗b) is N[a,b,c]-dimensional (Schur); each basis vector of
    # the fixed space is one full (d_a·d_b, d_c) intertwiner matrix.
    assert fixed.shape[1] == nabc, (fixed.shape, nabc, dc)
    Xs = fixed.T.reshape(-1, da * db, dc)
    # Gram-Schmidt in Hom space: by Schur, X† Y = λ·I for intertwiners, so
    # the trace inner product is faithful on Hom.
    Cs: List[np.ndarray] = []
    for X in Xs:
        for C in Cs:
            X = X - C * (np.trace(C.conj().T @ X) / dc)
        nrm = np.sqrt(np.real(np.trace(X.conj().T @ X)) / dc)
        if nrm > 1e-8:
            Cs.append(X / nrm)
    assert len(Cs) == nabc, (len(Cs), nabc)
    out = np.stack(Cs)
    # verify isometry property C† C = I (Schur + normalization)
    for mu in range(nabc):
        err = np.max(np.abs(out[mu].conj().T @ out[mu] - np.eye(dc)))
        assert err < 1e-8, err
    return out


def rep_category(name: str, irreps: Sequence[np.ndarray],
                 braided: bool = True):
    """Build Rep(G) as a (Braided)MultiplicityCategory from explicit
    unitary irrep matrices.

    ``irreps[i]`` is an array of shape (|G|, d_i, d_i) — the i-th irrep
    evaluated on all group elements **in one fixed element order shared
    by every irrep** (no multiplication table needed: only group
    averages enter). Irrep 0 must be trivial. Returns the category with
    qdim = irrep dimensions, F from Clebsch-Gordan recoupling and (if
    `braided`) the symmetric flip braiding; being Rep(G), all twists are
    +1 and the monodromy is trivial.
    """
    nG = irreps[0].shape[0]
    n = len(irreps)
    dims = [int(R.shape[1]) for R in irreps]
    assert dims[0] == 1 and np.allclose(irreps[0], 1.0)
    chars = np.stack([np.einsum("gii->g", R) for R in irreps])
    # fusion multiplicities from character orthogonality
    Nf = np.real(np.einsum("ag,bg,cg->abc", chars, chars,
                           chars.conj())) / nG
    N = np.rint(Nf).astype(int)
    assert np.max(np.abs(Nf - N)) < 1e-8, "non-integer fusion numbers"
    # duals from N[a,b,0]
    dual = tuple(int(np.where(N[a, :, 0] > 0)[0][0]) for a in range(n))

    # Clebsch-Gordan intertwiners for every admissible vertex
    CG: Dict[Tuple[int, int, int], np.ndarray] = {}
    for a, b in product(range(n), repeat=2):
        for c in range(n):
            if N[a, b, c]:
                CG[(a, b, c)] = _intertwiners(
                    irreps[a], irreps[b], irreps[c], int(N[a, b, c]))

    m = int(N.max())
    F = np.zeros((n, n, n, n, n, m, m, n, m, m), complex)
    for a, b, c, d in product(range(n), repeat=4):
        rows = [(e, al, be) for e in range(n) if N[a, b, e] and N[e, c, d]
                for al in range(N[a, b, e]) for be in range(N[e, c, d])]
        cols = [(f, mu, nu) for f in range(n) if N[b, c, f] and N[a, f, d]
                for mu in range(N[b, c, f]) for nu in range(N[a, f, d])]
        if not rows:
            continue
        da, db, dc, dd = dims[a], dims[b], dims[c], dims[d]
        TL, TR = [], []
        for (e, al, be) in rows:
            # ((ab)c → d): embed d into e⊗c then e into a⊗b
            T = np.kron(CG[(a, b, e)][al], np.eye(dc)) @ CG[(e, c, d)][be]
            TL.append(T)            # (da·db·dc, dd)
        for (f, mu, nu) in cols:
            T = np.kron(np.eye(da), CG[(b, c, f)][mu]) @ CG[(a, f, d)][nu]
            TR.append(T)
        # overlap: T_R† T_L = λ·I_d by Schur; λ = tr/d_d
        for i, (e, al, be) in enumerate(rows):
            for j, (f, mu, nu) in enumerate(cols):
                F[a, b, c, d, e, al, be, f, mu, nu] = np.trace(
                    TR[j].conj().T @ TL[i]) / dd
        # completeness: the F-block must exactly expand T_L on T_R
        M = np.array([[F[a, b, c, d, e, al, be, f, mu, nu]
                       for (f, mu, nu) in cols] for (e, al, be) in rows])
        rec = np.einsum("rc,cxy->rxy", M, np.stack(TR))
        assert np.max(np.abs(rec - np.stack(TL))) < 1e-8, (a, b, c, d)

    qdim = np.array(dims, float)
    base = MultiplicityCategory(name, tuple(f"irrep{i}" for i in range(n)),
                                qdim, N, F, dual)
    if not braided:
        return base

    # symmetric braiding: SWAP_{ab} C^{ab→c,μ} = Σ_ν [R^{ab}_c]_{μν} C^{ba→c,ν}
    R = np.zeros((n, n, n, m, m), complex)
    for a, b in product(range(n), repeat=2):
        da, db = dims[a], dims[b]
        SW = np.zeros((db * da, da * db))
        for i in range(da):
            for j in range(db):
                SW[j * da + i, i * db + j] = 1.0
        for c in self_fuse(N, a, b):
            dc = dims[c]
            for mu in range(N[a, b, c]):
                X = SW @ CG[(a, b, c)][mu]
                for nu in range(N[b, a, c]):
                    R[a, b, c, mu, nu] = np.trace(
                        CG[(b, a, c)][nu].conj().T @ X) / dc
    return BraidedMultiplicityCategory(
        base.name, base.sectors, base.qdim, base.N, base.F, base.dual, R)


def self_fuse(N: np.ndarray, a: int, b: int):
    return [int(c) for c in np.where(N[a, b] > 0)[0]]


# ---------------------------------------------------------------------------
# Concrete groups (irreps built from permutation actions)
# ---------------------------------------------------------------------------

def _perm_matrix(p: Sequence[int]) -> np.ndarray:
    n = len(p)
    M = np.zeros((n, n))
    for i, j in enumerate(p):
        M[j, i] = 1.0
    return M


def _standard_rep(perms: Sequence[Sequence[int]]) -> np.ndarray:
    """The (n-1)-dim standard irrep of a (2-transitive) permutation group:
    permutation matrices restricted to the sum-zero subspace via an
    orthonormal basis Q."""
    n = len(perms[0])
    # orthonormal basis of {x : Σx = 0}: QR of the centered identity
    X = np.eye(n) - 1.0 / n
    Q, _ = np.linalg.qr(X[:, : n - 1])
    return np.stack([Q.T @ _perm_matrix(p) @ Q for p in perms])


def _compose(p, q):
    """(p∘q)(i) = p[q[i]]."""
    return tuple(p[i] for i in q)


def _closure(gens):
    elems = {tuple(range(len(gens[0])))}
    frontier = list(elems)
    while frontier:
        new = []
        for p in frontier:
            for g in gens:
                q = _compose(g, p)
                if q not in elems:
                    elems.add(q)
                    new.append(q)
        frontier = new
    return sorted(elems)


def rep_s3(with_irreps: bool = False):
    """Rep(S₃): sectors (1, sign, std-2d); multiplicity-free
    (2⊗2 = 1 ⊕ 1' ⊕ 2) — the anchor case where the general machinery
    must agree with the m=1 validators. `with_irreps=True` additionally
    returns the explicit irrep matrices (for concrete-spin-chain
    oracles)."""
    perms = _closure([(1, 0, 2), (1, 2, 0)])
    assert len(perms) == 6
    triv = np.ones((6, 1, 1))
    sign = np.array([[[np.linalg.det(_perm_matrix(p))]] for p in perms])
    std = _standard_rep(perms)
    irreps = [triv, sign, std]
    cat = rep_category("Rep(S3)", irreps)
    return (cat, irreps) if with_irreps else cat


def rep_a4(with_irreps: bool = False):
    """Rep(A₄): sectors (1, 1', 1'', 3). The smallest genuinely
    multiplicity-bearing fusion category relevant here:
    3 ⊗ 3 = 1 ⊕ 1' ⊕ 1'' ⊕ 3 ⊕ 3, i.e. N[3,3,3] = 2, so F-blocks at
    total charge 3 genuinely mix vertex multiplicity spaces.
    `with_irreps=True` additionally returns the irrep matrices."""
    gens = [(1, 0, 3, 2), (1, 2, 0, 3)]
    perms = _closure(gens)
    assert len(perms) == 12
    # quotient A4 / V ≅ Z3: coset index of each element
    V = {(0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0)}
    b = (1, 2, 0, 3)
    b2 = _compose(b, b)

    def coset(p):
        if p in V:
            return 0
        # b⁻¹ = b², so b^{-k}∘p ∈ V ⇔ p lies in coset k
        if _compose(b2, p) in V:
            return 1
        assert _compose(b, p) in V
        return 2

    w = np.exp(2j * np.pi / 3)
    triv = np.ones((12, 1, 1))
    om1 = np.array([[[w ** coset(p)]] for p in perms])
    om2 = np.array([[[w ** (2 * coset(p))]] for p in perms])
    std = _standard_rep(perms)
    irreps = [triv, om1, om2, std]
    cat = rep_category("Rep(A4)", irreps)
    return (cat, irreps) if with_irreps else cat
