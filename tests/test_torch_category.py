"""The fusion-category layer of the PyTorch port (symmetry/category.py,
symmetry/multiplicity.py, models/anyons.py and the Fibonacci hard-hexagon
MPO), its own copy of the JAX package's host numpy data, against the JAX
package: every constructor's arrays equal, the pentagon / hexagon / ribbon
checks, the chain MPOs to 1e-14, path-basis ED energies of the golden and
sigma chains, the free-fermion oracle of the sigma chain (the map of
tests/test_category.py:105-128), and a category carried across with
`interop.category_from_numpy`."""

import numpy as np
import pytest

from mpskit_tpu import models as jmodels
from mpskit_tpu.symmetry import category as jcat
from mpskit_tpu.symmetry import multiplicity as jmul
from mpskit_tpu_torch import interop
from mpskit_tpu_torch import models as tmodels
from mpskit_tpu_torch.symmetry import category as tcat
from mpskit_tpu_torch.symmetry import multiplicity as tmul

CONSTRUCTORS = {
    "fibonacci": lambda m: m.fibonacci_category(),
    "ising": lambda m: m.ising_category(),
    "z3": lambda m: m.zn_category(3),
    "z4": lambda m: m.zn_category(4),
    "su2_2": lambda m: m.su2k_category(2),
    "su2_3": lambda m: m.su2k_category(3),
    "fibonacci_braided": lambda m: m.fibonacci_braided(),
    "ising_braided": lambda m: m.ising_braided(),
    "z3_braided": lambda m: m.zn_braided(3, 1),
    "su2_3_braided": lambda m: m.su2k_braided(3),
}


def _same_category(a, b):
    assert type(a).__name__ == type(b).__name__
    assert (a.name, a.sectors, a.dual) == (b.name, b.sectors, b.dual)
    for field in ("qdim", "N", "F", "R"):
        x, y = getattr(a, field, None), getattr(b, field, None)
        assert (x is None) == (y is None), field
        if x is not None:
            assert np.array_equal(x, y), field


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_equal_jax_exactly(name):
    """N, F, qdim, dual (and R of the braided forms) bit for bit, and
    `interop.category_from_numpy` rebuilds the port's category from the
    JAX one's arrays."""
    ref = CONSTRUCTORS[name](jcat)
    _same_category(ref, CONSTRUCTORS[name](tcat))
    _same_category(ref, interop.category_from_numpy(
        ref.name, ref.sectors, ref.qdim, ref.N, ref.F, ref.dual,
        getattr(ref, "R", None)))


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_category_checks_pass(name):
    """Fusion, unitarity and pentagon on the port's copy; hexagon and
    ribbon on the braided ones; the invariants equal JAX's to 1e-12."""
    cat = CONSTRUCTORS[name](tcat)
    cat.check_fusion()
    cat.check_unitarity()
    cat.check_pentagon()
    if isinstance(cat, tcat.BraidedCategory):
        cat.check_hexagon()
        cat.check_ribbon()
        ref = CONSTRUCTORS[name](jcat)
        np.testing.assert_allclose(cat.twists(), ref.twists(), atol=1e-12)
        np.testing.assert_allclose(cat.s_matrix(), ref.s_matrix(),
                                   atol=1e-12)
        assert abs(cat.central_charge() - ref.central_charge()) <= 1e-12
        assert cat.is_modular() == ref.is_modular()


def test_pentagon_check_has_teeth():
    """A flipped associator sign fails the port's pentagon check."""
    import dataclasses

    cat = tcat.ising_category()
    F = cat.F.copy()
    F[2, 1, 2, 1, 1, 1] = +1.0
    with pytest.raises(AssertionError):
        dataclasses.replace(cat, F=F).check_pentagon()


def _mpos(m, models):
    fib = m.fibonacci_category()
    return {
        "golden": models.golden_chain(),
        "golden_fm_p2": models.golden_chain(antiferro=False, period=2),
        "sigma": models.ising_anyon_chain(),
        "rsos3": models.rsos_chain(3),
        "z3": models.anyon_chain(m.zn_category(3), 1),
        "finite_pinned": models.anyon_chain_finite(fib, 1, 8)[0],
    }


@pytest.mark.parametrize("name", ["golden", "golden_fm_p2", "sigma", "rsos3",
                                  "z3", "finite_pinned"])
def test_chain_mpos_match_jax(name):
    """The FSM tensors of the anyonic chain MPOs to 1e-14 (the port's
    `MPOHamiltonian.from_local` / `from_fsm` on the copied local terms)."""
    a = _mpos(jcat, jmodels)[name]
    b = _mpos(tcat, tmodels)[name]
    assert a.W.shape == b.W.shape
    np.testing.assert_allclose(b.W, np.asarray(a.W), rtol=0, atol=1e-14)


def test_pins_and_hard_hexagon_fibonacci_match_jax():
    """anyon_chain_finite's boundary pins, and the Fibonacci hard-hexagon
    transfer MPO bit for bit."""
    for L in (7, 8):
        assert (jmodels.anyon_chain_finite(jcat.ising_category(), 1, L)[1]
                == tmodels.anyon_chain_finite(tcat.ising_category(), 1, L)[1])
    a = jmodels.hard_hexagon_fibonacci().site(0)
    b = tmodels.hard_hexagon_fibonacci().site(0)
    assert np.array_equal(np.asarray(a), b)


def _sigma_free_fermion(L: int) -> float:
    """Ground energy of the sigma chain of L anyons (vacuum left, heights
    fixed on the right): the open critical TFIM on m = L/2 spins with m-1 X
    and m-1 ZZ terms, H = -sum_k [(1 + X_k)/2 + (1 + Z_k Z_k+1)/2], whose
    last spin's Z is conserved: a Majorana chain of 2m-1 sites with
    hoppings 1/2 (the last Majorana free)."""
    m = L // 2
    n = 2 * m - 1
    A = np.zeros((n, n))
    for j in range(n - 1):
        A[j, j + 1], A[j + 1, j] = 1.0, -1.0
    ev = np.linalg.eigvalsh(1j * A)
    return -(m - 1) - 0.5 * float(np.sum(ev[ev > 0]))


@pytest.mark.parametrize("L,ref", [(8, -5.013669746062924),
                                   (12, -8.297877056362573),
                                   (20, -14.853102368087338)])
def test_sigma_chain_free_fermion_oracle(L, ref):
    """The free-fermion energy of the mapped TFIM equals the sigma chain's
    path ED (right height 0; the JAX package's value) to 1e-12."""
    cat = tcat.ising_category()
    Hp, paths = cat.chain_hamiltonian_dense(1, 0, L, left=0, right=0)
    e_ed = float(np.linalg.eigvalsh(Hp)[0])
    assert len(paths) == 2 ** (L // 2 - 1)
    assert abs(e_ed - ref) <= 1e-12
    assert abs(_sigma_free_fermion(L) - ref) <= 1e-12


def test_golden_chain_path_ed_L20():
    """The golden chain's path ED at L=20 with right height 0 (4181
    admissible paths) against the JAX package's -13.91477894600401, and
    its path basis equal to JAX's."""
    cat = tcat.fibonacci_category()
    Hp, paths = cat.chain_hamiltonian_dense(1, 0, 20, left=0, right=0)
    assert len(paths) == 4181
    assert np.array_equal(paths, jcat.fibonacci_category().path_basis(
        1, 20, left=0, right=0))
    e = float(np.linalg.eigvalsh(Hp)[0])
    assert abs(e - (-13.91477894600401)) <= 1e-10


@pytest.mark.parametrize("name", ["rep_s3", "rep_a4"])
def test_multiplicity_categories_match_jax(name):
    """Rep(S3) and Rep(A4) (N[3,3,3] = 2) built by the port's copy: N and
    dual exactly, qdim, F and R to 1e-12, the general-multiplicity pentagon
    and hexagon, trivial monodromy; the lifted Ising category and the
    multiplicity path ED of the Rep(A4) chain against JAX's."""
    a, b = getattr(jmul, name)(), getattr(tmul, name)()
    assert isinstance(b, tmul.BraidedMultiplicityCategory)
    c = interop.category_from_numpy(a.name, a.sectors, a.qdim, a.N, a.F,
                                    a.dual, a.R)
    assert isinstance(c, tmul.BraidedMultiplicityCategory)
    assert np.array_equal(c.F, a.F) and np.array_equal(c.R, a.R)
    assert np.array_equal(a.N, b.N) and a.dual == b.dual
    for field in ("qdim", "F", "R"):
        np.testing.assert_allclose(getattr(b, field), getattr(a, field),
                                   rtol=0, atol=1e-12)
    b.check_fusion()
    b.check_unitarity()
    b.check_pentagon()
    b.check_hexagon()
    assert b.monodromy_is_trivial()
    lifted = tmul.lift_braided(tcat.ising_braided())
    lifted.check_pentagon()
    lifted.check_hexagon()
    if name == "rep_a4":
        Ha, _ = a.chain_hamiltonian_dense(3, 0, 4, left=0)
        Hb, _ = b.chain_hamiltonian_dense(3, 0, 4, left=0)
        np.testing.assert_allclose(np.linalg.eigvalsh(Hb),
                                   np.linalg.eigvalsh(Ha), atol=1e-12)
