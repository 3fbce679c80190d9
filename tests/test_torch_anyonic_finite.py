"""The sector-resolved anyonic DMRG2 / IDMRG2 of the PyTorch port
(symmetry/anyonic_finite.py) against the JAX package on the CPU, float64:
bond labels, site and window masks, the per-sector split, DMRG2 on the
configurations of tests/test_anyonic_dmrg2.py and IDMRG2 of the Ising
sigma chain. Both packages start from the same numbers: the JAX states are
made from PRNGKeys and carried across with `interop`; the categories are
the port's own copies, checked equal to JAX's in test_torch_category.py.
Singular-vector signs may differ between the packages, so the split is
compared through its Schmidt values, labels, error and the gauge-invariant
product AL diag(S) AR."""

import jax
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import expectation_value as jexpval
from mpskit_tpu.algorithms.dmrg2 import DMRG2 as JDMRG2
from mpskit_tpu import models as jmodels
from mpskit_tpu import symmetry as jsym
from mpskit_tpu_torch import DMRG2, expectation_value, interop, models
from mpskit_tpu_torch import symmetry as tsym

torch.set_num_threads(1)


def _cats():
    return {"fib": (jsym.fibonacci_category(), tsym.fibonacci_category()),
            "ising": (jsym.ising_category(), tsym.ising_category()),
            "z3": (jsym.zn_category(3), tsym.zn_category(3)),
            "a4": (jsym.rep_a4(), tsym.rep_a4())}


def _carry_finite(sj, tcat):
    p = sj.state
    return interop.anyonic_finite_mps_from_numpy(
        *(np.asarray(x) for x in (p.ALs, p.ARs, p.AC)), p.center, tcat,
        sj.anyon, sj.labels, device="cpu")


def _leak(spsi) -> float:
    """Largest entry of AL / AR / AC off the site masks of the labels."""
    m = torch.as_tensor(spsi.masks)
    p = spsi.state
    return max(float((p.ALs * ~m).abs().max()),
               float((p.ARs * ~m).abs().max()),
               float((p.AC * ~m[0]).abs().max()))


def _path_ed(cat, x, L, right):
    Hp, paths = cat.chain_hamiltonian_dense(x, 0, L, left=0, right=right)
    return float(np.linalg.eigvalsh(Hp)[0]), len(paths)


@pytest.mark.parametrize("name,D,L", [("fib", 16, 8), ("fib", 10, 12),
                                      ("ising", 16, 10), ("z3", 8, 6),
                                      ("fib", 256, 32), ("a4", 12, 6)])
def test_labels_and_masks_match_jax(name, D, L):
    """anyon_bond_labels_finite, anyon_masks_finite and anyon_theta_mask
    equal the JAX package's exactly (np.array_equal)."""
    jc, tc = _cats()[name]
    x = 3 if name == "a4" else 1
    a = jsym.anyon_bond_labels_finite(jc, x, D, L)
    b = tsym.anyon_bond_labels_finite(tc, x, D, L)
    assert len(a) == len(b) == L + 1
    for u, v in zip(a, b):
        assert np.array_equal(u, v)
    assert np.array_equal(jsym.anyon_masks_finite(jc, x, a),
                          tsym.anyon_masks_finite(tc, x, b))
    for i in range(0, L - 1, max(1, L // 4)):
        assert np.array_equal(jsym.anyon_theta_mask(jc, x, a[i], a[i + 2]),
                              tsym.anyon_theta_mask(tc, x, b[i], b[i + 2]))


@pytest.mark.parametrize("D", [6, 16])
def test_split_matches_jax(D):
    """anyon_split of one masked golden-chain theta (L=12, truncating at D=6,
    nearly untruncated at D=16): Schmidt values, middle labels and error to 1e-12, the
    product AL diag(S) AR to 1e-12, AL flat-left-isometric and AR
    per-block right-isometric."""
    jc, tc = _cats()["fib"]
    labels = jsym.anyon_bond_labels_finite(jc, 1, D, 12)
    cl, cr = labels[5], labels[7]
    mask = jsym.anyon_theta_mask(jc, 1, cl, cr)
    rng = np.random.default_rng(5)
    theta = rng.normal(size=mask.shape) * mask
    ALj, Sj, ARj, labj, errj = jsym.anyon_split(theta, cl, cr, jc, 1, D)
    ALt, St, ARt, labt, errt = tsym.anyon_split(torch.as_tensor(theta), cl,
                                                cr, tc, 1, D)
    assert np.array_equal(labj, labt)
    np.testing.assert_allclose(St.numpy(), Sj, atol=1e-12)
    # err = sqrt(discarded / total): compare its square, the computed
    # quantity, which cancels to rounding where nothing is discarded
    assert abs(errt ** 2 - errj ** 2) <= 1e-12
    assert (errj > 1e-3) == (D == 6)
    prod = np.einsum("lpm,m,mqr->lpqr", ALt.numpy(), St.numpy(), ARt.numpy())
    ref = np.einsum("lpm,m,mqr->lpqr", ALj, Sj, ARj)
    np.testing.assert_allclose(prod, ref, atol=1e-12)
    A = ALt.numpy().reshape(-1, D)
    live = labt >= 0
    np.testing.assert_allclose(A.T @ A, np.diag(live.astype(float)),
                               atol=1e-12)
    R = ARt.numpy().reshape(D, -1)
    for q in set(labt[live].tolist()):
        rows = np.where(labt == q)[0]
        np.testing.assert_allclose(R[rows] @ R[rows].T, np.eye(len(rows)),
                                   atol=1e-12)


def test_random_start_is_masked_and_seeded():
    """AnyonicFiniteMPS.random: no entry off the masks, right tensors
    per-sector row-orthonormal, the same numbers from the same generator
    seed and other numbers from another."""
    _, tc = _cats()["ising"]
    a = tsym.AnyonicFiniteMPS.random(tc, 1, 12, 10, device="cpu")
    b = tsym.AnyonicFiniteMPS.random(tc, 1, 12, 10, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    c = tsym.AnyonicFiniteMPS.random(tc, 1, 12, 10, device="cpu",
                                     generator=torch.Generator().manual_seed(1))
    assert _leak(a) == 0.0
    assert torch.equal(a.state.ARs, b.state.ARs)
    assert not torch.equal(a.state.ARs, c.state.ARs)
    for j in range(1, 10):
        lab = a.labels[j]
        R = a.state.ARs[j].reshape(12, -1).numpy()
        for q in set(lab[lab >= 0].tolist()):
            rows = np.where(lab == q)[0]
            np.testing.assert_allclose(R[rows] @ R[rows].T,
                                       np.eye(len(rows)), atol=1e-12)


# the configurations of tests/test_anyonic_dmrg2.py:28-147 (key, category,
# L, D, maxiter, tol); "exact" rows are full rank and held to path ED
DMRG2_CASES = {
    "golden_full": (0, "fib", 8, 16, 30, 1e-11, True),
    "sigma": (1, "ising", 10, 16, 40, 1e-11, True),
    "golden_truncated": (2, "fib", 12, 10, 30, 1e-10, False),
    "z3_anchor": (3, "z3", 6, 8, 30, 1e-11, True),
}


def _hamiltonians(name):
    if name == "fib":
        return jmodels.golden_chain(), models.golden_chain()
    if name == "ising":
        return jmodels.ising_anyon_chain(), models.ising_anyon_chain()
    jc, tc = _cats()[name]
    return jmodels.anyon_chain(jc, 1), models.anyon_chain(tc, 1)


@pytest.mark.parametrize("case", list(DMRG2_CASES))
def test_dmrg2_matches_jax(case):
    """find_groundstate_anyonic_dmrg2 from the carried JAX start: the
    energy within 1e-9 of the JAX package's (full-rank cases: within 1e-10
    of path ED), the final labels equal, Schmidt norms 1 to 1e-10, the
    quantum entropy to 1e-8 and no entry off the masks."""
    key, name, L, D, maxiter, tol, exact = DMRG2_CASES[case]
    jc, tc = _cats()[name]
    Hj, Ht = _hamiltonians(name)
    sj = jsym.AnyonicFiniteMPS.random(jax.random.PRNGKey(key), jc, 1, D, L)
    st = _carry_finite(sj, tc)
    sj, envj, _ = jsym.find_groundstate_anyonic_dmrg2(
        sj, Hj, JDMRG2(tol=tol, maxiter=maxiter))
    st, envt, _ = tsym.find_groundstate_anyonic_dmrg2(
        st, Ht, DMRG2(tol=tol, maxiter=maxiter))
    Ej = float(jexpval(sj.state, Hj, envs=envj))
    Et = float(np.real(expectation_value(st.state, Ht, envs=envt)))
    assert abs(Et - Ej) <= 1e-9, (Et, Ej)
    e_ref, npaths = _path_ed(tc, 1, L, int(st.labels[-1][0]))
    if exact:
        assert abs(Et - e_ref) <= 1e-10, (Et, e_ref)
    else:
        assert npaths > D and e_ref - 1e-9 <= Et <= e_ref + 5e-3
    for a, b in zip(sj.labels, st.labels):
        assert np.array_equal(a, b)
    for b in range(1, L):
        assert abs(float(np.sum(st._bond_S(b) ** 2)) - 1.0) <= 1e-10
    if name != "z3":   # Z_3's chain is the zero operator: any state
        assert abs(st.entropy(L // 2) - sj.entropy(L // 2)) <= 1e-8
    assert _leak(st) == 0.0


def test_rep_a4_multiplicity_chain_against_path_ed():
    """Sector DMRG2 on the Rep(A4) chain of anyon 3 (N[3,3,3] = 2, physical
    dimension n m = 8) at full rank, complex128: the multiplicity path ED
    energy to 1e-9, no entry off the masks, finite quantum entropy (the
    JAX slow test's configuration, tests/test_multiplicity_chain.py:
    102-138)."""
    _, tc = _cats()["a4"]
    x, L = 3, 5
    probe = tsym.anyon_bond_labels_finite(tc, x, 256, L)
    D = max(int(np.sum(lab >= 0)) for lab in probe)
    H = tc.chain_mpo(x, 0, period=1, dtype=np.complex128)
    spsi = tsym.AnyonicFiniteMPS.random(tc, x, D, L, dtype=torch.complex128,
                                        device="cpu")
    right = int(spsi.labels[-1][0])
    Hp, _ = tc.chain_hamiltonian_dense(x, 0, L, left=0, right=right)
    e_ref = float(np.linalg.eigvalsh(Hp)[0])
    spsi, envs, _ = tsym.find_groundstate_anyonic_dmrg2(
        spsi, H, DMRG2(tol=1e-11, maxiter=40))
    E = float(np.real(expectation_value(spsi.state, H, envs=envs)))
    assert abs(E - e_ref) <= 1e-9, (E, e_ref)
    assert _leak(spsi) == 0.0
    assert np.isfinite(spsi.entropy(L // 2))


def test_idmrg2_sigma_chain_matches_jax():
    """find_groundstate_anyonic_idmrg2 of the Ising sigma chain at D=8
    from the carried JAX start (10 passes): the energy per site within
    1e-8 of the JAX package's, labels equal, the bipartite sector
    structure found, the masks kept exactly."""
    jc, tc = _cats()["ising"]
    Hj = jmodels.ising_anyon_chain(period=2)
    Ht = models.ising_anyon_chain(period=2)
    sj = jsym.AnyonicInfiniteMPS.random(jax.random.PRNGKey(0), jc, 1, D=8,
                                        L=2, seed=(1,))
    p = sj.state
    st = interop.anyonic_infinite_mps_from_numpy(
        *(np.asarray(x) for x in (p.AL, p.AR, p.AC, p.C)), tc, 1, sj.labels,
        device="cpu")
    sj, envj, dCj = jsym.find_groundstate_anyonic_idmrg2(
        sj, Hj, JDMRG2(tol=1e-12, maxiter=10, verbosity=0))
    st, envt, dCt = tsym.find_groundstate_anyonic_idmrg2(
        st, Ht, DMRG2(tol=1e-12, maxiter=10, verbosity=0))
    ej = float(np.mean(np.real(np.asarray(jexpval(sj.state, Hj,
                                                  envs=envj)))))
    et = float(np.mean(np.real(np.asarray(expectation_value(
        st.state, Ht, envs=envt)))))
    assert abs(et - ej) <= 1e-8, (et, ej)
    assert abs(dCt - dCj) <= 1e-8
    assert st.labels == sj.labels
    assert {frozenset(r) for r in st.labels} == {frozenset({0, 2}),
                                                 frozenset({1})}
    A_mask, _ = st.masks
    assert float((st.state.AL * ~torch.as_tensor(A_mask)).abs().max()) == 0
    assert abs(et - (-0.5 - 1 / np.pi)) < 2e-3
