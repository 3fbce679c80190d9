"""The anyonic infinite states of the PyTorch port (symmetry/anyonic.py,
symmetry/fibonacci.py) and the sector-masked boundary paths they run
(algorithms/statmech.py, environments/infinite_mpo.py) against the JAX
package on the CPU, float64 / complex128: masked VUMPS of the Ising sigma
chain, the Fibonacci labels, masks and environment mask, `grow`, both
quantum-trace entropies, the masked environments, masked VOMPS / VUMPS
boundary steps and `leading_boundary_fibonacci` on the hard-hexagon MPO,
the checkpoint round trip, and the TypeError of `find_groundstate` on an
anyonic state. The JAX states are made from PRNGKeys and carried across
with `interop`.

A masked boundary state is rank deficient (its AC and C lose rank in the
fixed sector split), so the QR gauge steps fix AL only up to the null
columns, which LAPACK and XLA fill differently: the two packages' boundary
runs leave each other after the first gauge step, and are held together
through gauge-invariant numbers (eigenvalues, Schmidt values, C and AC)
one step at a time, and through the oracle over whole runs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import vumps as jvumps
from mpskit_tpu.models import hard_hexagon_fibonacci as jhh
from mpskit_tpu.models import ising_anyon_chain as jising_chain
from mpskit_tpu.operators.mpo import DenseMPO as JDenseMPO
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu import symmetry as jsym
from mpskit_tpu.symmetry import fibonacci as jfib
from mpskit_tpu_torch import (
    InfiniteMPS, VUMPS, expectation_value, find_groundstate, interop, load_state,
    save_state,
)
from mpskit_tpu_torch.algorithms import statmech as tsm
from mpskit_tpu_torch.algorithms import vumps as tvumps
from mpskit_tpu_torch.algorithms.dmrg2 import DMRG2
from mpskit_tpu_torch.algorithms.statmech import VUMPS_Boundary
from mpskit_tpu_torch.models import hard_hexagon_fibonacci, ising_anyon_chain
from mpskit_tpu_torch import symmetry as tsym
from mpskit_tpu_torch.symmetry import fibonacci as tfib

jsm = importlib.import_module("mpskit_tpu.algorithms.statmech")
jenv = importlib.import_module("mpskit_tpu.environments.infinite_mpo")
tenv = importlib.import_module("mpskit_tpu_torch.environments.infinite_mpo")

torch.set_num_threads(1)

E_SIGMA = -0.5 - 1.0 / np.pi


def _leaves(p):
    return [np.asarray(x) for x in (p.AL, p.AR, p.AC, p.C)]


def _carry_anyonic(sj):
    return interop.anyonic_infinite_mps_from_numpy(
        *_leaves(sj.state), tsym.ising_category(), sj.anyon, sj.labels,
        device="cpu")


def _carry_fib(sj):
    return interop.fibonacci_infinite_mps_from_numpy(
        *_leaves(sj.state), sj.labels, device="cpu")


def _leak(t, mask) -> float:
    return float((t * ~torch.as_tensor(np.asarray(mask))).abs().max())


def _schmidt(C):
    return np.linalg.svd(np.asarray(C), compute_uv=False)


@pytest.fixture(scope="module")
def sigma_start():
    return jsym.AnyonicInfiniteMPS.random(jax.random.PRNGKey(3),
                                          jsym.ising_category(), 1, D=8,
                                          L=2, seed=(1,))


def test_masked_vumps_iteration_matches_jax(sigma_start):
    """One masked VUMPS iteration of the sigma chain at D=8 from the
    carried JAX start, inner tolerance 1e-12: eps to 1e-10, each bond's
    Schmidt values and the solved AC's magnitudes to 1e-10, nothing off the
    masks."""
    sj = sigma_start
    st = _carry_anyonic(sj)
    Am, Cm = sj.masks
    out_j = jvumps._vumps_iteration(sj.state, jising_chain(period=2), 20, 4,
                                    1e-12, 1e-12, 1e-12,
                                    A_mask=jnp.asarray(Am),
                                    C_mask=jnp.asarray(Cm))
    out_t = tvumps._vumps_iteration_impl(
        st.state, ising_anyon_chain(period=2), 20, 4, 1e-12, 1e-12, 1e-12,
        A_mask=torch.as_tensor(Am), C_mask=torch.as_tensor(Cm))
    assert abs(float(out_t[1]) - float(out_j[1])) <= 1e-10
    pj, pt = out_j[0], out_t[0]
    for i in range(2):
        np.testing.assert_allclose(_schmidt(pt.C[i]), _schmidt(pj.C[i]),
                                   atol=1e-10)
    # the effective Hamiltonian is block diagonal over the sectors, so a
    # solved AC is fixed up to a sign per sector block
    np.testing.assert_allclose(pt.AC.abs().numpy(), np.abs(np.asarray(pj.AC)),
                               atol=1e-10)
    assert _leak(pt.AL, Am) == 0.0 and _leak(pt.AR, Am) == 0.0


def test_masked_vumps_sigma_chain(sigma_start):
    """find_groundstate_anyonic of the sigma chain from the carried JAX
    start (the JAX slow test's seed and settings, at D=8 and D=12):
    converged, no entry off the masks, both bond entropies finite, the
    energy per site within 2e-2 (D=8) and 1e-3 (D=12) of -1/2 - 1/pi.
    Masked VUMPS stalls above the exact energy at a fixed point that does
    not fall with D (2e-4 to 5e-4 at D=12-64 from random starts in the
    port): from this D=12 start the port stops 5.3e-4 above it and the JAX
    package 2.6e-3 above it, outside its own slow test's 5e-4."""
    H = ising_anyon_chain(period=2)
    sj12 = jsym.AnyonicInfiniteMPS.random(jax.random.PRNGKey(3),
                                          jsym.ising_category(), 1, D=12,
                                          L=2, seed=(1,))
    for sj, gate in ((sigma_start, 2e-2), (sj12, 1e-3)):
        st, envs, eps = tsym.find_groundstate_anyonic(
            _carry_anyonic(sj), H, VUMPS(tol=1e-8, maxiter=200, verbosity=0))
        assert eps < 1e-6
        e = float(np.mean(np.real(np.asarray(
            expectation_value(st.state, H, envs=envs)))))
        assert abs(e - E_SIGMA) < gate, (e, E_SIGMA)
        A_mask, _ = st.masks
        assert _leak(st.state.AL, A_mask) == 0.0
        assert np.isfinite(st.entropy(0)) and np.isfinite(st.entropy(1))


def test_fibonacci_labels_masks_and_env_mask_match_jax():
    """fibonacci_bond_labels, fibonacci_masks (L=1, 3) and
    fibonacci_env_mask equal the JAX package's; the chain labels of the
    category layer too."""
    for D in (5, 8, 16, 64):
        a, b = jfib.fibonacci_bond_labels(D), tfib.fibonacci_bond_labels(D)
        assert np.array_equal(a, b)
        for L in (1, 3):
            for x, y in zip(jfib.fibonacci_masks(a, L),
                            tfib.fibonacci_masks(b, L)):
                assert np.array_equal(x, y)
        assert np.array_equal(jfib.fibonacci_env_mask(a),
                              tfib.fibonacci_env_mask(b))
    for seed in (None, (1,)):
        assert np.array_equal(
            jsym.chain_bond_labels(jsym.ising_category(), 1, 12, 2, seed),
            tsym.chain_bond_labels(tsym.ising_category(), 1, 12, 2, seed))


def test_random_and_grow():
    """FibonacciInfiniteMPS.random is masked and seeded by its generator;
    grow keeps the sector blocks in their new slots (with no noise the
    labels and the Schmidt values equal JAX's grow, to 1e-12) and stays
    masked with noise."""
    sp = tfib.FibonacciInfiniteMPS.random(8, L=1, dtype=torch.complex128,
                                          device="cpu")
    again = tfib.FibonacciInfiniteMPS.random(
        8, L=1, dtype=torch.complex128, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(sp.state.AL, again.state.AL)
    A_mask, C_mask = sp.masks
    assert _leak(sp.state.AL, A_mask) == 0.0
    assert _leak(sp.state.C, C_mask) == 0.0
    sj = jfib.FibonacciInfiniteMPS.random(jax.random.PRNGKey(7), 8, L=1,
                                          dtype=jnp.complex128)
    grown_j = sj.grow(jax.random.PRNGKey(8), 13, noise=0.0)
    st = _carry_fib(sj)
    grown = st.grow(13, noise=0.0)
    assert grown.labels == grown_j.labels and grown.state.D == 13
    np.testing.assert_allclose(_schmidt(grown.state.C[0]),
                               _schmidt(grown_j.state.C[0]), atol=1e-12)
    noisy = st.grow(13)
    A_mask, _ = noisy.masks
    assert _leak(noisy.state.AL, A_mask) == 0.0


def test_quantum_entropies_match_jax():
    """anyonic_schmidt / anyonic_entropy of a hand-built two-sector C equal
    the JAX package's to 1e-12, and AnyonicInfiniteMPS.schmidt / entropy
    of a carried state too."""
    lab = (0, 0, 1, 1, 1)
    C = np.zeros((5, 5))
    C[:2, :2] = np.diag([0.8, 0.3])
    C[2:, 2:] = np.diag([0.5, 0.2, 0.1])
    z = np.zeros((1, 5, 2, 5))
    sj = jfib.FibonacciInfiniteMPS(
        JInfiniteMPS(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                     jnp.asarray(C)[None]), lab)
    st = interop.fibonacci_infinite_mps_from_numpy(z, z, z, C[None], lab,
                                                   device="cpu")
    assert abs(tfib.anyonic_entropy(st) - jfib.anyonic_entropy(sj)) <= 1e-12
    pj, pt = jfib.anyonic_schmidt(sj), tfib.anyonic_schmidt(st)
    for a in (0, 1):
        np.testing.assert_allclose(pt[a], pj[a], atol=1e-12)
    s = jsym.AnyonicInfiniteMPS.random(jax.random.PRNGKey(1),
                                       jsym.ising_category(), 1, D=6, L=2,
                                       seed=(1,))
    t = _carry_anyonic(s)
    for b in (0, 1):
        assert abs(t.entropy(b) - s.entropy(b)) <= 1e-12


@pytest.fixture(scope="module")
def fib_start():
    return jfib.FibonacciInfiniteMPS.random(jax.random.PRNGKey(7), 8, L=1,
                                            dtype=jnp.complex128)


def _stacked(dtype=torch.complex128):
    Osj = jnp.stack([jhh().site(0)]).astype(jnp.complex128)
    Ost = tenv.stack_O(hard_hexagon_fibonacci(), 1, dtype, "cpu")
    return Osj, Ost


def test_masked_environments_match_jax(fib_start):
    """mpo_environments with env_mask and select_real on a carried masked
    state: the cell eigenvalue to 1e-12, the environments zero off the
    mask, and <C| GL GR |C> = 1 at the bond."""
    sj = fib_start
    st = _carry_fib(sj)
    M = tfib.fibonacci_env_mask(np.asarray(sj.labels))
    Osj, Ost = _stacked()
    ej = jenv.mpo_environments(sj.state, JDenseMPO((Osj[0],)),
                               env_mask=jnp.asarray(M), select_real=True)
    et = tenv.mpo_environments(st.state, Ost, env_mask=M, select_real=True)
    assert abs(et.lambda_cell - complex(ej.lambda_cell)) <= 1e-12
    assert _leak(et.GLs[0], M) == 0.0 and _leak(et.GRs[0], M) == 0.0
    v = torch.einsum("axy,yn,arn,xr->", et.GLs[0], st.state.C[0], et.GRs[0],
                     st.state.C[0].conj())
    assert abs(complex(v) - 1) <= 1e-12
    # the unmasked call on the same state is the plain one
    plain = tenv.mpo_environments(st.state, Ost)
    assert abs(plain.lambda_cell) >= abs(et.lambda_cell) - 1e-12


def test_masked_boundary_steps_match_jax(fib_start):
    """One masked VOMPS step and one masked VUMPS_Boundary iteration (the
    dominant real pair in the masked Krylov spaces) from the carried JAX
    state: the new C and AC to 1e-10 (the gauge-invariant outputs), AL, AR
    and AC zero off the masks."""
    sj = fib_start
    st = _carry_fib(sj)
    Am, Cm = sj.masks
    M = tfib.fibonacci_env_mask(np.asarray(sj.labels))
    Osj, Ost = _stacked()
    kw_j = dict(A_mask=jnp.asarray(Am), C_mask=jnp.asarray(Cm),
                env_mask=jnp.asarray(M))
    kw_t = dict(A_mask=torch.as_tensor(Am), C_mask=torch.as_tensor(Cm),
                env_mask=torch.as_tensor(M))
    vj = jsm._boundary_vomps_iteration(sj.state, Osj, 1e-14, 1e-12, **kw_j)
    vt = tsm._boundary_vomps_iteration(st.state, Ost, 1e-14, 1e-12, **kw_t)
    bj = jsm._boundary_vumps_iteration(sj.state, Osj, 30, 1e-14, 1e-12,
                                       1e-12, **kw_j)
    bt = tsm._boundary_vumps_iteration(st.state, Ost, 30, 1e-14, 1e-12,
                                       1e-12, **kw_t)
    for pj, pt in ((vj[0], vt[0]), (bj[0], bt[0])):
        np.testing.assert_allclose(pt.C.numpy(), np.asarray(pj.C),
                                   atol=1e-10)
        np.testing.assert_allclose(pt.AC.numpy(), np.asarray(pj.AC),
                                   atol=1e-10)
        for t in (pt.AL, pt.AR, pt.AC):
            assert _leak(t, Am) == 0.0


def test_leading_boundary_fibonacci_against_jax(fib_start):
    """leading_boundary_fibonacci at D=8 complex128 from the carried JAX
    start (the JAX slow test's configuration): lambda per site within the
    JAX test's 5e-3 of 0.8802 in both packages and within 1e-2 of each
    other (the runs part at the rank-deficient gauge steps), the masks kept
    to 1e-10, and the recovered-sector entropy anyonic_entropy_state equal
    to the labelled anyonic_entropy to 1e-9."""
    sj = fib_start
    alg_j = jsm.VUMPS_Boundary(tol=1e-8, maxiter=150, verbosity=0)
    out_j, envs_j, _ = jfib.leading_boundary_fibonacci(sj, jhh(), alg_j)
    st, envs, eps = tfib.leading_boundary_fibonacci(
        _carry_fib(sj), hard_hexagon_fibonacci(),
        VUMPS_Boundary(tol=1e-8, maxiter=150, verbosity=0))
    lam_t = abs(complex(envs.lambda_cell))
    lam_j = abs(complex(envs_j.lambda_cell))
    assert abs(lam_t - 0.8802) < 5e-3 and abs(lam_j - 0.8802) < 5e-3
    assert abs(lam_t - lam_j) < 1e-2
    A_mask, _ = st.masks
    assert _leak(st.state.AL, A_mask) < 1e-10
    S = tfib.anyonic_entropy(st)
    assert np.isfinite(S) and S > 0
    assert abs(tfib.anyonic_entropy_state(st.state)[0] - S) <= 1e-9


def test_final_environments_follow_the_iterations():
    """The environments leading_boundary_fibonacci returns are seeded by
    the last iteration's fixed points: after 6 iterations from this start
    the unseeded real-pair selection (the JAX package's) reads lambda
    0.419 per site, the seeded one the boundary's ~0.88."""
    sp = tfib.FibonacciInfiniteMPS.random(
        8, L=1, dtype=torch.complex128, device="cpu",
        generator=torch.Generator().manual_seed(1))
    sp, envs, _ = tfib.leading_boundary_fibonacci(
        sp, hard_hexagon_fibonacci(), VUMPS_Boundary(tol=1e-8, maxiter=6,
                                                     verbosity=0))
    assert abs(abs(complex(envs.lambda_cell)) - 0.8802) < 5e-3
    A_mask, _ = sp.masks
    assert _leak(sp.state.AL, A_mask) < 1e-10


def test_checkpoint_round_trip(tmp_path, sigma_start):
    """save_state / load_state of an AnyonicInfiniteMPS in the port: the
    leaves bit for bit, labels, anyon and the category rebuilt by name;
    a custom category's name raises TypeError on load."""
    import dataclasses

    st = _carry_anyonic(sigma_start)
    path = str(tmp_path / "a.npz")
    save_state(path, st)
    back = load_state(path, device="cpu")
    assert isinstance(back, tsym.AnyonicInfiniteMPS)
    assert back.labels == st.labels and back.anyon == st.anyon
    assert back.cat.name == "Ising"
    for a, b in zip((back.state.AL, back.state.AR, back.state.AC,
                     back.state.C), (st.state.AL, st.state.AR, st.state.AC,
                                     st.state.C)):
        assert torch.equal(a, b)
    odd = dataclasses.replace(st, cat=dataclasses.replace(st.cat,
                                                          name="mine"))
    save_state(str(tmp_path / "b.npz"), odd)
    with pytest.raises(TypeError, match="mine"):
        load_state(str(tmp_path / "b.npz"), device="cpu")


@pytest.mark.parametrize("kind", ["finite", "infinite", "fibonacci"])
def test_find_groundstate_names_the_anyonic_solvers(kind):
    """find_groundstate has no anyonic branch (as in the JAX package): an
    anyonic state raises TypeError naming the four anyonic solvers."""
    cat = tsym.ising_category()
    if kind == "finite":
        psi = tsym.AnyonicFiniteMPS.random(cat, 1, 4, 6, device="cpu")
    elif kind == "infinite":
        psi = tsym.AnyonicInfiniteMPS.random(cat, 1, 4, 2, seed=(1,),
                                             device="cpu")
    else:
        psi = tfib.FibonacciInfiniteMPS.random(4, L=1, device="cpu")
    for alg in (None, VUMPS(), DMRG2()):
        with pytest.raises(TypeError) as err:
            find_groundstate(psi, ising_anyon_chain(), alg)
        for name in ("find_groundstate_anyonic", "_dmrg2", "_idmrg2",
                     "leading_boundary_fibonacci"):
            assert name in str(err.value)
