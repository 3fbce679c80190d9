"""Bond-dimension management of the PyTorch port (`changebonds` with
SvdCut, RandExpand, OptimalExpand, VUMPSSvdCut and chains of them) on
finite and infinite states, against the JAX package.

States are made by the port or by the JAX package and carried across as
numpy arrays, in float64 / complex128. SVD vectors and null-space bases
are not unique, so the tests compare overlaps and energies. The random
seeds of RandExpand and of the noise of the infinite OptimalExpand come
from a `torch.Generator` where the JAX package uses `PRNGKey(42)`: those
tests check the invariants (isometries, energy, entropy), not JAX's
numbers."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import dmrg as jdmrg
from mpskit_tpu.algorithms import expval as jexp
from mpskit_tpu.algorithms.changebonds import (
    OptimalExpand as JOptimalExpand, SvdCut as JSvdCut,
    VUMPSSvdCut as JVUMPSSvdCut, changebonds as jchangebonds,
)
from mpskit_tpu.environments import finite as jenv
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import finitemps as jmps
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu.tensors import ops as jops
from mpskit_tpu_torch import (
    DMRG, DMRG2, VUMPS, FiniteMPS, InfiniteMPS, OptimalExpand, RandExpand,
    SvdCut, VUMPSSvdCut, changebonds, entropy, expectation_value,
    find_groundstate, heisenberg_XXX, transverse_field_ising,
    transverse_field_ising_lattice, truncbelow, truncdim,
)
from mpskit_tpu_torch.algorithms.dmrg import _dmrg_sweep_impl
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.environments.finite import (
    compute_right_envs, right_boundary, stack_W,
)
from mpskit_tpu_torch.interop import finite_mps_from_numpy
from mpskit_tpu_torch.states.finitemps import support_mask

torch.set_num_threads(1)

# the JAX one-site sweep without buffer donation
_jax_sweep = partial(jax.jit, static_argnums=(6, 7),
                     static_argnames=("reorth", "use_fast", "cheap_galerkin")
                     )(jdmrg._dmrg_sweep_impl)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _to_jax_finite(p):
    return jmps.FiniteMPS(*(jnp.asarray(_np(t)) for t in (p.ALs, p.ARs,
                                                          p.AC)), p.center)


def _to_jax_infinite(p):
    return jimps.InfiniteMPS(*(jnp.asarray(_np(t))
                               for t in (p.AL, p.AR, p.AC, p.C)))


def _isometry_error(psi):
    eye = torch.eye(psi.D, dtype=psi.dtype)
    return max(float((torch.einsum("lpm,lpn->mn", A.conj(), A) - eye)
                     .abs().max()) for A in psi.AL)


def _tfim_density(g):
    k, wk = np.polynomial.legendre.leggauss(200)
    return float(-np.sum(wk * np.sqrt(1 + g * g - 2 * g * np.cos(
        np.pi * (k + 1) / 2))) / 2)


def _vumps_state(g, D, seed):
    H = transverse_field_ising_lattice(g=g)
    psi = InfiniteMPS.random(1, 2, D, torch.float64, "cpu",
                             torch.Generator().manual_seed(seed))
    psi, _, _ = find_groundstate(psi, H, VUMPS(tol=1e-9, maxiter=150,
                                               verbosity=0))
    return psi, H


def test_svdcut_finite_keeps_the_state_and_matches_jax():
    """The JAX package's `test_svdcut_finite_overlap`: cutting below
    1e-12 leaves a DMRG ground state (TFIM L=8 D=16) invariant to 1e-8;
    cutting to 4 Schmidt values gives JAX's overlap to 1e-10."""
    L, D = 8, 16
    H = transverse_field_ising(g=1.3)
    psi = FiniteMPS.random(L, 2, D, torch.complex128, "cpu",
                           torch.Generator().manual_seed(0))
    psi, _, _ = find_groundstate(psi, H, DMRG(tol=1e-9, maxiter=40))
    cut = changebonds(psi, SvdCut(truncbelow(1e-12)))
    assert cut.D == D and cut.center == 0
    assert abs(abs(complex(psi.dot(cut))) - 1.0) < 1e-8
    cut4 = changebonds(psi, SvdCut(truncdim(4)))
    pj = _to_jax_finite(psi)
    cut4j = jchangebonds(pj, JSvdCut(jops.truncdim(4)))
    ov, ovj = abs(complex(psi.dot(cut4))), abs(complex(pj.dot(cut4j)))
    assert ov < 1 - 1e-8 and abs(ov - ovj) <= 1e-10
    assert abs(float(cut4.norm()) - 1.0) <= 1e-12


def test_svdcut_infinite_matches_jax():
    """A VUMPS state (TFIM g=1.5, D=8) cut to 5 Schmidt values per bond:
    the energy density equals JAX's within 1e-8; cutting below 1e-10 keeps
    it within 1e-6 of the exact density."""
    psi, H = _vumps_state(1.5, 8, 1)
    Hj = jham.transverse_field_ising_lattice(g=1.5)
    cut = changebonds(psi, SvdCut(truncdim(5)))
    cutj = jchangebonds(_to_jax_infinite(psi), JSvdCut(jops.truncdim(5)))
    e = float(expectation_value(cut, H)[0])
    ej = float(jexp.expectation_value(cutj, Hj)[0])
    assert abs(e - ej) <= 1e-8
    assert e > float(expectation_value(psi, H)[0])
    kept = changebonds(psi, SvdCut(truncbelow(1e-10)))
    assert abs(float(expectation_value(kept, H)[0]) - _tfim_density(1.5)) \
        < 1e-6


def test_finite_optimal_expand_matches_jax():
    """Complex128 spin-1 Heisenberg L=12, D 8 -> 16: the expanded state is
    the same state (overlap 1 - 1e-10), and one one-site DMRG sweep from
    it gives JAX's energy within 1e-8."""
    L, d, D0, extra = 12, 3, 8, 8
    Hj = jham.heisenberg_XXX(spin=1.0)
    H = heisenberg_XXX(spin=1.0)
    pj = jmps.FiniteMPS.random(jax.random.PRNGKey(3), L, d, D0,
                               dtype=jnp.complex128)
    pt = finite_mps_from_numpy(np.asarray(pj.ALs), np.asarray(pj.ARs),
                               np.asarray(pj.AC), 0, "cpu")
    opt = changebonds(pt, H, OptimalExpand(dims=extra))
    optj = jchangebonds(pj, Hj, JOptimalExpand(dims=extra))
    assert opt.D == D0 + extra and opt.center == 0
    assert abs(complex(opt.normalize().dot(pt))) >= 1 - 1e-10

    D = opt.D
    masks = support_mask(L, d, D)
    Wsj = jenv.stack_W(Hj, L).astype(jnp.complex128)
    GRsj = jenv.compute_right_envs(optj.ARs, Wsj,
                                   jenv.right_boundary(Wsj.shape[1], D,
                                                       jnp.complex128))
    lamj = _jax_sweep(optj.ALs, optj.ARs, optj.AC, Wsj, GRsj,
                      jnp.asarray(1e-8), 10, 1, masks=jnp.asarray(masks))[4]
    Ws = stack_W(H, L, torch.complex128, "cpu")
    with matmul_precision():
        GRs = compute_right_envs(opt.ARs, Ws,
                                 right_boundary(Ws.shape[1], D,
                                                torch.complex128, "cpu"))
        lam = _dmrg_sweep_impl(opt.ALs.clone(), opt.ARs.clone(),
                               opt.AC.clone(), Ws, GRs, 1e-8, 10, 1,
                               masks=torch.from_numpy(masks))[4]
    assert abs(lam - float(lamj)) <= 1e-8


@pytest.mark.parametrize("alg", ["optimal", "random"])
def test_infinite_expand_on_a_three_site_cell(alg):
    """The JAX package's period-3 regression: after expansion every AL is
    an isometry to 1e-10, the entropy is not NaN (the new Schmidt
    directions carry exact zeros), and the energy is kept to 1e-7."""
    psi = InfiniteMPS.random(3, 2, 4, torch.complex128, "cpu",
                             torch.Generator().manual_seed(7))
    H = transverse_field_ising_lattice(g=1.2, period=3)
    grown = (changebonds(psi, H, OptimalExpand(dims=2)) if alg == "optimal"
             else changebonds(psi, RandExpand(dims=2)))
    assert grown.period == 3 and grown.D == 6
    assert _isometry_error(grown) <= 1e-10
    for bond in range(3):
        assert not np.isnan(float(entropy(grown, bond)))
    np.testing.assert_allclose(_np(expectation_value(grown, H)),
                               _np(expectation_value(psi, H)), rtol=0,
                               atol=1e-7)


def test_infinite_optimal_expand_keeps_a_ground_state():
    """A VUMPS state at D=6 grown by 6 directions: D becomes 12, the
    energy density is kept to 1e-7, and VUMPS in the larger space gets
    closer to the exact density."""
    psi, H = _vumps_state(1.5, 6, 2)
    e_small = float(expectation_value(psi, H)[0])
    grown = changebonds(psi, H, OptimalExpand(dims=6))
    assert grown.D == 12 and _isometry_error(grown) <= 1e-10
    assert abs(float(expectation_value(grown, H)[0]) - e_small) < 1e-7
    grown, envs, _ = find_groundstate(grown, H, VUMPS(tol=1e-9, maxiter=60,
                                                      verbosity=0))
    e0 = _tfim_density(1.5)
    assert abs(float(envs.e_density) - e0) < abs(e_small - e0)


def test_vumpssvdcut_matches_jax():
    """VUMPSSvdCut on a one-site VUMPS state (TFIM g=1.2, D=6): the cell
    doubles, and the energy density equals JAX's within 1e-8 and the exact
    one within 1e-5."""
    psi, H = _vumps_state(1.2, 6, 3)
    Hj = jham.transverse_field_ising_lattice(g=1.2)
    cut = changebonds(psi, H, VUMPSSvdCut(truncbelow(1e-8)))
    cutj = jchangebonds(_to_jax_infinite(psi), Hj,
                           JVUMPSSvdCut(jops.truncbelow(1e-8)))
    assert cut.period == 2 and cut.D == 6
    e = np.mean(_np(expectation_value(cut, H)))
    ej = float(np.mean(np.asarray(jexp.expectation_value(cutj, Hj))))
    assert abs(e - ej) <= 1e-8
    assert abs(e - _tfim_density(1.2)) < 1e-5


def test_chained_changebonds():
    """`OptimalExpand() & SvdCut()` as a ChainedAlg: on a finite state D
    grows by 4 and the cut to the old D keeps the state; on an infinite
    state RandExpand then a cut keeps the energy."""
    H = heisenberg_XXX(spin=1)
    psi = FiniteMPS.random(6, 3, 8, torch.complex128, "cpu",
                           torch.Generator().manual_seed(4))
    out = changebonds(psi, H, OptimalExpand(dims=4) & SvdCut(truncdim(8)))
    assert out.D == 12
    assert abs(complex(out.dot(psi))) >= 1 - 1e-10
    psi_inf, Hi = _vumps_state(1.5, 6, 5)
    out = changebonds(psi_inf, RandExpand(dims=2) & SvdCut(truncdim(6)))
    assert out.D == 8
    assert abs(float(expectation_value(out, Hi)[0])
               - float(expectation_value(psi_inf, Hi)[0])) < 1e-7


@pytest.mark.parametrize("name,item", [("SU2FiniteMPS", 11),
                                       ("MPSMultiline", 9), ("DenseMPO", 9),
                                       ("MPOMultiline", 9)])
def test_branches_not_ported_raise(name, item):
    """The branches that items 9 and 11 brought: the multi-row and MPO
    branches return their own container, the SU(2)-reduced chain takes
    OptimalExpand only and a stand-in raises TypeError; misuse raises the
    matching error."""
    if item == 9:
        from mpskit_tpu_torch import (
            DenseMPO, MPOMultiline, MPSMultiline, classical_ising,
        )

        row = InfiniteMPS.random(1, 2, 6, torch.complex128, "cpu",
                                 torch.Generator().manual_seed(6))
        state = {"MPSMultiline": MPSMultiline((row, row)),
                 "DenseMPO": classical_ising(),
                 "MPOMultiline": MPOMultiline.from_mpo(classical_ising(), 2)
                 }[name]
        out = changebonds(state, SvdCut(truncdim(4)), device="cpu")
        assert type(out) is type(state)
        rows = out.rows if name != "DenseMPO" else (out,)
        for r in rows:
            if isinstance(r, DenseMPO):
                assert r.site(0).shape[2:] == (2, 2)
            else:   # a cut is a mask: at most 4 nonzero Schmidt values
                S = torch.linalg.svdvals(r.C[0])
                assert int((S > 1e-12).sum()) <= 4 < r.D
    else:
        # item 11's SU2FiniteMPS is ported (tests/test_torch_su2_finite.py):
        # a stand-in is no state, and the reduced chain takes OptimalExpand
        # only, as in the JAX package
        from mpskit_tpu_torch.symmetry import SU2FiniteMPS
        with pytest.raises(TypeError):
            changebonds(type(name, (), {})(), SvdCut())
        su2 = SU2FiniteMPS.random(4, 2, max_mult=2, device="cpu")
        with pytest.raises(TypeError, match="OptimalExpand"):
            changebonds(su2, SvdCut())
    H = transverse_field_ising_lattice(g=1.5)
    fin = FiniteMPS.random(4, 2, 4, torch.float64, "cpu",
                           torch.Generator().manual_seed(6))
    inf = InfiniteMPS.random(1, 2, 4, torch.float64, "cpu",
                             torch.Generator().manual_seed(6))
    with pytest.raises(ValueError, match="Hamiltonian"):
        changebonds(fin, OptimalExpand())
    with pytest.raises(ValueError, match="InfiniteMPS"):
        changebonds(fin, H, VUMPSSvdCut())
    # RealSpaceParallelDMRG (item 10) is ported: it runs on a FiniteMPS,
    # and a stand-in that only carries its name is no solver
    from mpskit_tpu_torch import RealSpaceParallelDMRG

    with pytest.raises(TypeError, match="does not run"):
        find_groundstate(inf, H, RealSpaceParallelDMRG())
    rsdmrg = type("RealSpaceParallelDMRG", (), {})()
    with pytest.raises(TypeError):
        find_groundstate(inf, H, rsdmrg)
    with pytest.raises(TypeError, match="DMRG2 does not run"):
        find_groundstate(inf, H, DMRG2())
