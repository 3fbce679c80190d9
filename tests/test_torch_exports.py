"""The PyTorch port's top-level names against the JAX package's: every
name that `mpskit_tpu/__init__.py` binds is an attribute of
`mpskit_tpu_torch`, except those still waiting for their slice, and every
reference export of tests/test_export_parity.py is importable from the
port. The JAX package's names are read from its source with `ast`, so
that the check does not depend on which submodules other tests imported
first."""

import ast
from pathlib import Path

import pytest

import mpskit_tpu_torch
from test_export_parity import REFERENCE_EXPORTS

# names of the JAX package that the port does not have yet (ROADMAP.md,
# queue 1: MeshConfig comes with the device mesh, the last item)
WAITING = {"MeshConfig"}


def _jax_init_names():
    src = (Path(__file__).resolve().parents[1] / "mpskit_tpu"
           / "__init__.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")} | {"__version__"}


def test_every_jax_export_is_in_the_port():
    names = _jax_init_names()
    assert len(names) > 100 and WAITING <= names
    missing = sorted(n for n in names - WAITING
                     if not hasattr(mpskit_tpu_torch, n))
    assert not missing, missing
    # the waiting list holds only what is really missing
    assert not any(hasattr(mpskit_tpu_torch, n) for n in WAITING)


def test_reference_exports_in_the_port():
    missing = [n for n in REFERENCE_EXPORTS
               if not hasattr(mpskit_tpu_torch, n)]
    assert not missing, missing
    for n in ("l_LL", "l_RR", "l_RL", "l_LR",
              "r_LL", "r_RR", "r_RL", "r_LR"):
        assert hasattr(mpskit_tpu_torch.InfiniteMPS, n), n


@pytest.mark.parametrize("name", ["environments", "excitations",
                                  "time_evolve"])
def test_function_names_shadow_their_modules(name):
    """As in the JAX package, `environments` at the top level is the
    dispatching function (the subpackage stays importable by path), and the
    algorithm names are the functions."""
    import importlib

    assert callable(getattr(mpskit_tpu_torch, name))
    if name == "environments":
        mod = importlib.import_module("mpskit_tpu_torch.environments.finite")
        assert hasattr(mod, "finite_environments")


# names of the JAX package's symmetry/__init__.py that the port does not
# have yet: the category / anyon family (ROADMAP.md, queue-1 item 11b)
WAITING_SYMMETRY = {
    "FibonacciInfiniteMPS", "leading_boundary_fibonacci", "anyonic_entropy",
    "fibonacci_bond_labels", "FusionCategory", "BraidedCategory",
    "fibonacci_category", "ising_category", "zn_category",
    "fibonacci_braided", "ising_braided", "zn_braided", "su2k_category",
    "su2k_braided", "bond_labels", "chain_masks", "chain_bond_labels",
    "quantum_schmidt", "quantum_entropy", "AnyonicInfiniteMPS",
    "find_groundstate_anyonic", "AnyonicFiniteMPS",
    "find_groundstate_anyonic_dmrg2", "find_groundstate_anyonic_idmrg2",
    "anyon_bond_labels_finite", "anyon_masks_finite", "anyon_theta_mask",
    "anyon_split", "MultiplicityCategory", "BraidedMultiplicityCategory",
    "lift_braided", "rep_category", "rep_s3", "rep_a4",
}


def test_symmetry_exports_match_jax():
    """Every name of the JAX package's symmetry/__init__.py is in the
    port's `symmetry` package (the SU(2) family among them), except the
    category / anyon names still waiting for item 11b."""
    import mpskit_tpu_torch.symmetry as tsym

    src = (Path(__file__).resolve().parents[1] / "mpskit_tpu" / "symmetry"
           / "__init__.py").read_text()
    names = {a.asname or a.name for node in ast.parse(src).body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert WAITING_SYMMETRY <= names
    missing = sorted(n for n in names - WAITING_SYMMETRY
                     if not hasattr(tsym, n))
    assert not missing, missing
    assert not any(hasattr(tsym, n) for n in WAITING_SYMMETRY)
    for n in ("SU2ReducedState", "SU2FiniteMPS", "ReducedMPO",
              "excitations_su2_reduced", "SU2TDVP", "energy_reduced"):
        assert n in names and hasattr(tsym, n)


def _su2_inputs():
    import torch
    from mpskit_tpu_torch.symmetry import (
        SU2Bond, SU2FiniteMPS, SU2ReducedState, heisenberg_reduced,
    )

    mpo = heisenberg_reduced(2)
    st = SU2ReducedState.random(SU2Bond(((1, 2), (3, 1))), 2, device="cpu")
    fin = SU2FiniteMPS.random(4, 2, max_mult=2, device="cpu")
    return mpo, st, fin, torch


def test_su2_dispatch_branches_route(monkeypatch):
    """Each SU(2) branch of the dispatchers reaches its reduced solver:
    find_groundstate for SU2ReducedState (VUMPS) and SU2FiniteMPS (None,
    DMRG, DMRG2, SU2DMRG, SU2DMRG2), timestep, changebonds and
    excitations(ReducedMPO, ...) with its sector."""
    import importlib

    # the package re-exports these functions under their modules' names
    cb, fg, td, qp = (importlib.import_module(f"mpskit_tpu_torch.{m}") for m in
                      ("algorithms.changebonds", "algorithms.find_groundstate",
                       "algorithms.tdvp", "symmetry.su2_reduced_qp"))
    from mpskit_tpu_torch import (
        DMRG, DMRG2, TDVP, VUMPS, OptimalExpand, QuasiparticleAnsatz,
        changebonds, excitations, find_groundstate, timestep,
    )
    from mpskit_tpu_torch.symmetry import SU2DMRG, SU2DMRG2, SU2TDVP

    mpo, st, fin, torch = _su2_inputs()
    calls = []

    def spy(tag):
        def f(*a, **k):
            calls.append((tag, a, k))
            return a[0], 0.0, 0.0
        return f

    monkeypatch.setattr(fg, "find_groundstate_su2_reduced", spy("vumps"))
    monkeypatch.setattr(fg, "find_groundstate_su2_finite_dmrg", spy("dmrg"))
    monkeypatch.setattr(fg, "find_groundstate_su2_finite_dmrg2",
                        spy("dmrg2"))
    monkeypatch.setattr(td, "timestep_su2_finite_tdvp",
                        lambda p, H, a: (calls.append(("tdvp", a)) or p, 0.0))
    monkeypatch.setattr(cb, "expand_bond_reduced",
                        lambda p, H, b, extra_mult: (
                            calls.append(("expand", b, extra_mult)) or p))
    monkeypatch.setattr(qp, "excitations_su2_reduced",
                        lambda *a, **k: calls.append(("qp", a, k)) or (0, 0))

    find_groundstate(st, mpo, VUMPS(tol=1e-7, maxiter=3))
    assert calls[-1][0] == "vumps" and calls[-1][2]["maxiter"] == 3
    find_groundstate(st, mpo)
    assert calls[-1][0] == "vumps"
    for alg, tag, cls in ((DMRG(maxiter=2), "dmrg", SU2DMRG),
                          (DMRG2(maxiter=2), "dmrg2", SU2DMRG2),
                          (SU2DMRG(maxiter=3), "dmrg", SU2DMRG),
                          (SU2DMRG2(maxiter=3), "dmrg2", SU2DMRG2)):
        find_groundstate(fin, mpo, alg)
        assert calls[-1][0] == tag and isinstance(calls[-1][1][2], cls)
        assert calls[-1][1][2].maxiter == alg.maxiter
    n = len(calls)
    find_groundstate(fin, mpo)
    assert [c[0] for c in calls[n:]] == ["dmrg2"]   # eps 0 <= tol
    finc = fin.astype(torch.complex128)
    assert timestep(finc, mpo, 0.0, 0.1, TDVP(expalg_m=40))[1] is None
    assert calls[-1][0] == "tdvp" and calls[-1][1].dt == 0.1 \
        and calls[-1][1].krylovdim == 24
    timestep(finc, mpo, 0.0, 0.2, SU2TDVP(krylovdim=9))
    assert calls[-1][1].dt == 0.2 and calls[-1][1].krylovdim == 9
    changebonds(fin, mpo, OptimalExpand(dims=2))
    assert [c[1:] for c in calls[-3:]] == [(1, 2), (2, 2), (3, 2)]
    excitations(mpo, QuasiparticleAnsatz(tol=1e-6), 3.14, st, num=2)
    assert calls[-1][0] == "qp" and calls[-1][2]["tke"] == 2 \
        and calls[-1][2]["num"] == 2 and calls[-1][2]["tol"] == 1e-6
    excitations(mpo, QuasiparticleAnsatz(), [0.0, 3.14], st, sector=4)
    assert calls[-1][2]["tke"] == 4


def test_su2_dispatch_raises_where_jax_does():
    """TypeError where the JAX package raises it: a non-reduced operator on
    a reduced state, a finite-chain solver on the uniform state, a foreign
    solver on the finite chain, a non-OptimalExpand bond change, a
    non-QP excitation algorithm and an unknown keyword of the reduced
    excitations."""
    from mpskit_tpu_torch import (
        DMRG, IDMRG1, FiniteExcited, GradientGrassmann, OptimalExpand,
        QuasiparticleAnsatz, SvdCut, VUMPS, changebonds, excitations,
        find_groundstate, heisenberg_XXX,
    )

    mpo, st, fin, _ = _su2_inputs()
    H = heisenberg_XXX(spin=1)
    with pytest.raises(TypeError, match="ReducedMPO"):
        find_groundstate(st, H, VUMPS())
    with pytest.raises(TypeError, match="ReducedMPO"):
        find_groundstate(fin, H, DMRG())
    with pytest.raises(TypeError, match="VUMPS"):
        find_groundstate(st, mpo, DMRG())
    for alg in (VUMPS(), IDMRG1(), GradientGrassmann()):
        with pytest.raises(TypeError, match="DMRG"):
            find_groundstate(fin, mpo, alg)
    with pytest.raises(TypeError, match="OptimalExpand"):
        changebonds(fin, mpo, SvdCut())
    with pytest.raises(ValueError, match="Hamiltonian"):
        changebonds(fin, OptimalExpand())
    with pytest.raises(TypeError, match="QuasiparticleAnsatz"):
        excitations(mpo, FiniteExcited(), 0.0, st)
    with pytest.raises(TypeError, match="envs"):
        excitations(mpo, QuasiparticleAnsatz(), 0.0, st, envs=None)
