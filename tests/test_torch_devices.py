"""The port's entry points build their tensors on the card unless the
caller asks for the CPU, and the environment helpers take the device from
their caller. Without a card the default raises torch's own CUDA error;
nothing falls back to the CPU. This file imports no jax."""

import numpy as np
import pytest
import torch

from mpskit_tpu_torch import (
    FiniteMPS, InfiniteMPS, transverse_field_ising_lattice,
)
from mpskit_tpu_torch.environments import finite as tenv
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, finite_qp_from_numpy, infinite_mps_from_numpy,
)

L, d, D = 4, 2, 4


def _arrays():
    rng = np.random.default_rng(0)
    As = rng.standard_normal((L, D, d, D))
    return As, As.copy(), rng.standard_normal((D, d, D))


def _infinite_arrays():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((1, D, d, D))
    return A, A.copy(), A.copy(), rng.standard_normal((1, D, D))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would work")


@pytest.mark.parametrize("entry", ["random", "from_numpy",
                                   "infinite_random", "infinite_from_numpy",
                                   "finite_qp_from_numpy", "mpo_to_mps",
                                   "changebonds_densempo", "from_dense",
                                   "exact_diagonalization", "isometry",
                                   "window_from_infinite", "purification_mps",
                                   "thermal_state", "propagator",
                                   "load_state", "symmetric_finite_random",
                                   "symmetric_infinite_random",
                                   "anyonic_finite_random",
                                   "anyonic_infinite_random",
                                   "fibonacci_random",
                                   "anyonic_infinite_from_numpy"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    _no_card()
    gen = torch.Generator().manual_seed(0)
    if entry == "load_state":
        from mpskit_tpu_torch import save_state

        path = str(tmp_path / "psi.npz")
        save_state(path, FiniteMPS.random(L, d, D, torch.float64, "cpu",
                                          gen))
    # CPU-only torch raises AssertionError ("not compiled with CUDA"), a
    # CUDA build without a device RuntimeError
    with pytest.raises((AssertionError, RuntimeError)):
        if entry == "random":
            FiniteMPS.random(L, d, D, torch.float64)
        elif entry == "from_numpy":
            finite_mps_from_numpy(*_arrays(), 0)
        elif entry == "infinite_random":
            InfiniteMPS.random(1, d, D, torch.float64)
        elif entry == "infinite_from_numpy":
            infinite_mps_from_numpy(*_infinite_arrays())
        elif entry == "mpo_to_mps":
            from mpskit_tpu_torch import classical_ising, mpo_to_mps

            mpo_to_mps(classical_ising())
        elif entry == "changebonds_densempo":
            from mpskit_tpu_torch import SvdCut, changebonds, classical_ising

            changebonds(classical_ising(), SvdCut())
        elif entry == "from_dense":
            FiniteMPS.from_dense(np.ones(2 ** L), d, D)
        elif entry == "exact_diagonalization":
            from mpskit_tpu_torch import exact_diagonalization

            exact_diagonalization(transverse_field_ising_lattice(), L)
        elif entry == "isometry":
            from mpskit_tpu_torch import isometry

            isometry(3, 2)
        elif entry == "window_from_infinite":
            from mpskit_tpu_torch import WindowMPS

            WindowMPS.from_infinite(InfiniteMPS.random(
                1, d, D, torch.float64, "cpu", gen), L)
        elif entry == "purification_mps":
            from mpskit_tpu_torch import purification_mps

            purification_mps(d, L, D)
        elif entry == "thermal_state":
            from mpskit_tpu_torch import thermal_state

            thermal_state(transverse_field_ising_lattice(), L, 0.1, 0.05, D)
        elif entry == "propagator":
            from mpskit_tpu_torch import propagator

            propagator(FiniteMPS.random(L, d, D, torch.float64, "cpu", gen),
                       0.5j, transverse_field_ising_lattice())
        elif entry == "load_state":
            from mpskit_tpu_torch import load_state

            load_state(path)
        elif entry == "symmetric_finite_random":
            from mpskit_tpu_torch import SymmetricFiniteMPS

            SymmetricFiniteMPS.random(L, (1, -1), D)
        elif entry == "symmetric_infinite_random":
            from mpskit_tpu_torch import SymmetricInfiniteMPS

            SymmetricInfiniteMPS.random(2, (1, -1), D)
        elif entry == "anyonic_finite_random":
            from mpskit_tpu_torch.symmetry import (
                AnyonicFiniteMPS, fibonacci_category,
            )

            AnyonicFiniteMPS.random(fibonacci_category(), 1, D, L)
        elif entry == "anyonic_infinite_random":
            from mpskit_tpu_torch.symmetry import (
                AnyonicInfiniteMPS, ising_category,
            )

            AnyonicInfiniteMPS.random(ising_category(), 1, D, 2, seed=(1,))
        elif entry == "fibonacci_random":
            from mpskit_tpu_torch.symmetry import FibonacciInfiniteMPS

            FibonacciInfiniteMPS.random(D, L=1)
        elif entry == "anyonic_infinite_from_numpy":
            from mpskit_tpu_torch.interop import (
                anyonic_infinite_mps_from_numpy,
            )
            from mpskit_tpu_torch.symmetry import fibonacci_category

            anyonic_infinite_mps_from_numpy(
                *_infinite_arrays(), fibonacci_category(), 1,
                ((0, 1, 1, 1),))
        else:
            As = _arrays()[0]
            finite_qp_from_numpy(As[:, :, :, :2].sum(1), As, As, As,
                                 np.ones((L, 2, D), bool))


def test_entry_points_on_the_cpu_when_asked():
    gen = torch.Generator().manual_seed(0)
    psi = FiniteMPS.random(L, d, D, torch.float64, "cpu", gen)
    assert psi.device.type == "cpu" and psi.AC.shape == (D, d, D)
    assert psi.ALs.device.type == psi.ARs.device.type == "cpu"
    ALs, ARs, AC = _arrays()
    carried = finite_mps_from_numpy(ALs, ARs, AC, 2, device="cpu")
    assert carried.device.type == "cpu" and carried.center == 2
    assert torch.equal(carried.AC, torch.from_numpy(AC))


def test_infinite_entry_points_on_the_cpu_when_asked():
    gen = torch.Generator().manual_seed(0)
    psi = InfiniteMPS.random(2, d, D, torch.float64, "cpu", gen)
    assert psi.device.type == "cpu" and psi.AC.shape == (2, D, d, D)
    assert psi.AL.device.type == psi.AR.device.type == psi.C.device.type
    AL, AR, AC, C = _infinite_arrays()
    carried = infinite_mps_from_numpy(AL, AR, AC, C, device="cpu")
    assert carried.device.type == "cpu" and carried.period == 1
    assert torch.equal(carried.C, torch.from_numpy(C))


@pytest.mark.parametrize("helper", ["left_boundary", "right_boundary",
                                    "stack_W"])
def test_environment_helpers_need_a_device(helper):
    H = transverse_field_ising_lattice(g=1.5)
    w = H.W.shape[1]
    args = ((H, L, torch.float64) if helper == "stack_W"
            else (w, D, torch.float64))
    fn = getattr(tenv, helper)
    with pytest.raises(TypeError):
        fn(*args)
    out = fn(*args, "cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float64


def test_time_evolution_stays_on_the_states_device():
    """timestep, TDVP2 and time_evolve keep a CPU state on the CPU; the
    host evolution MPO follows the state, in the promoted dtype."""
    from mpskit_tpu_torch import (
        TDVP2, WII, make_time_mpo, time_evolve, timestep,
    )
    from mpskit_tpu_torch.operators.apply import apply_densempo_finite

    H = transverse_field_ising_lattice(g=0.5)
    psi = FiniteMPS.random(L, d, D, torch.complex64, "cpu",
                           torch.Generator().manual_seed(0))
    for alg in (None, TDVP2()):
        out, _ = timestep(psi, H, 0.0, 0.05, alg)
        assert out.AC.device.type == "cpu" and out.AC.dtype == torch.complex64
    out, _ = time_evolve(psi, H, [0.0, 0.05], WII())
    assert out.AC.device.type == "cpu" and out.AC.dtype == torch.complex128
    U = make_time_mpo(H, 0.05, WII())
    assert isinstance(U.site(0), np.ndarray)
    assert apply_densempo_finite(U, psi).ARs.device.type == "cpu"


def test_excitations_and_grassmann_stay_on_the_states_device():
    """GradientGrassmann, the quasiparticle solves, the QP gauge change
    and FiniteExcited keep CPU states on the CPU; the energies come back
    as CPU tensors."""
    from mpskit_tpu_torch import (
        VUMPS, FiniteExcited, GradientGrassmann, QuasiparticleAnsatz,
        excitations, find_groundstate, left_to_right_gauge,
    )

    H = transverse_field_ising_lattice(g=1.5)
    gen = torch.Generator().manual_seed(0)
    psi = FiniteMPS.random(L, d, D, torch.float64, "cpu", gen)
    psi, envs, _ = find_groundstate(psi, H, GradientGrassmann(maxiter=5,
                                                              verbosity=0))
    assert psi.AC.device.type == "cpu" and envs.GLs.device.type == "cpu"
    for alg in (QuasiparticleAnsatz(tol=1e-6), FiniteExcited(maxiter=2)):
        es, states = excitations(H, alg, psi, num=1)
        assert es.device.type == "cpu" and es.dtype == torch.float64
        assert (states[0].ALs.device.type == "cpu")
    ipsi = InfiniteMPS.random(1, d, D, torch.complex128, "cpu", gen)
    ipsi, ienvs, _ = find_groundstate(
        ipsi, H, VUMPS(maxiter=3, verbosity=0)
        & GradientGrassmann(maxiter=2, verbosity=0))
    assert ipsi.AL.device.type == "cpu" and ienvs.GLs.device.type == "cpu"
    es, qps = excitations(H, QuasiparticleAnsatz(tol=1e-6, maxrestarts=2),
                          0.5, ipsi, envs=ienvs)
    assert es.shape == (1, 1) and qps[0][0].Xs.device.type == "cpu"
    assert left_to_right_gauge(qps[0][0]).Xs.device.type == "cpu"


def test_boundaries_stay_on_the_states_device():
    """leading_boundary (VUMPS_Boundary, VOMPS, GradientGrassmann, two
    rows), the DenseMPO expectation value, the boundary excitations,
    approximate and the DenseMPO changebonds keep CPU states on the CPU;
    the transfer MPOs stay host arrays and eigenvalues come back as host
    numbers or CPU tensors."""
    from mpskit_tpu_torch import (
        VOMPS, FitDMRG, FitIDMRG, GradientGrassmann, MPOMultiline,
        MPSMultiline, QuasiparticleAnsatz, SvdCut, VUMPS_Boundary,
        approximate, changebonds, classical_ising, excitations,
        expectation_value, finite_classical_ising, leading_boundary,
        mpo_to_mps,
    )

    O = classical_ising()
    assert isinstance(O.site(0), np.ndarray)
    gen = torch.Generator().manual_seed(0)
    psi = InfiniteMPS.random(1, d, D, torch.complex128, "cpu", gen)
    for alg in (VUMPS_Boundary(maxiter=2, verbosity=0),
                VOMPS(maxiter=2, verbosity=0),
                GradientGrassmann(maxiter=2, verbosity=0)):
        out, envs, _ = leading_boundary(psi, O, alg)
        assert out.AL.device.type == "cpu" and envs.GLs.device.type == "cpu"
    assert isinstance(expectation_value(out, O, envs=envs), complex)
    rows, renvs, _ = leading_boundary(
        MPSMultiline((psi, psi)), MPOMultiline.from_mpo(O, 2),
        VUMPS_Boundary(maxiter=1, verbosity=0))
    assert rows.rows[1].C.device.type == renvs[1].GRs.device.type == "cpu"
    lams, qps = excitations(O, QuasiparticleAnsatz(), [0.0], out, envs=envs,
                            tol=1e-4)
    assert lams.device.type == "cpu" and qps[0].Xs.device.type == "cpu"
    fit, _, _ = approximate(out, (O, out), FitIDMRG(maxiter=1, verbosity=0))
    assert fit.AL.device.type == "cpu"
    fpsi = FiniteMPS.random(L, d, D, torch.complex128, "cpu", gen)
    ffit, _, _ = approximate(fpsi, (finite_classical_ising(L), fpsi),
                             FitDMRG(maxiter=1))
    assert ffit.AC.device.type == "cpu"
    assert mpo_to_mps(O, "cpu").AL.device.type == "cpu"
    cut = changebonds(O, SvdCut(), device="cpu")
    assert isinstance(cut.site(0), np.ndarray)


def test_measurements_stay_on_the_states_device():
    """FiniteMPS.from_dense and exact_diagonalization build on the CPU
    when asked; transfer_spectrum, the correlators, the variance and the
    fidelity susceptibility return tensors on the state's device, and the
    models stay host arrays."""
    from mpskit_tpu_torch import (
        VUMPS, correlator, exact_diagonalization, fidelity_susceptibility,
        find_groundstate, hubbard, transfer_spectrum, variance,
    )

    psi = FiniteMPS.from_dense(np.ones(2 ** L) / 2 ** (L / 2), d, D,
                               device="cpu")
    assert psi.device.type == "cpu" and abs(float(psi.norm()) - 1) < 1e-12
    H = transverse_field_ising_lattice(g=1.5)
    es, states = exact_diagonalization(H, L, num=2, device="cpu")
    assert es.device.type == "cpu" and states[1].AC.device.type == "cpu"
    assert variance(states[0], H).device.type == "cpu"
    assert isinstance(hubbard(U=4.0).W, np.ndarray)
    ipsi = InfiniteMPS.random(1, d, D, torch.float64, "cpu",
                              torch.Generator().manual_seed(3))
    ipsi, envs, _ = find_groundstate(ipsi, H, VUMPS(maxiter=20, verbosity=0))
    lams = transfer_spectrum(ipsi, num=3)
    assert lams.device.type == "cpu" and lams.dtype == torch.complex128
    Z = np.diag([1.0, -1.0])
    assert correlator(ipsi, Z, Z, 0, [1, 2]).device.type == "cpu"
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    from mpskit_tpu_torch import MPOHamiltonian

    G = fidelity_susceptibility(ipsi, H, [MPOHamiltonian.from_local(-X)],
                                envs=envs, tol=1e-6)
    assert G.device.type == "cpu" and G.shape == (1, 1)


def test_windows_propagator_thermal_and_checkpoints_on_the_cpu(tmp_path):
    """WindowMPS.from_infinite, purification_mps, thermal_state,
    propagator and load_state build on the CPU when asked; window DMRG and
    window TDVP keep a CPU window there."""
    from mpskit_tpu_torch import (
        DMRG, TDVP, Window, WindowMPS, find_groundstate, load_state,
        propagator, purification_mps, save_state, thermal_state, timestep,
    )

    H = transverse_field_ising_lattice(g=1.5)
    gen = torch.Generator().manual_seed(0)
    ipsi = InfiniteMPS.random(1, d, D, torch.complex128, "cpu", gen)
    win = WindowMPS.from_infinite(ipsi, L, device="cpu")
    assert win.device.type == "cpu" and win.left_gs is ipsi
    out, _, _ = find_groundstate(win, H, DMRG(maxiter=2, verbosity=0))
    assert out.window.AC.device.type == "cpu"
    out, envs = timestep(win, Window(H), 0.0, 0.05, TDVP())
    assert out.window.AC.device.type == out.left_gs.AL.device.type == "cpu"
    assert purification_mps(d, L, D, device="cpu").AC.device.type == "cpu"
    assert thermal_state(H, L, 0.1, 0.05, D, device="cpu").AC.device.type \
        == "cpu"
    fin = FiniteMPS.random(L, d, D, torch.float64, "cpu", gen)
    G, sol = propagator(fin, 0.5j, H, device="cpu")
    assert G.device.type == sol.AC.device.type == "cpu"
    path = str(tmp_path / "win.npz")
    save_state(path, win)
    assert load_state(path, device="cpu").window.AC.device.type == "cpu"


def _slice11_entry_points(device):
    """The states and results of slice 11's entry points made on `device`
    (None: each entry point's default), as {name: tensor}."""
    from mpskit_tpu_torch import (
        DMRG, VUMPS, RealSpaceParallelDMRG, SymmetricFiniteMPS,
        SymmetricInfiniteMPS, find_groundstate, heisenberg_XXX,
        scan_groundstate_vumps, transverse_field_ising,
    )
    from mpskit_tpu_torch.algorithms.rsdmrg import find_groundstate_rsdmrg

    kw = {} if device is None else {"device": device}
    dev = "cuda" if device is None else device
    gen = torch.Generator(device=dev).manual_seed(0)
    sf = SymmetricFiniteMPS.random(6, (1, -1), 4, 0, torch.float64,
                                   generator=gen, **kw)
    si = SymmetricInfiniteMPS.random(2, (1, -1), 4, torch.float64,
                                     generator=gen, **kw)
    sf, _, _ = find_groundstate(sf, heisenberg_XXX(spin=0.5),
                                DMRG(maxiter=2, verbosity=0))
    H = transverse_field_ising(g=1.5)
    ipsi = [InfiniteMPS.random(1, 2, 4, torch.float64, dev, gen)
            for _ in range(2)]
    scan = scan_groundstate_vumps(ipsi, [H, transverse_field_ising(g=2.0)],
                                  VUMPS(maxiter=2, verbosity=0))
    fpsi = FiniteMPS.random(8, 2, 4, torch.float64, dev, gen)
    rs, envs, _ = find_groundstate_rsdmrg(
        fpsi, H, RealSpaceParallelDMRG(nseg=2, maxiter=1, verbosity=0))
    return {"SymmetricFiniteMPS.random": sf.state.AC,
            "SymmetricInfiniteMPS.random": si.state.AL,
            "scan_groundstate_vumps": scan.psis.AL,
            "scan energies": scan.energies,
            "find_groundstate_rsdmrg": rs.AC, "rsdmrg envs": envs.GLs}


@pytest.mark.cuda
def test_slice11_entry_points_on_the_card_by_default():
    """SymmetricFiniteMPS.random and SymmetricInfiniteMPS.random put their
    tensors on the card by default; scan_groundstate_vumps and
    find_groundstate_rsdmrg keep states made there on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the default device is the card")
    for name, t in _slice11_entry_points(None).items():
        assert t.is_cuda, name


def test_slice11_entry_points_on_the_cpu_when_asked():
    """The same entry points keep CPU states and results on the CPU."""
    for name, t in _slice11_entry_points("cpu").items():
        assert t.device.type == "cpu", name
