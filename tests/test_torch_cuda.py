"""Checks of the PyTorch port that need a CUDA card (marker `cuda`; each
skips without one). This file imports no jax, so it also runs where jax is
not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from mpskit_tpu_torch import (
    DMRG, DMRG2, VUMPS, FiniteMPS, InfiniteMPS, expectation_value,
    find_groundstate, heisenberg_XXX, j1_j2_model, svd_truncated,
    transverse_field_ising_lattice, truncbelow, truncdim,
)
from mpskit_tpu_torch.algorithms import derivatives
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy,
)
from mpskit_tpu_torch.kernels import ac_apply as k1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ and has no CPU mode")


def _tfim_density(g):
    """-(1/pi) int_0^pi sqrt(1 + g^2 - 2 g cos k) dk (Gauss-Legendre)."""
    k, wk = np.polynomial.legendre.leggauss(200)
    return float(-np.sum(wk * np.sqrt(1 + g * g - 2 * g * np.cos(
        np.pi * (k + 1) / 2))) / 2)


def _k1_inputs(D, d, w, seed):
    rng = np.random.default_rng(seed)
    GL = rng.standard_normal((w, D, D)) / D
    GR = rng.standard_normal((w, D, D)) / D
    W = rng.standard_normal((w, w, d, d))
    x = rng.standard_normal((D, d, D))
    return [torch.from_numpy(a).float().cuda() for a in (GL, W, GR, x)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,d,w", [(512, 2, 3), (200, 2, 3), (96, 3, 5),
                                   (64, 2, 3), (520, 2, 3), (256, 3, 5),
                                   (130, 2, 5), (128, 2, 9), (128, 3, 2),
                                   (100, 3, 4), (64, 2, 13), (70, 3, 9),
                                   (130, 4, 3), (768, 2, 26), (768, 2, 35),
                                   (200, 2, 26), (64, 2, 60), (64, 4, 45),
                                   (768, 4, 26)])
def test_k1_matches_plain_on_card(D, d, w):
    """K1 against its plain version (same rounding points: 1e-3 bounds the
    f32 summation-order differences) at the main path's width, at D that
    are not multiples of the kernel's 64-wide tiles (200, and 520, one past
    a tile edge), at a single tile (64), at the spin-1 Heisenberg shape
    (w=5, d=3), once in each other fused tier of the CUDA source's
    K1_TIERS, and on the general path that every other (w, d) takes (past
    the widest tier at d = 2 and 3, and at d = 4), there also at the J1-J2
    cylinder's shapes (D=768 at the program's w=26 and the reference's
    w=35) and the Hubbard cylinder's (D=768, d=4, w=26), at D=200, off
    the edge of its 128-row and 96-wide tiles, and at widths whose middle
    keeps one t1 buffer (w=60) or none (w=45, d=4) in shared memory."""
    _need_card()
    GL, W, GR, x = _k1_inputs(D, d, w, seed=D)
    before = k1.launches
    with matmul_precision():
        y = derivatives.ac_apply_fast(GL, W, GR, x)
        y_plain = k1.ac_apply_bf16_reference(GL, W, GR, x)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert float((y - y_plain).norm() / y_plain.norm()) <= 1e-3


@pytest.mark.cuda
def test_k1_general_path_is_counted_apart():
    """K1 at the J1-J2 cylinder's width (w=35, d=2: past every fused tier)
    against its plain version; each call counted once in `launches` and
    in `general_launches`, its matvec span of kind bf16-general, while a
    call on a fused tier leaves `general_launches` alone."""
    _need_card()
    from mpskit_tpu_torch.utils import trace

    assert not k1.fused(35, 2) and k1.fused(3, 2)
    GL, W, GR, x = _k1_inputs(128, 2, 35, seed=35)
    general, launches = k1.general_launches, k1.launches
    with matmul_precision(), trace.recording() as rec:
        ys = [derivatives.ac_apply_fast(GL, W, GR, x) for _ in range(2)]
        y_plain = k1.ac_apply_bf16_reference(GL, W, GR, x)
    torch.cuda.synchronize()
    assert k1.general_launches == general + 2
    assert k1.launches == launches + 2
    assert [s.kind for s in rec.spans if s.name == "matvec"] == [
        "bf16-general"] * 2
    for y in ys:
        assert float((y - y_plain).norm() / y_plain.norm()) <= 1e-3
    derivatives.ac_apply_fast(*_k1_inputs(64, 2, 3, seed=3))
    assert k1.general_launches == general + 2
    assert k1.launches == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("D,d,w", [(512, 2, 3), (200, 2, 26)])
def test_k1_is_deterministic(D, d, w):
    """No atomics and no split of a contracted index: two launches on the
    same inputs give bit-identical results, on a fused tier and on the
    general path."""
    _need_card()
    GL, W, GR, x = _k1_inputs(D, d, w, seed=1)
    y1 = k1.ac_apply_bf16(GL, W, GR, x)
    y2 = k1.ac_apply_bf16(GL, W, GR, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_k1_counts_one_launch_per_call():
    """One wrapper call runs three passes on the card and counts one."""
    _need_card()
    GL, W, GR, x = _k1_inputs(200, 2, 3, seed=2)
    before = k1.launches
    k1.ac_apply_bf16(GL, W, GR, x)
    assert k1.launches == before + 1


@pytest.mark.cuda
def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    GL, W, GR, x = _k1_inputs(64, 2, 3, seed=0)
    with pytest.raises(TypeError):
        k1.ac_apply_bf16(GL.double(), W, GR, x)
    with pytest.raises(ValueError):
        k1.ac_apply_bf16(GL, W, GR, x.transpose(0, 2))
    with pytest.raises(ValueError):
        k1.ac_apply_bf16(GL.cpu(), W, GR, x)


@pytest.mark.cuda
def test_float32_dmrg_on_card_goes_through_k1():
    """A small float32 DMRG on the card launches K1 in its first restarts
    and still converges to the closed-form TFIM energy."""
    _need_card()
    L, g = 16, 1.5
    A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
    e0 = -np.linalg.svd(A, compute_uv=False).sum()
    H = transverse_field_ising_lattice(g=g)
    gen = torch.Generator(device="cuda").manual_seed(3)
    psi = FiniteMPS.random(L, 2, 64, torch.float32, "cuda", gen)
    before = k1.launches
    psi, envs, _ = find_groundstate(
        psi, H, DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
                     maxiter=6, verbosity=0))
    assert k1.launches > before
    E = float(expectation_value(psi, H, envs=envs))
    assert abs(E - e0) <= 1e-5 * abs(e0)


@pytest.mark.cuda
def test_j1j2_live_channels_on_card_match_the_distance_level_mpo():
    """One float32 one-site DMRG sweep of a 6 x 4 J1-J2 cylinder at D=64
    from one seeded start, under `j1_j2_model` (w=26) and under the MPO
    that carries every span on every bond (w=35): the environment stacks
    have those widths and the energies agree to 1e-5 relative."""
    from test_torch_j1j2 import distance_level_model

    _need_card()
    width, Lx, D = 6, 4, 64
    out = []
    for H in (j1_j2_model(width=width), distance_level_model(width)):
        gen = torch.Generator(device="cuda").manual_seed(5)
        psi = FiniteMPS.random(width * Lx, 2, D, torch.float32, "cuda", gen)
        psi, envs, _ = find_groundstate(
            psi, H, DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
                         maxiter=1, tol=0.0, verbosity=0))
        E = float(expectation_value(psi, H, envs=envs))
        out.append((envs.GLs.shape[1], envs.GRs.shape[1], E))
    (wl, wr, E), (wld, wrd, Ed) = out
    assert (wl, wr, wld, wrd) == (26, 26, 35, 35)
    assert abs(E - Ed) <= 1e-5 * abs(Ed)


@pytest.mark.cuda
def test_entry_points_build_on_the_card_by_default():
    _need_card()
    psi = FiniteMPS.random(4, 2, 4, torch.float64)
    assert psi.device.type == "cuda" and psi.ALs.device.type == "cuda"
    rng = np.random.default_rng(4)
    ALs, AC = rng.standard_normal((4, 4, 2, 4)), rng.standard_normal((4, 2, 4))
    carried = finite_mps_from_numpy(ALs, ALs, AC, 0)
    assert carried.device.type == "cuda"
    psi = InfiniteMPS.random(1, 2, 4, torch.float64)
    assert psi.device.type == "cuda" and psi.C.device.type == "cuda"
    A = rng.standard_normal((1, 4, 2, 4))
    carried = infinite_mps_from_numpy(A, A, A, rng.standard_normal((1, 4, 4)))
    assert carried.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,rel_tol", [(torch.float32, 64, 1e-5),
                                             (torch.float64, 12, None)])
def test_vumps_on_card_matches_the_integral(dtype, D, rel_tol):
    """VUMPS on the card against the exact TFIM energy density: float32 at
    D=64 (fixed iterations, the bench's solver settings) within 1e-5
    relative, float64 at D=12 to tol 1e-9 within 1e-7; neither launches
    K1 (the site solves are exact, as in the JAX package)."""
    _need_card()
    g = 1.5
    e0 = _tfim_density(g)
    H = transverse_field_ising_lattice(g=g)
    gen = torch.Generator(device="cuda").manual_seed(4)
    psi = InfiniteMPS.random(1, 2, D, dtype, "cuda", gen)
    if rel_tol is None:
        alg = VUMPS(tol=1e-9, maxiter=150, verbosity=0)
    else:
        alg = VUMPS(tol=0.0, maxiter=30, krylovdim=10, eig_maxrestarts=2,
                    gauge_tol=1e-8, verbosity=0)
    before = k1.launches
    psi, envs, _ = find_groundstate(psi, H, alg)
    assert k1.launches == before
    e = float(expectation_value(psi, H, envs=envs)[0])
    if rel_tol is None:
        assert abs(e - e0) < 1e-7
        assert abs(float(envs.e_density) - e0) < 1e-7
    else:
        assert abs(e - e0) <= rel_tol * abs(e0)


@pytest.mark.cuda
def test_dmrg2_on_card_matches_float64():
    """Spin-1 Heisenberg L=16 at D=64: eight float32 two-site sweeps on the
    card (the slice's solver settings) against a float64 run of the same
    settings to tol 1e-10 on the card, within 1e-5 relative; no K1 launch
    (the two-site solves are exact)."""
    _need_card()
    L, D = 16, 64
    H = heisenberg_XXX(spin=1)
    energies = {}
    before = k1.launches
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 0.0)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        psi = FiniteMPS.random(L, 3, D, dtype, "cuda", gen)
        psi, envs, _ = find_groundstate(
            psi, H, DMRG2(tol=tol, maxiter=8, krylovdim=10, eig_maxrestarts=2,
                          trscheme=truncdim(D), verbosity=0))
        assert psi.AC.dtype == dtype and torch.isfinite(psi.AC).all()
        energies[dtype] = float(expectation_value(psi, H, envs=envs))
    assert k1.launches == before
    e64, e32 = energies[torch.float64], energies[torch.float32]
    assert abs(e32 - e64) <= 1e-5 * abs(e64)


@pytest.mark.cuda
def test_svd_truncated_on_card_matches_cpu():
    """A padded rank-deficient float32 matrix on the card against the same
    matrix in float64 on the CPU: Schmidt values, the discarded weight and
    U S Vh to float32 accuracy, under a cut by count and by value."""
    _need_card()
    rng = np.random.default_rng(8)
    M = np.zeros((300, 240))
    U0 = np.linalg.qr(rng.standard_normal((200, 150)))[0]
    V0 = np.linalg.qr(rng.standard_normal((160, 150)))[0]
    M[:200, :160] = (U0 * np.logspace(0, -6, 150)) @ V0.T
    for scheme in (truncdim(100), truncbelow(1e-4)):
        out = svd_truncated(torch.from_numpy(M).float().cuda(), 128, scheme)
        ref = svd_truncated(torch.from_numpy(M), 128, scheme)
        U, S, Vh, err = (t.double().cpu() for t in out)
        Ur, Sr, Vhr, errr = ref
        assert U.shape == (300, 128) and Vh.shape == (128, 240)
        assert float((S - Sr).abs().max()) <= 1e-5
        assert abs(float(err) - float(errr)) <= 1e-5
        assert float(((U * S) @ Vh - (Ur * Sr) @ Vhr).abs().max()) <= 1e-5


def _isometry_err(A, left: bool):
    """How far A (D, d, D) is from an isometry on its support: A^dag A
    (left) or A A^dag (right) against the diagonal of ones and zeros it
    rounds to."""
    G = (torch.einsum("lpa,lpb->ab", A.conj(), A) if left
         else torch.einsum("apr,bpr->ab", A, A.conj()))
    live = torch.diagonal(G).real.round()
    assert float(live.sum()) >= 1
    return float((G - torch.diag(live).to(G.dtype)).abs().max())


@pytest.mark.cuda
def test_float32_dmrg2_splits_on_card_take_the_gram_route():
    """The two-site run of `test_dmrg2_on_card_matches_float64` recorded:
    every float32 split on the card is an `svd` span of kind `gram`, each
    counted once by `svd_gram`, while every float64 split keeps `gesvd`;
    the float32 energy within 1e-5 relative of the float64 one, and the
    last sweep's AL and AR isometries on their support to 1e-5."""
    from mpskit_tpu_torch.utils import trace

    _need_card()
    L, D = 16, 64
    H = heisenberg_XXX(spin=1)
    energies = {}
    for dtype, tol, kind in ((torch.float64, 1e-10, "gesvd"),
                             (torch.float32, 0.0, "gram")):
        gen = torch.Generator(device="cuda").manual_seed(7)
        psi = FiniteMPS.random(L, 3, D, dtype, "cuda", gen)
        with trace.recording() as rec:
            psi, envs, _ = find_groundstate(
                psi, H, DMRG2(tol=tol, maxiter=8, krylovdim=10,
                              eig_maxrestarts=2, trscheme=truncdim(D),
                              verbosity=0))
        kinds = [s.kind for s in rec.spans if s.name == "svd"]
        assert kinds and set(kinds) == {kind}
        assert rec.counts["svd_gram"] == (len(kinds) if kind == "gram" else 0)
        energies[dtype] = float(expectation_value(psi, H, envs=envs))
    e64, e32 = energies[torch.float64], energies[torch.float32]
    assert abs(e32 - e64) <= 1e-5 * abs(e64)
    assert max(_isometry_err(psi.ALs[i], True) for i in range(L - 1)) <= 1e-5
    assert max(_isometry_err(psi.ARs[i], False) for i in range(1, L)) <= 1e-5


def _tfim_quench_start(device, dtype, L=8, D=16):
    from mpskit_tpu_torch import transverse_field_ising

    gen = torch.Generator(device=device).manual_seed(12)
    return (FiniteMPS.random(L, 2, D, dtype, device, gen),
            transverse_field_ising(g=0.5))


@pytest.mark.cuda
def test_tdvp_step_on_card_matches_cpu():
    """One complex128 TDVP step (TFIM g=0.5, L=8, D=16) on the card
    against the same step on the CPU: every tensor to 1e-10 (QR with a
    positive diagonal is unique); no K1 launch."""
    from mpskit_tpu_torch import TDVP, timestep

    _need_card()
    psi, H = _tfim_quench_start("cuda", torch.complex128)
    cpu = FiniteMPS(psi.ALs.cpu(), psi.ARs.cpu(), psi.AC.cpu(), 0)
    before = k1.launches
    out, _ = timestep(psi, H, 0.0, 0.05, TDVP())
    ref, _ = timestep(cpu, H, 0.0, 0.05, TDVP())
    assert k1.launches == before and out.AC.device.type == "cuda"
    for name in ("ALs", "ARs", "AC"):
        diff = (getattr(out, name).cpu() - getattr(ref, name)).abs().max()
        assert float(diff) <= 1e-10


@pytest.mark.cuda
def test_complex64_tdvp_on_card_stays_near_complex128():
    """Three complex64 TDVP steps on the card from a complex128 state
    rounded to complex64: the energies within 1e-5 relative of the
    complex128 steps and the norm within 1e-5 of 1."""
    from mpskit_tpu_torch import TDVP, timestep

    _need_card()
    psi, H = _tfim_quench_start("cuda", torch.complex128)
    states = {torch.complex128: psi,
              torch.complex64: FiniteMPS(psi.ALs.to(torch.complex64),
                                         psi.ARs.to(torch.complex64),
                                         psi.AC.to(torch.complex64), 0)}
    energies = {}
    for dtype, p in states.items():
        energies[dtype] = []
        for k in range(3):
            p, _ = timestep(p, H, k * 0.05, 0.05, TDVP(expalg_m=20))
            assert p.AC.dtype == dtype
            energies[dtype].append(float(expectation_value(p, H)))
        if dtype == torch.complex64:
            assert abs(float(p.norm()) - 1.0) <= 1e-5
    for e64, e128 in zip(energies[torch.complex64],
                         energies[torch.complex128]):
        assert abs(e64 - e128) <= 1e-5 * abs(e128)


@pytest.mark.cuda
def test_time_evolution_entry_points_run_on_the_card_by_default():
    """A default-built state evolves on the card through timestep (finite
    and infinite), TDVP2 and time_evolve with TDVP and WII; the evolution
    MPO stays a host array and moves to the card on use."""
    from mpskit_tpu_torch import (
        TDVP2, WII, make_time_mpo, time_evolve, timestep,
        transverse_field_ising,
    )

    _need_card()
    H = transverse_field_ising(g=0.5)
    psi = FiniteMPS.random(6, 2, 8, torch.complex128)
    assert psi.device.type == "cuda"
    for alg in (None, TDVP2()):
        out, _ = timestep(psi, H, 0.0, 0.05, alg)
        assert out.AC.device.type == "cuda" and out.ARs.device.type == "cuda"
    U = make_time_mpo(H, 0.05, WII())
    assert isinstance(U.site(0), np.ndarray)
    for alg in (None, WII()):
        out, _ = time_evolve(psi, H, [0.0, 0.05, 0.1], alg)
        assert out.AC.device.type == "cuda"
    ipsi = InfiniteMPS.random(1, 2, 4, torch.complex128)
    out, envs = timestep(ipsi, H, 0.0, 0.05)
    assert out.AL.device.type == "cuda" and envs.GLs.device.type == "cuda"


@pytest.mark.cuda
def test_qp_solve_on_card_matches_cpu():
    """The quasiparticle solve at D=12 (TFIM g=1.5, float64, p = 0 and
    pi) on the card against the same solve on the CPU from one ground
    state (each device draws its own seeded start vector): the energies to
    1e-8, and to 5e-3 of 2(g - 1) and 2(g + 1); GradientGrassmann and the
    QP environments launch no K1 (float64, no matvec_fast)."""
    from mpskit_tpu_torch import (
        GradientGrassmann, QuasiparticleAnsatz, excitations,
    )

    _need_card()
    H = transverse_field_ising_lattice(g=1.5)
    gen = torch.Generator(device="cuda").manual_seed(13)
    psi = InfiniteMPS.random(1, 2, 12, torch.float64, "cuda", gen)
    before = k1.launches
    psi, envs, _ = find_groundstate(
        psi, H, VUMPS(tol=1e-9, maxiter=150, verbosity=0)
        & GradientGrassmann(tol=1e-10, maxiter=5, verbosity=0))
    es = {}
    for dev in ("cuda", "cpu"):
        p = InfiniteMPS(*(x.to(dev) for x in (psi.AL, psi.AR, psi.AC,
                                              psi.C)))
        es[dev], qps = excitations(H, QuasiparticleAnsatz(tol=1e-8),
                                   [0.0, np.pi], p,
                                   generator=torch.Generator().manual_seed(0)
                                   if dev == "cpu" else
                                   torch.Generator(device="cuda")
                                   .manual_seed(0))
        assert qps[0][0].Xs.device.type == dev
    assert k1.launches == before
    np.testing.assert_allclose(es["cuda"].numpy(), es["cpu"].numpy(),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(es["cuda"][:, 0].numpy(), [1.0, 5.0],
                               rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_boundary_iteration_on_card_matches_cpu():
    """One boundary VUMPS iteration of the critical classical Ising MPO at
    D=16 (complex128) on the card against the same iteration on the CPU
    from one state: eps, the channel eigenvalue and the Schmidt values to
    1e-10; the transfer MPO moves to the card on use; no K1 launch."""
    from mpskit_tpu_torch import (
        VUMPS_Boundary, classical_ising, expectation_value, leading_boundary,
    )

    _need_card()
    O = classical_ising()
    gen = torch.Generator(device="cuda").manual_seed(16)
    psi = InfiniteMPS.random(1, 2, 16, torch.complex128, "cuda", gen)
    before = k1.launches
    out = {}
    for dev in ("cuda", "cpu"):
        p = InfiniteMPS(*(x.to(dev) for x in (psi.AL, psi.AR, psi.AC,
                                              psi.C)))
        out[dev] = leading_boundary(p, O, VUMPS_Boundary(maxiter=1,
                                                         verbosity=0))
    assert k1.launches == before
    (pc, ec, epsc), (ph, eh, epsh) = out["cuda"], out["cpu"]
    assert pc.C.device.type == "cuda" and ec.GLs.device.type == "cuda"
    assert abs(epsc - epsh) <= 1e-10
    assert abs(expectation_value(pc, O, envs=ec)
               - expectation_value(ph, O, envs=eh)) <= 1e-10
    sv = [torch.linalg.svdvals(p.C[0]).cpu() for p in (pc, ph)]
    assert float((sv[0] - sv[1]).abs().max()) <= 1e-10


@pytest.mark.cuda
def test_measurements_on_card_match_cpu():
    """The measurement surface on the card by default: FiniteMPS.from_dense
    and exact_diagonalization build there, and on one Hubbard (U=4, mu=2)
    two-site state at D=16 (float64) the transfer spectrum (magnitudes),
    the variance, the ranged energy and <n_0 n_20> equal the CPU values
    to 1e-10 relative; no K1 launch."""
    from mpskit_tpu_torch import (
        correlator, exact_diagonalization, hubbard, transfer_spectrum,
        variance,
    )
    from mpskit_tpu_torch.models.fermions import _spinful_ops

    _need_card()
    before = k1.launches
    assert FiniteMPS.from_dense(np.ones(2 ** 6) / 8, 2, 8).device.type \
        == "cuda"
    H = transverse_field_ising_lattice(g=1.5)
    es, states = exact_diagonalization(H, 8, num=2)
    assert es.device.type == "cuda" and states[0].AC.device.type == "cuda"
    sigma = np.linalg.svd(1.5 * np.eye(8) + np.eye(8, k=1),
                          compute_uv=False)
    np.testing.assert_allclose(es.cpu().numpy(),
                               [-sigma.sum(), -sigma.sum() + 2 * sigma.min()],
                               rtol=0, atol=1e-9)
    Hh = hubbard(t=1.0, U=4.0, mu=2.0, period=2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    psi = InfiniteMPS.random(2, 4, 16, torch.float64, "cuda", gen)
    psi, _, _ = find_groundstate(psi, Hh, VUMPS(maxiter=10, verbosity=0))
    _, _, n_up, n_dn, _ = _spinful_ops()
    n = n_up + n_dn
    out = {}
    for dev in ("cuda", "cpu"):
        p = InfiniteMPS(*(x.to(dev) for x in (psi.AL, psi.AR, psi.AC,
                                              psi.C)))
        out[dev] = [transfer_spectrum(p).abs(), variance(p, Hh),
                    expectation_value(p, Hh, range(0, 10)),
                    correlator(p, n, n, 0, [20])]
    assert out["cuda"][0].device.type == "cuda"
    for a, b in zip(out["cuda"], out["cpu"]):
        a, b = a.cpu(), b
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())
    assert k1.launches == before
