#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpskit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles kernel K1 (kernels/csrc/ac_apply_bf16.cu) with nvcc
     and prints what ptxas reports (registers, spills, wgmma warnings);
  3. K1 check: the kernel against its plain PyTorch version and against the
     exact f32 matvec at D=512, 200, 64 (one tile), 520 (one past a tile
     edge) with w=3, d=2, at the spin-1 shape D=256, w=5, d=3, and on
     the kernel's general path (D=256, w=13, d=2, past its widest fused
     tier); two launches at D=512 bit-identical; at D=512 the kernel, its
     plain version, the exact f32 matvec and a bf16 torch.matmul yardstick
     timed with CUDA events in turns, beside the kernel's bound;
  4. f64 parity: DMRG on TFIM L=16 D=32 in float64 against the closed-form
     ground energy (covers QR of the padded rank-deficient edge panels);
  5. the slice at full width: find_groundstate with DMRG(krylovdim=10,
     eig_maxrestarts=2, cheap_galerkin=True) on TFIM L=32 D=512 float32,
     against the closed-form energy, with K1's launch count from this run;
     then dmrg_sweep_time_tfim_L32_D512_float32 under bench.py:158-183's
     protocol (a seeded random state, one warm sweep, 6 timed sweeps) in
     a JSON line with host syncs per sweep, one more sweep plainly, split
     by synchronizations into eigensolves (K1 inside them), QR,
     environment pushes and the rest, and under torch.profiler;
  6. f64 VUMPS: find_groundstate with VUMPS(tol=1e-9, maxiter=150) on the
     infinite TFIM (g=1.5) at D=12 in float64, against the exact energy
     density (an integral over the free-fermion dispersion);
  7. the infinite slice at full width, under bench.py's protocol for
     vumps_iteration_time_tfim_D256_float32: TFIM g=1.5, one-site cell,
     d=2, D=256, float32, krylovdim=10, eig_maxrestarts=2, gauge and
     environment tolerance 1e-8, inner tolerance 1e-6; 8 warm iterations
     with the environments carried, then 3 replays of the same 32
     iterations timed (s/iter) with their host syncs, then one extra
     iteration split by synchronizations into environments, AC solves,
     C solves and regauge, and one under torch.profiler for the device's
     busy time; gates on the energy density, finiteness, shapes and zero
     K1 launches (the VUMPS site solves are exact);
  8. f64 two-site DMRG: find_groundstate with DMRG2 on TFIM L=16 D=32
     (truncbelow(1e-9)) against the closed form, and on spin-1 Heisenberg
     L=6 D=27 against exact diagonalization (729 states), each to 1e-8;
  9. the two-site slice at full width: DMRG2(krylovdim=10,
     eig_maxrestarts=2, trscheme=truncdim(256)) on spin-1 Heisenberg L=32
     D=256 float32 for 4 sweeps through find_groundstate, with per-sweep
     times, host syncs and largest discarded weight, and the metric
     dmrg2_sweep_time_heisenberg_s1_L32_D256_float32 (mean of sweeps 2-4)
     in a JSON line; then one more sweep timed plainly, one split by
     synchronizations into eigensolves, SVD splits, environment pushes and
     the rest, one under torch.profiler for the device's busy time and idle
     share, and the 768 x 768 SVD on a two-site spectrum by each route
     (torch's default, each cuSOLVER driver, float64, a float64 Gram
     matrix) in CUDA events with its accuracy; gates: the energy within
     1e-5 relative of a float64 one-site DMRG continuation to eps 1e-9 (the
     trscheme chain of find_groundstate), fresh environments agreeing,
     finite tensors of the right shapes, zero K1 launches;
 10. bonds and IDMRG in float64: IDMRG1 on a one-site cell and IDMRG2 on a
     two-site cell (truncbelow(1e-10)) on TFIM g=1.5 at D=12 within 1e-6 of
     the exact density; phase 6's VUMPS state grown by OptimalExpand(12)
     (D 24, density kept to 1e-7, AL isometries to 1e-10), then cut by
     VUMPSSvdCut(truncbelow(1e-8)) (period 2, density within 1e-5); phase
     4's DMRG state cut by SvdCut(truncbelow(1e-12)) (overlap 1 within
     1e-8); zero K1 launches;
 11. time evolution in complex128: TDVP and TDVP2 (TFIM g=0.5, L=8,
     D=16, 3 steps of dt=0.05) against expm(-i H t) to 1e-10 in 1 -
     |overlap|; time_evolve with WII and TaylorCluster(2) at L=6 within
     the JAX test's 3 L dt^2 per step of the exact state; infinite TDVP
     (TFIM g=1.2 -> 1.5, D=32, from a VUMPS ground state, 3 steps) on the
     card against the same steps on the CPU to 1e-8; a complex64
     ac_apply at D=256 against complex128 (1e-5: no TF32); zero K1
     launches;
 12. the time-evolution slice at full width, the quench of
     scripts/tpu_complex_check.py:47-49: a float32 TFIM g=1.5 ground state
     at L=32 D=256 (DMRG tol 1e-8, 12 sweeps, within 1e-5 of the closed
     form), made complex (re-canonicalized in complex128, rounded to
     complex64) and evolved under g=0.5 by 3 timesteps of
     dt=0.05 with TDVP(expalg_m=20), with per-step times, host syncs,
     worst Krylov estimate, energy and norm, and the metric
     tdvp_step_time_tfim_quench_L32_D256_complex64 (mean of steps 2-3) in
     a JSON line; then one more step timed plainly, one split by
     synchronizations into AC exponentials, C exponentials, QR/LQ,
     environment pushes and the rest, one under torch.profiler (busy
     time, idle share, the ten largest device operations); gates: E(0)
     within 1e-4 of the JAX value, each complex64 energy within 1e-5 of a
     complex128 run of the same steps, the complex128 drift 1e-10, the
     complex64 norm within 1e-5 of 1, finite tensors of the right shapes,
     zero K1 launches in the steps;
 13. GradientGrassmann and the excitations in float64 / complex128: the
     default find_groundstate(InfiniteMPS, H) (VUMPS at 1e-9, then
     GradientGrassmann at 1e-10) on TFIM g=1.5 D=12 within 1e-10 of the
     JAX energy density, with its iterations, evaluations, eps and time;
     finite GradientGrassmann on TFIM g=4 L=10 D=6 (150 iterations)
     under the quality gate's variance 1e-2; excitations_finite on TFIM
     g=10 L=16 D=32 within 1e-2 relative of 2(g-1); FiniteExcited at L=8
     against ED to 1e-6; excitations_infinite at p = 0, pi within 5e-3 of
     2(g-1), 2(g+1); the complex128 dispersion at p = 0, 0.7, pi
     (excitations_infinite_batched) within 5e-3 of the exact one; the
     left -> right -> left QP gauge round trip to 1e-10; zero K1
     launches;
 14. the excitations slice at full width, the Haldane gap (BASELINE.md
     row 1, tests/test_haldane.py): spin-1 Heisenberg D=48 float64,
     find_groundstate with VUMPS(tol=1e-9, maxiter=200) &
     GradientGrassmann(tol=1e-10, maxiter=20) (VUMPS iterations and eps,
     GradientGrassmann iterations, evaluations, gradient norms and
     s/iteration, timed from the first accepted CG step to the last, as
     grassmann_iteration_time_s1_D48_float64 in a JSON line), then
     excitations with QuasiparticleAnsatz(tol=1e-6) at p = pi
     (seconds as haldane_qp_solve_time_s1_D48_float64, matvecs,
     restarts, GMRES Arnoldi steps and host syncs per matvec), one QP
     matvec plainly and under torch.profiler (busy time, idle share, the
     five largest device operations); gates: E/4 within 1e-4 of
     0.41047925, the energy after GradientGrassmann no more than 1e-12
     above VUMPS's and no more than 1e-10 below it (VUMPS converged to eps
     1e-9), at least 2 accepted CG steps, finite tensors, zero K1
     launches;
 15. the statmech boundaries in complex128 (`[boundary-f64]` lines), at
     the JAX tests' configurations on the critical classical Ising MPO:
     VUMPS_Boundary D=13 (tol 1e-9, 40 iterations) and an MPOHamiltonian
     row D=13 (40 iterations) within 1e-3 of the reference's 2.5337, VOMPS D=8 within 2e-3,
     GradientGrassmann D=10 after a VOMPS(tol=1e-3) warm-up within 1e-3
     (and not below the warm-up's eigenvalue), two MPOMultiline rows D=8
     (|lambda_0 lambda_1|^(1/2) within 5e-3); the six-vertex boundary
     (two-site cell, D=10) with |lambda_qp(0)| > |lambda_qp(pi/2)| through
     excitations(O, QuasiparticleAnsatz(), ...); approximate(FitDMRG) of
     a finite Ising row applied to a random state (fidelity 1e-6); one
     leading_boundary iteration at D=16 on the card against the CPU to
     1e-10; each eigenvalue beside Onsager's; zero K1 launches;
 16. the boundary slice at full width (`[boundary]` lines):
     leading_boundary of the critical classical Ising MPO from a seeded
     random D=256 complex128 state with VUMPS_Boundary(tol=1e-9,
     maxiter=15) (krylovdim 30, environment tolerance 1e-12, gauge
     tolerance 1e-13): eps and lambda every 5 iterations, the metric
     boundary_vumps_iteration_time_ising_D256_complex128 (the mean of
     iterations 2..N) with host syncs per iteration in a JSON line, the
     last iteration again split by synchronizations into the environment
     solves, the AC solve, the C solve, the from_AL gauge fix and the
     rest, plainly and under torch.profiler (busy time, idle share, the
     ten largest device operations); gates: lambda within 1e-7 relative
     of Onsager's and within 1e-3 of 2.5337, eps falling from iteration
     5, finite tensors, zero K1 launches;
 17. the measurement surface (`[measure]` lines), float64 unless stated,
     with each measurement's seconds and host syncs: K1 at leg (a)'s
     shape (w=4, d=2, D=512: its second fused tier) and on its general
     path (w=13), eager and in a CUDA graph, against its plain version
     and its bound; (a) free fermions L=32 (JW MPO, w=4) by float32 DMRG
     at D=512 as phase 5 runs it (K1 must launch) within 1e-5 relative of
     the exact energy, a float64 continuation within 1e-9, then against
     the exact free-fermion state entropy_profile (1e-6 at every bond),
     string_correlator <c_8^dag c_j> and correlator <n_8 n_j> for j =
     9..23 (1e-8), a two-site string <c^dag c + h.c.>, the fermion parity
     as a finite DenseMPO (+1) and variance (below 1e-8); (b) the
     half-filled Hubbard chain U=4 on a two-site cell (d=4, w=6) at
     D=256 by VUMPS(tol=1e-8, maxiter=60) from a random state (its
     iterations 2.. as
     vumps_iteration_time_hubbard_U4_D256_float64 in a JSON line), the
     cell-mean energy within 1e-4 of Lieb-Wu's -2.5737293678984039, <n>
     within 1e-6 of 1, transfer_spectrum, marek_gap and
     correlation_length with krylovdim 80 (|lambda_1| = 1 to 1e-10,
     |lambda_2| < 1), variance (below 1e-3),
     calc_galerkin, E(range(0, 64)) - E(range(0, 32)) = 32 e to 1e-8,
     <n_0 n_200> within 1e-6 of <n>^2, all again on the CPU from the same
     state (1e-10 relative) and once under torch.profiler (idle share);
     (c) exact_diagonalization of the TFIM g=1.5 L=20 in complex128
     (D=1024, exact_diagonalization_time_tfim_L20_complex128 in a JSON
     line), E0 within 1e-9 and E1 within 1e-8 of the free-fermion
     values, and fidelity_susceptibility of the infinite TFIM g=1.5 at
     D=48 with the transverse-field MPO, Hermitian positive, card
     against CPU to 1e-8 and within 1e-6 relative of the exact
     1/(16 g^2 (g^2 - 1)), with its CG steps;
 18. windows, lazy sums, dynamical DMRG and thermal states (`[window]`
     lines), with every leg's seconds: K1 at the window's shape (D=256,
     w=3, d=2) eager and in a CUDA graph against its plain version and
     its bound; (a) VUMPS of the infinite TFIM g=1.5 at D=256 in float32
     (60 iterations), then find_groundstate with DMRG(krylovdim=10,
     eig_maxrestarts=2, cheap_galerkin=True, tol=1e-6, maxiter=12) on a
     window of L=32 at D=256 from a seeded full-rank random window, with
     per-sweep times and host syncs,
     window_dmrg_sweep_time_tfim_L32_D256_float32 (sweeps 2..) in a JSON
     line and K1's launches (launches_window, > 0); gates: <X_i> and
     <Z_i Z_i+1> within 1e-5 of the infinite values, the energy within
     1e-5 relative of the from_infinite window's, grow(1, 1) then
     shrink(1, 1) with a deviation below 1e-5 and <X> unchanged to 1e-6;
     (b) the co-evolving window TDVP of H(t) = H_zz + (1.5 - 0.6 t) H_x
     as Window(LazySum) in complex64 from (a)'s state, 6 steps of dt=0.05
     with TDVP(expalg_m=20), window_tdvp_step_time_tfim_ramp_L32_D256_
     complex64 (steps 2..) in a JSON line with syncs per step, the
     frozen-boundary run's error after 5 steps printed beside; gates: the
     centre <X> and <ZZ> within 1e-4 of the infinite TDVP of the same sum at every
     step, the norm within 1e-5 of 1, no K1 launch; (c) propagator in
     complex128: the ground-state pole at L=32 D=64 within 1e-9 relative
     of 1/(0.5 + 0.3i), NaiveInvert (1e-8) and Jeckelmann (1e-6) at L=10
     D=32 against np.linalg.solve, card against CPU 1e-10; (d)
     thermal_state at L=32 beta=1 dbeta=0.025 Dmax=128 (g=1.2) within
     5e-3 relative of the free-fermion Gibbs energy, at L=8 Dmax=24 card
     against CPU 1e-10; (e) save_state / load_state of (a)'s window and
     infinite state, bit for bit on the card;
 19. segment-parallel DMRG, the parameter scan and the compat surface
     (`[rs]` lines): (a) find_groundstate with RealSpaceParallelDMRG(
     nseg=4, warmup=2, krylovdim=10, eig_maxrestarts=2, maxiter=10) on the
     TFIM g=1.5 at L=32 D=512 float32, per-round times and host syncs,
     rsdmrg_round_time_tfim_L32_D512_float32 (rounds 2.., round 1 holding
     the warmup) in a JSON line, the same rounds with the stitch in
     float32 printed beside, K1's launches counted apart in the warmup
     sweeps and in the rounds (the segment sweeps' probes of a warmed-up
     state stay below 3e-2 and skip K1), then one round with no warmup
     from a random state; gates: launches_rsdmrg > 0, the warmup and
     round counts adding up to it, the cold round's segment sweeps
     launching K1 (launches_rsdmrg_segments_cold > 0), the energy within
     E_TOL_F32 relative of the closed form; (b) RS-DMRG2 (two_site,
     truncdim(64)) at D=64 float64 within 1e-8 of the closed form; (c)
     scan_groundstate_vumps over g = 1.2, 1.5, 2.0, 3.0 at D=256 float32
     from seeded random states with VUMPS(tol=1e-6, maxiter=60),
     vumps_scan_iteration_time_tfim_B4_D256_float32 (a lockstep iteration
     of the four members, timed from outside) in a JSON line; gates: each
     density within 1e-5 of the exact one, no K1 launch; (d) environments
     / leftenv / rightenv on (a)'s state against the environments the
     sweep returned and TransferMatrix against transfer_left (1e-5
     relative), entanglement_plot_data of (b)'s state and
     transfer_plot_data of a scan member in float64, card against CPU
     (1e-10);
 20. the U(1) / Z_2 symmetric states (`[u1]` lines): (a)
     SymmetricFiniteMPS.random of the XX chain (charges (0, 1)) at L=32
     D=512 float32 in the sector N=16 through find_groundstate with
     DMRG(krylovdim=10, eig_maxrestarts=2, tol=1e-6, maxiter=12) (K1's w=4
     tier), per-sweep times and syncs, u1_dmrg_sweep_time_xx_L32_D512_
     float32 (sweeps 2..) in a JSON line; gates: the energy within 1e-5
     relative of sum_{k<=16} -2 cos(k pi / 33), <N> within 1e-4 of 16,
     every entry outside the charge mask exactly 0, launches_u1 > 0; (b)
     sector DMRG2 (4 sweeps, the N=17 one split by synchronizations into
     eigensolves, per-sector SVD splits and environment pushes) then the
     sector DMRG at D=128 float64 in N=16 and N=17: E(17) - E(16) within
     1e-8 of -2 cos(17 pi / 33), the merged sector spectrum at bond 16
     equal to entanglement_spectrum to 1e-12, the middle entropy within
     1e-6 of the exact free-fermion one; the three sector-1
     quasiparticles above the vacuum of the XX chain at h=4 (L=32 D=64)
     within 1e-7 of h - 2 cos(n pi / 33); (c) from an N=16 ground state at
     D=256 (float32 DMRG, made complex64) the quench to XXZ(delta=0.5), 6
     TDVP(expalg_m=20) steps of dt=0.05 symmetric and the same steps
     unsymmetric, u1_tdvp_step_time_xxz_L32_D256_complex64 (steps 2..) in
     a JSON line; gates: the basis order (charge (0, 1) is 1 - 2 Sz), the
     energy (relative) and every <n_i> of the two runs within 1e-5 at
     every step, <N> conserved to 1e-5, no entry outside the mask, no K1
     launch; (d) the sector VUMPS of the XXX chain (two-site cell, charges
     +-1) at D=128 float64, VUMPS(tol=1e-8, maxiter=100): the density
     within 1e-4 of 1 - 4 ln 2, C outside its mask below 1e-12,
     transfer_spectrum(sector=0) |lambda_0| = 1 to 1e-10, sector 2 below
     1; the Z_2 ground state of the parity TFIM g=1.5 at D=48 and its
     sector-1 quasiparticle at p=0 within 1e-6 of 2|g - 1| = 1; (e)
     changebonds_symmetric(OptimalExpand(16)) of (d)'s state, no entry
     outside the new masks and, after 10 VUMPS iterations at the larger D,
     an energy not above the one before; save_state / load_state of a Z_2
     SymmetricFiniteMPS and of (d)'s state, bit for bit with labels,
     masks and modulus;
 21. the SU(2) family in float64 ([su2] lines; starts drawn on the CPU
     from seeds and moved to the card): (a) the reduced VUMPS of the spin-1
     Heisenberg chain at scripts/bench_su2_reduced.py's bond (multiplets
     (1/2 x34, 3/2 x25, 5/2 x8), dense D=216) through find_groundstate
     from a random state, then steady iterations at krylovdim 10, 2
     restarts: su2_reduced_vumps_iteration_time_heisenberg_s1_D216_float64
     with host syncs, GEMM terms per rac_apply, the idle share and the
     ten largest device operations under torch.profiler; beside it
     dense_vumps_iteration_time_heisenberg_s1_D216_float64 (the plain
     VUMPS at the embedded converged state, and from a random state);
     gates: the energy density within 1e-6 of -1.401484038971 and the
     dense Schmidt values (2j+1)-fold degenerate to 1e-10; (b) the
     reduced Haldane gap at dense D=42, p = pi, spin-1 sector (QP tol
     1e-7, the JAX test's):
     su2_haldane_qp_solve_time_s1_D42_float64, gates 1e-4 of 0.41047925
     and 1e-6 of the dense QP on the embedded state; (c) SU2DMRG2 (2
     sweeps, max_mult 40, dense width capped at 256) then one SU2DMRG
     sweep at L=32, total spin 0, from a low-spin random start (2j <= 6)
     through find_groundstate:
     su2_dmrg2_sweep_time_heisenberg_s1_L32_float64 (sweeps 2..) and the
     one-site sweep time, gates: the widest dense bond 200-256, the
     energy within 1e-6 relative of phase 9's float64 continuation,
     expand_bond_reduced grows the middle bond with the energy kept to
     1e-10; (d) complex128 SU2TDVP through timestep, dt=0.05, 2 steps at
     L=32 from a dense-64 state after one DMRG2 sweep:
     su2_tdvp_step_time_heisenberg_s1_L32_complex128 (steps 2..), gates:
     energy 1e-6 relative, norm 1e-10; (e) the dense-projector VUMPS at
     tests/test_su2.py's bond (dense D=22): 5e-4 of 4 E0, exact
     multiplet degeneracies; (f) (a)-(d) at dense D=8 / L=8 on the card
     and the CPU, agreeing to 1e-10; K1 launches 0 (launches_su2).
Each phase's seconds are printed after it ([time] lines).
The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K1_SOURCE = "mpskit_tpu_torch/kernels/csrc/ac_apply_bf16.cu"
K1_REPLACES = "scripts/exp_r5_bf16_matvec.py:66"
K1_TOL_PLAIN = 1e-3   # same rounding points; f32 summation order differs
K1_TOL_EXACT = 1e-2   # bf16 operands: ~3e-3 expected
K1_SHAPES = ((512, 2, 3), (200, 2, 3), (64, 2, 3), (520, 2, 3), (256, 3, 5),
             (256, 2, 13))
# H100 SXM at 700 W (NVIDIA's data sheet): dense bf16 tensor-core and f32
# FMA peaks, HBM3 bandwidth
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
E_TOL_F64 = 1e-8      # absolute, float64
E_TOL_F32 = 1e-5      # relative, float32 with a bf16 first restart
E_TOL_VUMPS_F64 = 1e-7  # absolute, float64 energy density
# bench.py's VUMPS workload and protocol (bench.py:40-46, :70-133)
VUMPS_D, VUMPS_G = 256, 1.5
VUMPS_ARGS = dict(m=10, restarts=2, gauge_tol=1e-8, env_tol_static=1e-8,
                  inner_tol=1e-6)
VUMPS_WARMUP, VUMPS_BATCH, VUMPS_REPS = 8, 32, 3
# the two-site configuration of BASELINE.json:8 at its full width
DMRG2_L, DMRG2_D, DMRG2_SWEEPS = 32, 256, 4
E_TOL_IDMRG = 1e-6     # absolute, float64 energy density at D=12
# the quench of scripts/tpu_complex_check.py:47-49 at its full width
TDVP_L, TDVP_D, TDVP_G0, TDVP_G1 = 32, 256, 1.5, 0.5
TDVP_DT, TDVP_STEPS, TDVP_M = 0.05, 3, 20
TDVP_INF_D, TDVP_INF_G0, TDVP_INF_G1 = 32, 1.2, 1.5
# E of H(g=0.5) in the g=1.5 ground state, JAX CPU complex128
# (TPU_COMPLEX_r04.json, tdvp_quench_split.energies_cpu_c128[0])
E_T0_REF = -25.091058415155615
E_TOL_QUENCH_T0 = 1e-4   # relative: two float32 ground states
E_TOL_TDVP_EXACT = 1e-10  # 1 - |overlap| with expm(-i H t), complex128
E_TOL_TDVP_INF = 1e-8    # absolute, card against CPU, complex128
E_TOL_TDVP_DRIFT = 1e-10  # relative, complex128 one-site TDVP energy
C64_MATVEC_TOL = 1e-5    # relative; complex64 rounding, TF32 would be 1e-3
# phase 13: TFIM g=1.5 at D=12; the JAX package's default
# find_groundstate (VUMPS at 1e-9, GradientGrassmann at 1e-10) reached
# this energy density in float64 on the CPU from InfiniteMPS.random(
# PRNGKey(3), 1, 2, 12)
QP_G, QP_D = 1.5, 12
E_GG_JAX = -1.6719262215361526
E_TOL_GG = 1e-10
# phase 14: the Haldane gap (BASELINE.md row 1, tests/test_haldane.py)
HALDANE_D, HALDANE_GAP, HALDANE_TOL = 48, 0.41047925, 1e-4
# phases 15-16: the critical 2D classical Ising boundary (BASELINE.json
# configs[4]): Onsager's leading transfer eigenvalue per site, sqrt(2)
# exp(2 G / pi) with G Catalan's constant, and the reference test's oracle
# (BASELINE.md:18)
ONSAGER = float(np.sqrt(2) * np.exp(2 * 0.915965594177219015 / np.pi))
BOUNDARY_ORACLE, BOUNDARY_ORACLE_TOL = 2.5337, 1e-3
BOUNDARY_D, BOUNDARY_ITERS, BOUNDARY_REL_TOL = 256, 15, 1e-7
BOUNDARY_CARD_TOL = 1e-10   # one iteration, card against CPU, complex128
# phase 17, leg (a): free fermions (the JW chain of models/fermions.py,
# w=4) at the finite cell's width, against the exact free-fermion state
FF_L, FF_D, FF_SWEEPS32, FF_SWEEPS64, FF_TOL64 = 32, 512, 8, 12, 1e-12
FF_E_TOL64 = 1e-9       # absolute, float64 energy
FF_I, FF_JMAX = 8, 24   # correlators from site 8 to sites 9..23
FF_TOL_ENTROPY, FF_TOL_CORR, FF_TOL_VAR = 1e-6, 1e-8, 1e-8
# leg (b): the half-filled Hubbard chain (mu = U/2) on a two-site cell at
# the infinite cell's width; Lieb-Wu's energy per site at U=4,
# -4 int_0^inf J0(w) J1(w) / (w (1 + exp(w U / 2))) dw = -0.5737293678984039
# (scipy quad, error 2e-9), minus mu <n> = 2
HUB_U, HUB_E_LIEB_WU, HUB_E_TOL = 4.0, -2.5737293678984039, 1e-4
HUB_D, HUB_VUMPS_ITERS = 256, 60
HUB_DENSITY_TOL, HUB_NN_TOL, HUB_VAR_TOL = 1e-6, 1e-6, 1e-3
HUB_RANGE_N, HUB_RANGE_TOL, HUB_CORR_J = 32, 1e-8, 200
HUB_CARD_TOL = 1e-10    # relative, card against CPU
# Krylov dimension of the transfer spectra: the correlation length is
# ~120 sites at D=256, and the default 40 steps left |lambda_1| 2e-10
# from 1 in one run (H100 80GB HBM3, 700 W)
HUB_KRYLOVDIM = 80
# leg (c): ED of the open TFIM at full bond dimension, and the fidelity
# susceptibility of the infinite TFIM
ED_L, ED_G, ED_TOL_E0, ED_TOL_E1 = 20, 1.5, 1e-9, 1e-8
FS_D, FS_TOL, FS_CARD_TOL, FS_EXACT_TOL = 48, 1e-8, 1e-8, 1e-6
# phase 18: windows, lazy sums, dynamical DMRG and thermal states; every
# model is the TFIM H = -sum ZZ - g sum X. Leg (a): window DMRG of the
# infinite g=1.5 ground state (VUMPS at the infinite cell's D=256, float32)
WIN_L, WIN_D, WIN_G, WIN_SWEEPS, WIN_TOL = 32, 256, 1.5, 12, 1e-5
WIN_VUMPS_ITERS = 60
# leg (b): the co-evolving window TDVP of the field ramp H(t) = H_zz +
# (1.5 - 0.6 t) H_x in complex64 against the infinite TDVP of the same sum
RAMP_STEPS, RAMP_DT, RAMP_M, RAMP_TOL, RAMP_NORM_TOL = 6, 0.05, 20, 1e-4, 1e-5
# the frozen-boundary run beside it (printed only) goes half as far
FROZEN_STEPS = 5
# leg (c): dynamical DMRG in complex128, the ground-state pole at L=32 D=64
# and a random state at L=10 D=32 against the dense solve
DD_L, DD_D, DD_POLE_TOL = 32, 64, 1e-9
DD_DENSE_L, DD_DENSE_D, DD_Z = 10, 32, 0.7 + 0.4j
DD_NAIVE_TOL, DD_JECK_TOL, DD_CARD_TOL = 1e-8, 1e-6, 1e-10
# leg (d): the thermal purification at g=1.2 against the free-fermion Gibbs
# energy (the JAX test's 5e-3), and card against CPU at L=8 Dmax=24
TH_L, TH_G, TH_BETA, TH_DBETA, TH_DMAX, TH_TOL = 32, 1.2, 1.0, 0.025, 128, 5e-3
TH_CARD_L, TH_CARD_DMAX, TH_CARD_TOL = 8, 24, 1e-10
# phase 19: segment-parallel DMRG of the TFIM g=1.5 at the finite cell's
# width (L=32, D=512, float32), its two-site form in float64 at D=64, the
# parameter scan at the infinite cell's width (D=256, float32)
RS_L, RS_D, RS_G, RS_NSEG, RS_ROUNDS = 32, 512, 1.5, 4, 10
RS2_D, RS2_TOL = 64, 1e-8
SCAN_GS, SCAN_D, SCAN_ITERS, SCAN_TOL = (1.2, 1.5, 2.0, 3.0), 256, 60, 1e-5
COMPAT_TOL32, PLOT_CARD_TOL = 1e-5, 1e-10
# phase 20: U(1) / Z_2 symmetric states. Leg (a): the XX chain (free
# fermions, charges (0, 1)) at L=32 D=512 float32 in the sector N=16
U1_L, U1_D, U1_N, U1_SWEEPS, U1_TOL, U1_N_TOL = 32, 512, 16, 12, 1e-5, 1e-4
# leg (b): sector DMRG2 then DMRG at D=128 float64 in N=16 and N=17, and
# charged quasiparticles above the h=4 vacuum at D=64
U1_D2, U1_DMRG2_SWEEPS, U1_GAP_TOL, U1_SPEC_TOL, U1_S_TOL = 128, 4, 1e-8, \
    1e-12, 1e-6
U1_QP_D, U1_QP_H, U1_QP_TOL = 64, 4.0, 1e-7
# leg (c): symmetric TDVP of the quench XX -> XXZ(0.5) in complex64
U1_TDVP_D, U1_TDVP_STEPS, U1_TDVP_DT, U1_TDVP_TOL = 256, 6, 0.05, 1e-5
# leg (d): sector VUMPS of the XXX chain (two-site cell, charges +-1) and
# the Z_2 gap of the parity TFIM
U1_INF_D, U1_INF_TOL, Z2_D, Z2_G, Z2_GAP_TOL = 128, 1e-4, 48, 1.5, 1e-6
U1_EXPAND = 16
# phase 21: the SU(2) family in float64. Leg (a): the reduced VUMPS of the
# spin-1 Heisenberg chain at scripts/bench_su2_reduced.py:34-38's width
# (dense D=216) and settings, beside the plain dense VUMPS at D=216
SU2_BOND, SU2_E0, SU2_E_TOL = ((1, 34), (3, 25), (5, 8)), -1.401484038971, \
    1e-6
SU2_TIMED, SU2_DENSE_WARM, SU2_DENSE_TIMED = 3, 2, 3
# leg (b): the reduced Haldane gap (tests/test_su2_reduced_qp.py:303-313)
SU2_QP_BOND, SU2_HALDANE, SU2_HALDANE_TOL, SU2_QP_DENSE_TOL = \
    ((1, 8), (3, 5), (5, 1)), 0.41047925, 1e-4, 1e-6
# legs (c)-(d): finite chains at L=32 in the total-spin-0 sector, DMRG2
# capped at phase 9's two-site width (dense 256), then one-site DMRG; TDVP
# from a narrower state after one DMRG2 sweep
SU2_L, SU2_MAX_MULT, SU2_MAX_DENSE = 32, 40, 256
SU2_DMRG2_SWEEPS, SU2_DMRG_SWEEPS, SU2_E_REL_TOL, SU2_EXPAND_TOL = 2, 1, \
    1e-6, 1e-10
SU2_TDVP_DENSE, SU2_TDVP_STEPS, SU2_TDVP_DT = 64, 2, 0.05
SU2_TDVP_E_TOL, SU2_TDVP_NORM_TOL = 1e-6, 1e-10
# leg (e): the dense-projector VUMPS at tests/test_su2.py:46-60's bond
SU2_DENSE_BOND, SU2_DENSE_E_TOL = ((1, 4), (3, 2), (5, 1)), 5e-4
# leg (f): card against CPU at small sizes
SU2_SMALL_BOND, SU2_SMALL_L, SU2_CARD_TOL = ((1, 2), (3, 1)), 8, 1e-10


def tfim_open_chain_e0(L: int, g: float) -> float:
    """Ground energy of H = -sum Z Z - g sum X on an open chain of L sites:
    minus the sum of the singular values of g*I + superdiag(1) (free
    fermions)."""
    A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
    return -float(np.linalg.svd(A, compute_uv=False).sum())


def tfim_open_chain_thermal_energy(L: int, g: float, beta: float) -> float:
    """Gibbs energy Tr(H e^{-beta H}) / Tr(e^{-beta H}) of the same open
    chain: -sum sigma_k tanh(beta sigma_k) over the singular values sigma_k
    of g*I + superdiag(1) (free fermions of energy 2 sigma_k)."""
    A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
    sigma = np.linalg.svd(A, compute_uv=False)
    return -float(np.sum(sigma * np.tanh(beta * sigma)))


def tfim_density(g: float) -> float:
    """Exact ground energy per site of the infinite TFIM H = -sum Z Z - g
    sum X: -(1/pi) int_0^pi sqrt(1 + g^2 - 2 g cos k) dk (200-point
    Gauss-Legendre, exact to rounding for this smooth integrand)."""
    k, wk = np.polynomial.legendre.leggauss(200)
    return float(-np.sum(wk * np.sqrt(1 + g * g - 2 * g * np.cos(
        np.pi * (k + 1) / 2))) / 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def host_time_ms(fn, n: int) -> float:
    """Host time per call: n calls enqueued back to back, without waiting
    for the card (a call that the host cannot enqueue faster than the card
    runs it leaves the card waiting)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def graph_time_ms(fn, n: int) -> float:
    """Device time per call: n calls captured in a CUDA graph and replayed,
    so that the host's launch work is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_time_ms(graph.replay, 3) / n


def k1_bound(D: int, d: int, w: int):
    """Least time of one matvec on the card (ms) and what bounds it: the
    largest of the two products on the bf16 tensor cores, the middle on the
    f32 FMA units (other units, so the two overlap), and the f32 operands
    GL, W, GR, x read once and y written once."""
    ops = max(2 * (2 * w * D * D * d * D) / PEAK_BF16,
              2 * w * w * d * d * D * D / PEAK_F32)
    mem = 4 * (2 * w * D * D + w * w * d * d + 2 * D * d * D) / PEAK_BYTES
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs the GPU")
    if not (REPO / "mpskit_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: no mpskit_tpu_torch package in {REPO}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")


def phase_build():
    from mpskit_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library("ac_apply_bf16")
    log(f"[build] K1 built and loaded in {time.perf_counter() - t0:.1f} s")
    for report in build.BUILD_DIR.glob("libac_apply_bf16_*.ptxas.txt"):
        for line in report.read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma")):
                log(f"[build] ptxas: {line.strip()}")


def phase_k1():
    import torch
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.kernels.ac_apply import (
        ac_apply_bf16, ac_apply_bf16_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"max_abs_err": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    with matmul_precision():
        for D, d, w in K1_SHAPES:
            GL, GR = randn(w, D, D) / D, randn(w, D, D) / D
            W, x = randn(w, w, d, d), randn(D, d, D)
            y = ac_apply_bf16(GL, W, GR, x)
            y_plain = ac_apply_bf16_reference(GL, W, GR, x)
            y_exact = ac_apply(GL, W, GR, x)
            torch.cuda.synchronize()
            if not torch.isfinite(y).all():
                raise RuntimeError(f"K1 output not finite at D={D}")
            rel_plain = float((y - y_plain).norm() / y_plain.norm())
            rel_exact = float((y - y_exact).norm() / y_exact.norm())
            abs_err = float((y - y_plain).abs().max())
            log(f"[k1] D={D} d={d} w={w}: rel err vs plain {rel_plain:.3e} "
                f"(tol {K1_TOL_PLAIN}), vs exact f32 {rel_exact:.3e} "
                f"(tol {K1_TOL_EXACT}), max abs err vs plain {abs_err:.3e}")
            if not (rel_plain <= K1_TOL_PLAIN and rel_exact <= K1_TOL_EXACT):
                raise RuntimeError(f"K1 disagrees with its references at D={D}")
            out["max_abs_err"] = max(out["max_abs_err"], abs_err)
            if D == 512:
                out.update(_k1_times(GL, W, GR, x, y, gen))
    return out


def _k1_times(GL, W, GR, x, y, gen):
    """Determinism and times of K1 at the main path's shape, in one call.
    The library yardstick is the kernel's two products as bf16 torch.matmul
    calls on bf16 copies made beforehand (the batched GL.x of stage 1 and
    the (dD x wD).(wD x D) of stage 3): not the same function (no middle,
    no rounding of t2), and never called by the port."""
    import torch
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply
    from mpskit_tpu_torch.kernels.ac_apply import (
        ac_apply_bf16, ac_apply_bf16_reference,
    )

    w, D, d = GL.shape[0], x.shape[0], x.shape[1]
    y2 = ac_apply_bf16(GL, W, GR, x)
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise RuntimeError("two K1 launches on the same inputs differ")
    log("[k1] D=512: two launches are bit-identical")

    bf = torch.bfloat16
    GLb, Xb = GL.to(bf), x.reshape(D, d * D).to(bf)
    T2b = torch.randn((d * D, w * D), generator=gen, device="cuda").to(bf)
    GRb = GR.permute(0, 2, 1).reshape(w * D, D).to(bf)  # [(b, n), r]
    fns = {
        "plain_ms": lambda: ac_apply_bf16_reference(GL, W, GR, x),
        "ms": lambda: ac_apply_bf16(GL, W, GR, x),
        "exact_ms": lambda: ac_apply(GL, W, GR, x),
        "library_ms": lambda: (torch.matmul(GLb, Xb), torch.matmul(T2b, GRb)),
    }
    # in turns, mirrored, so that every version sees the same drift
    order = list(fns) + list(fns)[::-1]
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(cuda_time_ms(fns[k], 50))
    t = {k: sum(v) / len(v) for k, v in runs.items()}
    t["device_ms"] = graph_time_ms(fns["ms"], 50)
    t["host_ms"] = host_time_ms(fns["ms"], 50)
    t["bound_ms"], t["bound_by"] = k1_bound(D, d, w)
    log(f"[k1] D=512 w={w} d={d} time per matvec (CUDA events, 50 calls, in "
        f"turns): kernel {t['ms']:.4f} ms, plain bf16 version "
        f"{t['plain_ms']:.4f} ms, exact f32 ac_apply {t['exact_ms']:.4f} ms, "
        f"bf16 torch.matmul yardstick {t['library_ms']:.4f} ms; kernel in a "
        f"CUDA graph {t['device_ms']:.4f} ms, host time to enqueue a call "
        f"{t['host_ms']:.4f} ms (runs: "
        + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in runs[k])
                    for k in runs) + ")")
    log(f"[k1] bound {t['bound_ms']:.5f} ms ({t['bound_by']}): "
        f"{t['bound_ms'] / t['ms']:.1%} of it reached per call, "
        f"{t['bound_ms'] / t['device_ms']:.1%} in the graph")
    return t


def phase_f64():
    import torch
    from mpskit_tpu_torch import (
        FiniteMPS, expectation_value, find_groundstate,
        transverse_field_ising_lattice,
    )

    L, g = 16, 1.5
    gen = torch.Generator(device="cuda").manual_seed(1)
    psi = FiniteMPS.random(L, 2, 32, torch.float64, "cuda", gen)
    H = transverse_field_ising_lattice(g=g)
    t0 = time.perf_counter()
    psi, envs, eps = find_groundstate(psi, H)
    E = float(expectation_value(psi, H, envs=envs))
    e0 = tfim_open_chain_e0(L, g)
    log(f"[f64] TFIM L={L} D=32 g={g}: E={E:.15f} E0={e0:.15f} "
        f"|dE|={abs(E - e0):.3e} (tol {E_TOL_F64}), eps={eps:.2e}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not abs(E - e0) <= E_TOL_F64:
        raise RuntimeError("float64 DMRG energy misses the closed form")
    return psi


def phase_slice():
    import torch
    from mpskit_tpu_torch import (
        DMRG, FiniteMPS, expectation_value, find_groundstate,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    L, d, D, g, sweeps = 32, 2, 512, 1.5, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    psi = FiniteMPS.random(L, d, D, torch.float32, "cuda", gen)
    H = transverse_field_ising_lattice(g=g)
    marks = []

    def mark(it, psi, H):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), sync.count))

    alg = DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
               maxiter=sweeps, finalize=mark, verbosity=0)
    torch.cuda.synchronize()
    k1.launches = 0
    sync.count = 0
    marks.append((time.perf_counter(), 0))
    psi, envs, eps = find_groundstate(psi, H, alg)
    torch.cuda.synchronize()
    launches = k1.launches
    E = float(expectation_value(psi, H, envs=envs))
    E_fresh = float(expectation_value(psi, H))
    e0 = tfim_open_chain_e0(L, g)
    for k in range(1, len(marks)):
        log(f"[slice] sweep {k}: {marks[k][0] - marks[k - 1][0]:.3f} s, "
            f"{marks[k][1] - marks[k - 1][1]} host syncs")
    log(f"[slice] K1 launches in the run: {launches}, host syncs: "
        f"{sync.count} over {len(marks) - 1} sweeps")
    rel = abs(E - e0) / abs(e0)
    log(f"[slice] TFIM L={L} D={D} float32: E={E:.8f} (fresh envs "
        f"{E_fresh:.8f}) E0={e0:.8f} rel err {rel:.3e} (tol {E_TOL_F32}), "
        f"eps={eps:.2e}")
    if not torch.isfinite(psi.AC).all() or psi.AC.shape != (D, d, D):
        raise RuntimeError("the DMRG state is not finite or has a wrong shape")
    if not rel <= E_TOL_F32:
        raise RuntimeError("float32 DMRG energy misses the closed form")
    if not abs(E - E_fresh) <= E_TOL_F32 * abs(e0):
        raise RuntimeError("the returned environments disagree with fresh ones")
    if launches <= 0:
        raise RuntimeError("the main path never launched K1")
    _bench_dmrg_sweeps(H, L, d, D)
    return launches


def _bench_dmrg_sweeps(H, L, d, D):
    """dmrg_sweep_time_tfim_L32_D512_float32 under bench.py:158-183's
    protocol: from a seeded random state with fresh right environments,
    one warm sweep, then 6 timed sweeps of `_dmrg_sweep_impl` (inner tol
    1e-6, krylovdim 10, 2 restarts, support masks, cheap_galerkin), with
    their host syncs; then one more sweep plainly, one split by
    synchronizations into eigensolves (K1 inside them), QR, environment
    pushes and the rest, and one under torch.profiler."""
    import torch
    from mpskit_tpu_torch import FiniteMPS
    from mpskit_tpu_torch.algorithms import dmrg
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.environments.finite import (
        compute_right_envs, right_boundary, stack_W,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.states.finitemps import support_mask
    from mpskit_tpu_torch.utils import sync

    gen = torch.Generator(device="cuda").manual_seed(0)
    psi = FiniteMPS.random(L, d, D, torch.float32, "cuda", gen)
    Ws = stack_W(H, L, torch.float32, "cuda")
    masks = torch.as_tensor(support_mask(L, d, D), device="cuda")
    w = Ws.shape[1]

    def sweep(state):
        ALs, ARs, AC, GRs = state
        out = dmrg._dmrg_sweep_impl(ALs, ARs, AC, Ws, GRs, 1e-6, 10, 2,
                                    masks=masks, cheap_galerkin=True)
        return out[:4], out[4]

    with matmul_precision():
        state = (psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone(),
                 compute_right_envs(psi.ARs, Ws, right_boundary(
                     w, D, torch.float32, "cuda")))
        launches = k1.launches
        state, lam0 = sweep(state)
        torch.cuda.synchronize()
        warm_launches = k1.launches - launches
        n, c0 = 6, sync.count
        t0 = time.perf_counter()
        for _ in range(n):
            state, lam = sweep(state)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        syncs = (sync.count - c0) / n
        launches = k1.launches - launches - warm_launches
        if not (np.isfinite(lam0) and np.isfinite(lam)):
            raise RuntimeError("a benchmark sweep gave a non-finite energy")
        log(json.dumps({"metric": f"dmrg_sweep_time_tfim_L{L}_D{D}_float32",
                        "value": dt, "unit": "s",
                        "host_syncs_per_sweep": syncs}))

        def again():
            return sweep(tuple(t.clone() for t in state))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        total, parts = _split_by_sync(again, dmrg, {
            "_solve_site": "eigensolves", "ac_apply_fast": "K1",
            "leftorth_hybrid": "QR", "rightorth_hybrid": "QR",
            "transfer_left_mpo": "environment pushes",
            "transfer_right_mpo": "environment pushes"}, inner=("K1",))
        log(f"[slice] bench.py protocol: warm sweep, then {n} sweeps "
            f"{dt:.4f} s/sweep, {syncs:.1f} host syncs/sweep, energy "
            f"{lam0:.8f} -> {lam:.8f}, K1 launches {warm_launches} in the "
            f"warm sweep and {launches} in the timed ones (K1 is absent from "
            f"the split when the sweep makes none); one more sweep "
            f"{plain:.1f} ms; split "
            f"({total:.1f} ms): " + "; ".join(
                f"{k} {t:.1f} ms ({t / total:.1%}, {c} syncs)"
                for k, (t, c) in parts.items()))
        busy, n_dev, _ = _device_busy_ms(again)
    log("[slice] the same sweep under torch.profiler: " + (
        f"{n_dev} kernels and copies on the device, busy {busy:.1f} ms of "
        f"the plain sweep's {plain:.1f} ms, idle share "
        f"{1 - busy / plain:.1%}" if busy else
        "no device time in the trace: idle share not measured"))


def phase_vumps_f64():
    import torch
    from mpskit_tpu_torch import (
        VUMPS, InfiniteMPS, expectation_value, find_groundstate,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1

    g, D = 1.5, 12
    gen = torch.Generator(device="cuda").manual_seed(5)
    psi = InfiniteMPS.random(1, 2, D, torch.float64, "cuda", gen)
    H = transverse_field_ising_lattice(g=g)
    launches = k1.launches
    t0 = time.perf_counter()
    psi, envs, eps = find_groundstate(psi, H, VUMPS(tol=1e-9, maxiter=150))
    e = float(expectation_value(psi, H, envs=envs)[0])
    e_env = float(envs.e_density)
    e0 = tfim_density(g)
    log(f"[vumps-f64] TFIM g={g} D={D}: e={e:.15f} (envs {e_env:.15f}) "
        f"e0={e0:.15f} |de|={abs(e - e0):.3e} (tol {E_TOL_VUMPS_F64}), "
        f"eps={eps:.2e}, {time.perf_counter() - t0:.1f} s, K1 launches "
        f"{k1.launches - launches}")
    if not (abs(e - e0) <= E_TOL_VUMPS_F64
            and abs(e_env - e0) <= E_TOL_VUMPS_F64):
        raise RuntimeError("float64 VUMPS energy misses the exact density")
    if k1.launches != launches:
        raise RuntimeError("float64 VUMPS launched K1")
    return psi


def _vumps_split(psi, H, env, marks):
    """One VUMPS iteration as `_vumps_iteration_impl` runs it, with a
    synchronization and a mark (time, host syncs) after each part."""
    import torch
    from mpskit_tpu_torch.algorithms import vumps
    from mpskit_tpu_torch.environments.finite import stack_W
    from mpskit_tpu_torch.environments.infinite_ham import (
        hamiltonian_environments,
    )
    from mpskit_tpu_torch.utils import sync

    a = VUMPS_ARGS

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(), sync.count))

    mark("start")
    envs = hamiltonian_environments(psi, H, tol=a["env_tol_static"],
                                    env_init=env)
    mark("environments")
    Ws = stack_W(H, psi.period, psi.dtype, psi.device)
    ACs, _ = vumps._solve_acs(envs, Ws, psi.AC, a["m"], a["restarts"],
                              a["inner_tol"])
    mark("AC solves")
    Cs, _ = vumps._solve_cs(envs, psi.C, a["m"], a["restarts"],
                            a["inner_tol"])
    mark("C solves")
    psi, eps = vumps._regauge(ACs, Cs)
    mark("regauge")
    return psi, eps, envs


def _device_busy_ms(fn):
    """Device time of the kernels and copies that `fn` launches, summed
    from a torch.profiler trace, their count, and {name: [ms, count]} of
    the operations by name (None, 0, {} if the trace holds no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw trace: `prof.events()` would parse it into Python event
    # objects first, minutes for the ~10^6 device operations of a DMRG2
    # sweep
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            entry = by_name.setdefault(e.name(), [0.0, 0])
            entry[0] += e.duration_ns() / 1e6
            entry[1] += 1
    busy = sum(v[0] for v in by_name.values())
    return ((busy if busy > 0 else None), sum(v[1] for v in by_name.values()),
            by_name)


def phase_vumps_slice():
    import torch
    from mpskit_tpu_torch import (
        InfiniteMPS, expectation_value, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms.vumps import _vumps_iteration_impl
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    D, d, g, a = VUMPS_D, 2, VUMPS_G, VUMPS_ARGS
    H = transverse_field_ising_lattice(g=g)
    e0 = tfim_density(g)
    gen = torch.Generator(device="cuda").manual_seed(6)

    def iterate(psi, env, n):
        for _ in range(n):
            psi, eps, env, diag = _vumps_iteration_impl(
                psi, H, a["m"], a["restarts"], a["gauge_tol"],
                a["env_tol_static"], a["inner_tol"], env_guess=env)
        return psi, eps, env, diag

    with matmul_precision():
        k1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psi = InfiniteMPS.random(1, d, D, torch.float32, "cuda", gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sync.count = 0
        psi, eps, env, _ = iterate(psi, None, VUMPS_WARMUP)
        eps_warm = sync.to_host(eps)[0]
        t2 = time.perf_counter()
        log(f"[vumps] D={D} float32: random state gauge-fixed in "
            f"{t1 - t0:.3f} s; {VUMPS_WARMUP} warm iterations "
            f"{t2 - t1:.3f} s, {sync.count} host syncs, eps {eps_warm:.3e}")

        # timed: 3 replays of the same 32 iterations from the warm state
        torch.cuda.synchronize()
        sync.count = 0
        t0 = time.perf_counter()
        for _ in range(VUMPS_REPS):
            out = iterate(psi, env, VUMPS_BATCH)
        torch.cuda.synchronize()
        n_iter = VUMPS_REPS * VUMPS_BATCH
        dt = (time.perf_counter() - t0) / n_iter
        syncs = sync.count / n_iter
        psi_end, eps_dev, env_end, diag = out
        eps_end = sync.to_host(eps_dev)[0]
        log(f"[vumps] {VUMPS_REPS} replays of iterations "
            f"{VUMPS_WARMUP + 1}..{VUMPS_WARMUP + VUMPS_BATCH}: {dt:.6f} "
            f"s/iter, {syncs:.2f} host syncs/iter; eps {eps_end:.3e}, "
            f"unconverged site solves {diag[0]}, env GMRES residual "
            f"{diag[1]:.3e}")
        log(json.dumps({"metric": f"vumps_iteration_time_tfim_D{D}_float32",
                        "value": dt, "unit": "s",
                        "host_syncs_per_iter": syncs}))

        # outside the timed window: one iteration split into its parts,
        # and one under the profiler for the device's busy time
        marks = []
        psi_x, eps_x, envs_x = _vumps_split(psi_end, H, env_end, marks)
        parts = [(marks[i][0], marks[i][1] - marks[i - 1][1],
                  marks[i][2] - marks[i - 1][2])
                 for i in range(1, len(marks))]
        total = marks[-1][1] - marks[0][1]
        log(f"[vumps] one iteration split ({total * 1e3:.3f} ms, "
            f"{marks[-1][2] - marks[0][2]} host syncs): " + "; ".join(
                f"{n} {t * 1e3:.3f} ms ({t / total:.1%}, {c} syncs)"
                for n, t, c in parts))
        # the profiled iteration repeats the split one (same state, same
        # environments), so its device time is set against the split's
        # wall time, which the profiler does not inflate
        busy, n_dev, _ = _device_busy_ms(
            lambda: iterate(psi_end, env_end, 1))
        log("[vumps] the same iteration under torch.profiler: " + (
            f"{n_dev} kernels and copies on the device, busy {busy:.3f} ms "
            f"of the split's {total * 1e3:.3f} ms, idle share "
            f"{1 - busy / (total * 1e3):.1%}" if busy else
            "no device time in the trace: idle share not measured"))

        launches = k1.launches
        e_env = float(envs_x.e_density)
        e = float(expectation_value(psi_x, H)[0])
    rel = max(abs(e - e0), abs(e_env - e0)) / abs(e0)
    log(f"[vumps] TFIM g={g} D={D} float32: e={e:.8f} (envs {e_env:.8f}) "
        f"e0={e0:.8f} rel err {rel:.3e} (tol {E_TOL_F32}), eps "
        f"{sync.to_host(eps_x)[0]:.3e}, K1 launches in this phase: "
        f"{launches}")
    shapes = {"AL": (1, D, d, D), "AR": (1, D, d, D), "AC": (1, D, d, D),
              "C": (1, D, D)}
    for name, shape in shapes.items():
        t = getattr(psi_x, name)
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise RuntimeError(f"VUMPS {name} is not finite or has shape "
                               f"{tuple(t.shape)}, expected {shape}")
    if not (np.isfinite(eps_end) and rel <= E_TOL_F32):
        raise RuntimeError("float32 VUMPS energy misses the exact density")
    if launches != 0:
        raise RuntimeError("VUMPS launched K1: its site solves must be exact")


def phase_dmrg2_f64():
    import torch
    from mpskit_tpu_torch import (
        DMRG2, FiniteMPS, expectation_value, find_groundstate, heisenberg_XXX,
        notrunc, transverse_field_ising_lattice, truncbelow,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1

    gen = torch.Generator(device="cuda").manual_seed(8)
    H_s1 = heisenberg_XXX(spin=1)
    e_ed = float(np.linalg.eigvalsh(H_s1.to_matrix(6))[0])
    cases = (("TFIM g=1.5 L=16 D=32, truncbelow(1e-9)",
              transverse_field_ising_lattice(g=1.5), 16, 2, 32,
              truncbelow(1e-9), tfim_open_chain_e0(16, 1.5)),
             ("spin-1 Heisenberg L=6 D=27 (ED, 729 states)", H_s1, 6, 3, 27,
              notrunc(), e_ed))
    launches = k1.launches
    for name, H, L, d, D, scheme, e0 in cases:
        psi = FiniteMPS.random(L, d, D, torch.float64, "cuda", gen)
        t0 = time.perf_counter()
        psi, envs, eps = find_groundstate(
            psi, H, DMRG2(maxiter=50, trscheme=scheme, verbosity=0))
        E = float(expectation_value(psi, H, envs=envs))
        log(f"[dmrg2-f64] {name}: E={E:.15f} E0={e0:.15f} |dE|="
            f"{abs(E - e0):.3e} (tol {E_TOL_F64}), eps={eps:.2e}, "
            f"{time.perf_counter() - t0:.1f} s")
        if not abs(E - e0) <= E_TOL_F64:
            raise RuntimeError(f"float64 DMRG2 misses the exact energy: {name}")
    if k1.launches != launches:
        raise RuntimeError("float64 DMRG2 launched K1")


class _patched:
    """Replace module attributes for the length of a `with` block (the
    observers of phase 9: they time or record what the real sweep calls)."""

    def __init__(self, module, **attrs):
        self.module, self.attrs, self.saved = module, attrs, {}

    def __enter__(self):
        for name, value in self.attrs.items():
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, value)
        return self

    def __exit__(self, *exc):
        for name, value in self.saved.items():
            setattr(self.module, name, value)


def _split_by_sync(run, module, part_of, inner=()):
    """Run `run()` once with a synchronization around every call of the
    attributes of `module` named in `part_of` ({attribute: part, or a
    function of the call's arguments that names the part}); returns
    (total ms, {part: [ms, host syncs]}) with the rest as "other". The
    parts named in `inner` run inside other parts: they are reported and
    left out of the sum that "other" is the rest of."""
    import torch
    from mpskit_tpu_torch.utils import sync

    parts = {}

    def timed(name, fn):
        label = part_of[name]

        def call(*args, **kwargs):
            part = label(*args, **kwargs) if callable(label) else label
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), sync.count
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            entry = parts.setdefault(part, [0.0, 0])
            entry[0] += (time.perf_counter() - t0) * 1e3
            entry[1] += sync.count - c0
            return out
        return call

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    with _patched(module, **{name: timed(name, getattr(module, name))
                             for name in part_of}):
        run()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    outer = [v for k, v in parts.items() if k not in inner]
    parts["other"] = [total - sum(v[0] for v in outer),
                      sync.count - c0 - sum(v[1] for v in outer)]
    return total, parts


def _svd_times():
    """The slice's SVD shape, 768 x 768, on a matrix with a two-site
    spectrum (singular values 10^(-8k/768), k = 0..767, in degenerate
    triplets like SU(2) multiplets, between random orthogonal factors):
    time per call (CUDA events) and accuracy of each route against the
    known factors: the largest error of the singular values, of the
    orthonormality of the 255 leading left vectors and of the rank-255
    truncation (255: a whole number of triplets), and whether its
    singular values equal those of torch's default bit for bit (which
    names the driver the default picked). `svd_truncated` takes the
    "float32 gesvd" route. Returns {route: (ms, S err, U orthonormality
    err, truncation err, equal to the default)}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    n, k = 3 * DMRG2_D, 3 * (DMRG2_D // 3)
    f64 = torch.float64
    s = 10.0 ** (-8.0 * 3 * (torch.arange(n, device="cuda", dtype=f64) // 3)
                 / n)
    U0 = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=f64,
                                     device="cuda"))[0]
    V0 = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=f64,
                                     device="cuda"))[0]
    M64 = (U0 * s) @ V0.T
    Mk = (U0[:, :k] * s[:k]) @ V0[:, :k].T
    M32 = M64.float()

    def gram(M):
        """SVD from the eigendecomposition of M^T M in float64."""
        w, V = torch.linalg.eigh(M.double().T @ M.double())
        S = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
        V = V.flip(1)
        U = (M.double() @ V) / torch.clamp(S, min=1e-30 * S[0])
        return U, S, V.T

    routes = {}
    for driver in (None, "gesvd", "gesvdj", "gesvda"):
        routes[f"float32 {driver or 'default'}"] = (
            lambda d=driver: torch.linalg.svd(M32, full_matrices=False,
                                              driver=d))
    for driver in (None, "gesvd"):
        routes[f"float64 {driver or 'default'}"] = (
            lambda d=driver: torch.linalg.svd(M32.double(),
                                              full_matrices=False, driver=d))
    routes["float64 Gram eigh"] = lambda: gram(M32)
    out = {}
    S_default = routes["float32 default"]()[1].double()
    eye = torch.eye(k, dtype=f64, device="cuda")
    for name, fn in routes.items():
        U, S, Vh = (t.double() for t in fn())
        out[name] = (
            cuda_time_ms(fn, 3),
            float((S - s).abs().max()),
            float((U[:, :k].T @ U[:, :k] - eye).abs().max()),
            float(((U[:, :k] * S[:k]) @ Vh[:k] - Mk).abs().max()),
            torch.equal(S, S_default))
    return out


def _log_svd_times():
    for name, (ms, s_err, u_err, k_err, same) in _svd_times().items():
        log(f"[svd] {3 * DMRG2_D} x {3 * DMRG2_D} from float32, {name}: "
            f"{ms:.3f} ms per call (CUDA events, 3 calls); max error: "
            f"singular values {s_err:.2e}, orthonormality of the leading "
            f"left vectors {u_err:.2e}, truncation {k_err:.2e}; singular "
            f"values {'equal' if same else 'differ from'} the default's")


def phase_dmrg2_slice():
    import torch
    from mpskit_tpu_torch import (
        DMRG, DMRG2, FiniteMPS, expectation_value, find_groundstate,
        heisenberg_XXX, truncdim,
    )
    from mpskit_tpu_torch.algorithms import dmrg2
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.environments.finite import stack_W
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync
    from mpskit_tpu_torch.utils.dynamictols import updatetol

    L, d, D, sweeps = DMRG2_L, 3, DMRG2_D, DMRG2_SWEEPS
    H = heisenberg_XXX(spin=1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    psi = FiniteMPS.random(L, d, D, torch.float32, "cuda", gen)
    scheme, m, restarts = truncdim(D), 10, 2
    marks, errs = [], []

    def mark(it, psi, H):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), sync.count))

    def recorded(*args, **kwargs):
        out = sweep_impl(*args, **kwargs)
        errs.append(out[5])
        return out

    sweep_impl = dmrg2._dmrg2_sweep_impl
    alg = DMRG2(tol=0.0, maxiter=sweeps, krylovdim=m, eig_maxrestarts=restarts,
                trscheme=scheme, finalize=mark, verbosity=0)
    k1.launches = 0
    torch.cuda.synchronize()
    sync.count = 0
    marks.append((time.perf_counter(), 0))
    with _patched(dmrg2, _dmrg2_sweep_impl=recorded):
        psi, envs, eps = find_groundstate(psi, H, alg)
    torch.cuda.synchronize()
    times = [marks[k][0] - marks[k - 1][0] for k in range(1, len(marks))]
    syncs = [marks[k][1] - marks[k - 1][1] for k in range(1, len(marks))]
    for k, (t, c, e) in enumerate(zip(times, syncs, errs), 1):
        log(f"[dmrg2] sweep {k}: {t:.3f} s, {c} host syncs, largest "
            f"discarded weight {e:.3e}")
    value = sum(times[1:]) / len(times[1:])
    per_sweep = sum(syncs[1:]) / len(syncs[1:])
    log(json.dumps({"metric": "dmrg2_sweep_time_heisenberg_s1_L32_D256_float32",
                    "value": value, "unit": "s",
                    "host_syncs_per_sweep": per_sweep}))

    # outside the timed run, from its final state: one sweep timed plainly,
    # one split by synchronizations, one under the profiler
    Ws = stack_W(H, L, psi.dtype, psi.device)
    sup = torch.as_tensor(dmrg2.bond_support_vectors(L, d, D), device="cuda")
    inner_tol = updatetol(eps, sweeps + 1)

    def sweep():
        return sweep_impl(psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone(),
                          Ws, envs.GRs.clone(), inner_tol, m, restarts, scheme,
                          sup=sup)

    with matmul_precision():
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        sweep()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        log(f"[dmrg2] one more sweep: {plain:.1f} ms, {sync.count - c0} host "
            "syncs")
        total, parts = _split_by_sync(sweep, dmrg2, {
            "eigsh_smallest": "eigensolves", "_split2": "SVD splits",
            "transfer_left_mpo": "environment pushes",
            "transfer_right_mpo": "environment pushes"})
        log(f"[dmrg2] the same sweep split ({total:.1f} ms): " + "; ".join(
            f"{n} {t:.1f} ms ({t / total:.1%}, {c} syncs)"
            for n, (t, c) in parts.items()))
        busy, n_dev, _ = _device_busy_ms(sweep)
        log("[dmrg2] the same sweep under torch.profiler: " + (
            f"{n_dev} kernels and copies on the device, busy {busy:.1f} ms "
            f"of the plain sweep's {plain:.1f} ms, idle share "
            f"{1 - busy / plain:.1%}" if busy else
            "no device time in the trace: idle share not measured"))
        _log_svd_times()
    launches = k1.launches

    E = float(expectation_value(psi, H, envs=envs))
    E_fresh = float(expectation_value(psi, H))
    # the trscheme chain of find_groundstate: one-site DMRG from the DMRG2
    # state, here in float64
    psi64 = FiniteMPS(psi.ALs.double(), psi.ARs.double(), psi.AC.double(), 0)
    t0 = time.perf_counter()
    psi64, envs64, eps64 = find_groundstate(
        psi64, H, DMRG(tol=1e-9, maxiter=12, verbosity=0))
    E64 = float(expectation_value(psi64, H, envs=envs64))
    rel = abs(E - E64) / abs(E64)
    log(f"[dmrg2] spin-1 Heisenberg L={L} D={D} float32: E={E:.8f} (fresh "
        f"envs {E_fresh:.8f}); float64 one-site continuation E={E64:.10f} "
        f"eps={eps64:.2e} (tol 1e-9) in {time.perf_counter() - t0:.1f} s; "
        f"rel diff {rel:.3e} (tol {E_TOL_F32}); K1 launches in this phase: "
        f"{launches}")
    shapes = {"ALs": (L, D, d, D), "ARs": (L, D, d, D), "AC": (D, d, D)}
    for name, shape in shapes.items():
        t = getattr(psi, name)
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise RuntimeError(f"DMRG2 {name} is not finite or has shape "
                               f"{tuple(t.shape)}, expected {shape}")
    if not eps64 < 1e-9:
        raise RuntimeError("the float64 continuation did not converge")
    if not rel <= E_TOL_F32:
        raise RuntimeError("float32 DMRG2 energy misses the float64 one")
    if not abs(E - E_fresh) <= E_TOL_F32 * abs(E64):
        raise RuntimeError("the returned environments disagree with fresh ones")
    if launches != 0:
        raise RuntimeError("DMRG2 launched K1: its bond solves must be exact")
    return E64


def phase_bonds(psi_vumps, psi_dmrg):
    import torch
    from mpskit_tpu_torch import (
        IDMRG1, IDMRG2, InfiniteMPS, OptimalExpand, SvdCut, VUMPSSvdCut,
        changebonds, expectation_value, find_groundstate,
        transverse_field_ising_lattice, truncbelow,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1

    g, D = 1.5, 12
    e0 = tfim_density(g)
    gen = torch.Generator(device="cuda").manual_seed(11)
    launches = k1.launches
    for name, period, alg in (
            ("IDMRG1", 1, IDMRG1(tol=1e-10, maxiter=300, verbosity=0)),
            ("IDMRG2", 2, IDMRG2(tol=1e-10, maxiter=200,
                                 trscheme=truncbelow(1e-10), verbosity=0))):
        H = transverse_field_ising_lattice(g=g, period=period)
        psi = InfiniteMPS.random(period, 2, D, torch.float64, "cuda", gen)
        t0 = time.perf_counter()
        psi, envs, err = find_groundstate(psi, H, alg)
        e = expectation_value(psi, H, envs=envs).cpu().numpy()
        de = float(np.abs(e - e0).max())
        log(f"[bonds] {name} TFIM g={g} D={D} cell {period}: e={e} "
            f"|de|={de:.3e} (tol {E_TOL_IDMRG}), err={err:.2e}, "
            f"{time.perf_counter() - t0:.1f} s")
        if not de <= E_TOL_IDMRG:
            raise RuntimeError(f"{name} misses the exact energy density")

    H = transverse_field_ising_lattice(g=g)
    e_small = float(expectation_value(psi_vumps, H)[0])
    grown = changebonds(psi_vumps, H, OptimalExpand(dims=D))
    e_grown = float(expectation_value(grown, H)[0])
    iso = max(float((torch.einsum("lpm,lpn->mn", A.conj(), A)
                     - torch.eye(grown.D, dtype=A.dtype, device=A.device))
                    .abs().max()) for A in grown.AL)
    cut = changebonds(grown, H, VUMPSSvdCut(truncbelow(1e-8)))
    e_cut = expectation_value(cut, H).cpu().numpy()
    log(f"[bonds] OptimalExpand({D}): D {psi_vumps.D} -> {grown.D}, e "
        f"{e_small:.15f} -> {e_grown:.15f} (|de| {abs(e_grown - e_small):.3e},"
        f" tol 1e-7), AL isometry error {iso:.2e} (tol 1e-10); "
        f"VUMPSSvdCut(truncbelow(1e-8)): period {cut.period}, e={e_cut}, "
        f"|de| vs exact {float(np.abs(e_cut - e0).max()):.3e} (tol 1e-5)")
    if grown.D != 2 * D or not abs(e_grown - e_small) <= 1e-7 or iso > 1e-10:
        raise RuntimeError("OptimalExpand changed the state or its gauge")
    if cut.period != 2 or not float(np.abs(e_cut - e0).max()) <= 1e-5:
        raise RuntimeError("VUMPSSvdCut misses the exact energy density")

    cut = changebonds(psi_dmrg, SvdCut(truncbelow(1e-12)))
    ov = abs(complex(psi_dmrg.dot(cut)))
    log(f"[bonds] SvdCut(truncbelow(1e-12)) on the TFIM L=16 D=32 DMRG "
        f"state: |<psi|cut>| = {ov:.15f} (tol 1e-8); K1 launches in this "
        f"phase: {k1.launches - launches}")
    if not abs(ov - 1.0) <= 1e-8:
        raise RuntimeError("SvdCut below 1e-12 changed the finite state")
    if k1.launches != launches:
        raise RuntimeError("float64 IDMRG or changebonds launched K1")


def _mps_vector(psi):
    """The d^L state vector of a small FiniteMPS, as a host complex128
    array (the padded boundary bonds contribute their index 0)."""
    p = psi.move_center(0)
    v = p.AC[:1].cpu().resolve_conj().numpy()
    for i in range(1, psi.length):
        v = np.tensordot(v, p.ARs[i].cpu().resolve_conj().numpy(), axes=1)
    return v[..., :1].reshape(-1).astype(np.complex128)


def _exact_evolution(H, L, v0, t):
    """exp(-i H t) v0 from the eigendecomposition of the dense H."""
    E, V = np.linalg.eigh(H.to_matrix(L))
    return V @ (np.exp(-1j * E * t) * (V.conj().T @ v0))


def phase_tdvp_f64():
    import torch
    from mpskit_tpu_torch import (
        TDVP, TDVP2, VUMPS, WII, FiniteMPS, InfiniteMPS, TaylorCluster,
        expectation_value, find_groundstate, time_evolve, timestep,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms.derivatives import ac_apply
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.kernels import ac_apply as k1

    c128 = torch.complex128
    gen = torch.Generator(device="cuda").manual_seed(12)
    launches = k1.launches

    # both finite integrators are exact at full bond dimension
    L, D, dt = 8, 16, TDVP_DT
    H = transverse_field_ising_lattice(g=TDVP_G1)
    psi0 = FiniteMPS.random(L, 2, D, c128, "cuda", gen)
    v0 = _mps_vector(psi0)
    exact = _exact_evolution(H, L, v0, TDVP_STEPS * dt)
    for name, alg in (("TDVP", TDVP()), ("TDVP2", TDVP2())):
        psi = psi0
        t0 = time.perf_counter()
        for k in range(TDVP_STEPS):
            psi, _ = timestep(psi, H, k * dt, dt, alg)
        v = _mps_vector(psi)
        err = 1 - abs(np.vdot(exact, v))
        log(f"[tdvp-f64] {name} TFIM g={TDVP_G1} L={L} D={D}, "
            f"{TDVP_STEPS} steps of dt={dt}: 1 - |<exact|psi>| = {err:.3e} "
            f"(tol {E_TOL_TDVP_EXACT}), 1 - |<psi0|psi>| = "
            f"{1 - abs(np.vdot(v0, v)):.3e}, {time.perf_counter() - t0:.1f} s")
        if not err <= E_TOL_TDVP_EXACT:
            raise RuntimeError(f"{name} misses the exact evolution")

    # the evolution MPOs through time_evolve, without truncation
    L, D, dt = 6, 8, 0.02
    psi0 = FiniteMPS.random(L, 2, D, c128, "cuda", gen)
    v0 = _mps_vector(psi0)
    exact = _exact_evolution(H, L, v0, 2 * dt)
    bound = 2 * 3 * L * dt ** 2   # tests/test_timeevo_mpo.py:40, two steps
    for name, alg in (("WII", WII()), ("TaylorCluster(2)", TaylorCluster(2))):
        psi, _ = time_evolve(psi0, H, [0.0, dt, 2 * dt], alg)
        v = _mps_vector(psi)
        dist = float(np.linalg.norm(v * np.exp(-1j * np.angle(
            np.vdot(exact, v))) - exact))
        log(f"[tdvp-f64] time_evolve {name} L={L} D={D}, 2 steps of "
            f"dt={dt}: |psi - exact| = {dist:.3e} (bound {bound:.3e}), "
            f"on {psi.device}")
        if not (dist <= bound and psi.device.type == "cuda"):
            raise RuntimeError(f"time_evolve with {name} misses the exact "
                               "evolution")

    # infinite TDVP, on the card and on the CPU from the same state
    H0 = transverse_field_ising_lattice(g=TDVP_INF_G0)
    H1 = transverse_field_ising_lattice(g=TDVP_INF_G1)
    psi = InfiniteMPS.random(1, 2, TDVP_INF_D, torch.float64, "cuda", gen)
    psi, _, eps = find_groundstate(psi, H0, VUMPS(tol=1e-10, maxiter=200,
                                                  verbosity=0))
    states = {dev: InfiniteMPS(*(x.to(device=dev, dtype=c128) for x in (
        psi.AL, psi.AR, psi.AC, psi.C))) for dev in ("cuda", "cpu")}
    es = {}
    for dev, p in states.items():
        envs, es[dev] = None, []
        t0 = time.perf_counter()
        for k in range(TDVP_STEPS):
            p, envs = timestep(p, H1, k * TDVP_DT, TDVP_DT, TDVP(), envs=envs)
            es[dev].append(float(expectation_value(p, H1)[0]))
        log(f"[tdvp-f64] infinite TDVP on {dev}, TFIM g={TDVP_INF_G0} -> "
            f"{TDVP_INF_G1}, D={TDVP_INF_D} (VUMPS eps {eps:.1e}): e(t) = "
            f"{es[dev]}, {time.perf_counter() - t0:.1f} s")
    de = max(abs(a - b) for a, b in zip(es["cuda"], es["cpu"]))
    log(f"[tdvp-f64] infinite TDVP card vs CPU: max |de| = {de:.3e} (tol "
        f"{E_TOL_TDVP_INF})")
    if not de <= E_TOL_TDVP_INF:
        raise RuntimeError("infinite TDVP on the card disagrees with the CPU")

    # a complex64 matvec on cuBLAS against complex128: TF32 would show as
    # ~1e-3 relative
    D, w, d = TDVP_D, 3, 2

    def crandn(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device="cuda",
                                         dtype=torch.float64),
                             torch.randn(shape, generator=gen, device="cuda",
                                         dtype=torch.float64))

    GL, W, GR, x = crandn(w, D, D) / D, crandn(w, w, d, d), \
        crandn(w, D, D) / D, crandn(D, d, D)
    with matmul_precision():
        y64 = ac_apply(*(t.to(torch.complex64) for t in (GL, W, GR, x)))
        y128 = ac_apply(GL, W, GR, x)
    rel = float((y64.to(c128) - y128).norm() / y128.norm())
    log(f"[tdvp-f64] complex64 ac_apply at D={D} against complex128: "
        f"relative error {rel:.3e} (tol {C64_MATVEC_TOL}); K1 launches in "
        f"this phase: {k1.launches - launches}")
    if not rel <= C64_MATVEC_TOL:
        raise RuntimeError("the complex64 matvec is not float32-exact")
    if k1.launches != launches:
        raise RuntimeError("time evolution launched K1")


def _complex_start(psi):
    """The float32 state psi as complex128 and complex64 states of one
    vector: its center-0 tensors re-canonicalized in complex128 (float32
    isometries are isometries only to float32 rounding, which would show
    as a 1e-7 energy step in the first complex128 timestep), then rounded
    to complex64."""
    import torch
    from mpskit_tpu_torch import FiniteMPS

    p = psi.move_center(0)
    As = torch.cat([p.AC[None], p.ARs[1:]]).to(torch.complex128)
    psi128 = FiniteMPS.from_tensors(As)
    psi64 = FiniteMPS(*(x.to(torch.complex64) for x in (
        psi128.ALs, psi128.ARs, psi128.AC)), 0)
    return {torch.complex64: psi64, torch.complex128: psi128}


def phase_tdvp_slice():
    import torch
    from mpskit_tpu_torch import (
        DMRG, TDVP, FiniteMPS, expectation_value, find_groundstate, timestep,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms import tdvp
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    L, d, D, dt, n = TDVP_L, 2, TDVP_D, TDVP_DT, TDVP_STEPS
    H0 = transverse_field_ising_lattice(g=TDVP_G0)
    H1 = transverse_field_ising_lattice(g=TDVP_G1)
    gen = torch.Generator(device="cuda").manual_seed(13)
    psi = FiniteMPS.random(L, d, D, torch.float32, "cuda", gen)
    t0 = time.perf_counter()
    psi, envs, eps = find_groundstate(psi, H0, DMRG(tol=1e-8, maxiter=12,
                                                    verbosity=0))
    E_gs = float(expectation_value(psi, H0, envs=envs))
    e0 = tfim_open_chain_e0(L, TDVP_G0)
    rel_gs = abs(E_gs - e0) / abs(e0)
    log(f"[tdvp] ground state TFIM g={TDVP_G0} L={L} D={D} float32: "
        f"E={E_gs:.8f} E0={e0:.8f} rel err {rel_gs:.3e} (tol {E_TOL_F32}), "
        f"eps={eps:.2e}, {time.perf_counter() - t0:.1f} s")
    if not rel_gs <= E_TOL_F32:
        raise RuntimeError("the float32 ground state misses the closed form")

    alg = TDVP(expalg_m=TDVP_M)
    estimates = []

    def recorded(alg_, exp_err, *args, **kwargs):
        estimates.append(exp_err)
        return warn(alg_, exp_err, *args, **kwargs)

    warn = tdvp._warn_exp
    trajectories = {}
    for dtype, p in _complex_start(psi).items():
        energies = [float(expectation_value(p, H1))]
        norms, times, syncs = [], [], []
        estimates.clear()
        main = dtype == torch.complex64
        if main:
            k1.launches = 0
        with _patched(tdvp, _warn_exp=recorded):
            for k in range(n):
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), sync.count
                p, _ = timestep(p, H1, k * dt, dt, alg)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                syncs.append(sync.count - c0)
                energies.append(float(expectation_value(p, H1)))
                norms.append(float(p.norm()))
        if main:
            launches = k1.launches
        trajectories[dtype] = (p, energies)
        tag = str(dtype).replace("torch.", "")
        for k in range(n):
            log(f"[tdvp] {tag} step {k + 1}: {times[k]:.3f} s, {syncs[k]} "
                f"host syncs, worst Krylov estimate {estimates[k]:.3e}, "
                f"E={energies[k + 1]:.12f}, |norm - 1| = "
                f"{abs(norms[k] - 1):.3e}")
        if main:
            value = sum(times[1:]) / len(times[1:])
            log(json.dumps({
                "metric": "tdvp_step_time_tfim_quench_L32_D256_complex64",
                "value": value, "unit": "s",
                "host_syncs_per_step": sum(syncs[1:]) / len(syncs[1:]),
                "step_times_s": times}))
            norm_err = max(abs(x - 1) for x in norms)

    p64, E64 = trajectories[torch.complex64]
    p128, E128 = trajectories[torch.complex128]
    rel_t0 = abs(E64[0] - E_T0_REF) / abs(E_T0_REF)
    rel_64 = max(abs(a - b) for a, b in zip(E64, E128)) / abs(E128[0])
    drift = max(abs(e - E128[0]) for e in E128) / abs(E128[0])
    log(f"[tdvp] quench to g={TDVP_G1}: E(0) = {E64[0]:.12f} against "
        f"{E_T0_REF} (JAX CPU complex128) rel {rel_t0:.3e} (tol "
        f"{E_TOL_QUENCH_T0}); complex64 against complex128 over the steps "
        f"rel {rel_64:.3e} (tol {E_TOL_F32}); complex128 drift {drift:.3e} "
        f"(tol {E_TOL_TDVP_DRIFT}); complex64 max |norm - 1| {norm_err:.3e} "
        f"(tol {E_TOL_F32}); K1 launches during the steps: {launches}")

    # outside the timed run, from its final state: one more step timed
    # plainly, one split by synchronizations, one under the profiler
    def step():
        return timestep(p64, H1, n * dt, dt, alg)

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    step()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    log(f"[tdvp] one more step: {plain:.1f} ms, {sync.count - c0} host "
        "syncs")
    total, parts = _split_by_sync(step, tdvp, {
        "expm_multiply_err": lambda mv, v, *a, **k: (
            "AC exponentials" if v.dim() == 3 else "C exponentials"),
        "leftorth": "QR/LQ", "rightorth": "QR/LQ",
        "transfer_left_mpo": "environment pushes",
        "transfer_right_mpo": "environment pushes",
        "compute_right_envs": "environment pushes"})
    log(f"[tdvp] the same step split ({total:.1f} ms): " + "; ".join(
        f"{name} {t:.1f} ms ({t / total:.1%}, {c} syncs)"
        for name, (t, c) in parts.items()))
    busy, n_dev, by_name = _device_busy_ms(step)
    log("[tdvp] the same step under torch.profiler: " + (
        f"{n_dev} kernels and copies on the device, busy {busy:.1f} ms of "
        f"the plain step's {plain:.1f} ms, idle share {1 - busy / plain:.1%}"
        if busy else "no device time in the trace: idle share not measured"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, count) in top:
        log(f"[tdvp] device op {ms:.2f} ms in {count} calls: {name[:110]}")

    for name, shape in (("ALs", (L, D, d, D)), ("ARs", (L, D, d, D)),
                        ("AC", (D, d, D))):
        for q in (p64, p128):
            t = getattr(q, name)
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise RuntimeError(f"TDVP {name} is not finite or has shape "
                                   f"{tuple(t.shape)}, expected {shape}")
    if not rel_t0 <= E_TOL_QUENCH_T0:
        raise RuntimeError("the quench energy at t=0 misses the JAX value")
    if not rel_64 <= E_TOL_F32:
        raise RuntimeError("complex64 TDVP energies miss the complex128 ones")
    if not drift <= E_TOL_TDVP_DRIFT:
        raise RuntimeError("complex128 TDVP does not conserve the energy")
    if not norm_err <= E_TOL_F32:
        raise RuntimeError("complex64 TDVP does not keep the norm")
    if launches != 0:
        raise RuntimeError("TDVP launched K1: its exponentials are exact")
    return launches


def _tfim_gs_f64(g, D, gen, alg):
    """A float64 infinite TFIM state on the card from `gen`, through
    find_groundstate with `alg` (None: the default chain); returns
    (H, psi, envs, eps, seconds)."""
    import torch
    from mpskit_tpu_torch import (
        InfiniteMPS, find_groundstate, transverse_field_ising_lattice,
    )

    H = transverse_field_ising_lattice(g=g)
    psi = InfiniteMPS.random(1, 2, D, torch.float64, "cuda", gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, envs, eps = find_groundstate(psi, H, alg, verbosity=0)
    torch.cuda.synchronize()
    return H, psi, envs, eps, time.perf_counter() - t0


class _grassmann_observed(_patched):
    """Observe a GradientGrassmann run from outside: `evaluations` counts
    the energy-and-gradient evaluations (the set-up one and the line
    searches'), `gnorm0` is the norm of the first gradient, `steps` holds
    the time of each accepted CG step's end (each calls `_cg_beta` once,
    just before the step's host read, so the synchronization here costs
    the step nothing)."""

    def __init__(self, finite=False):
        import torch
        from mpskit_tpu_torch.algorithms import grassmann

        name = ("_energy_and_gradient_finite" if finite
                else "_energy_and_gradient")
        evaluate, beta = getattr(grassmann, name), grassmann._cg_beta
        self.evaluations, self.first, self.steps = 0, None, []

        def evaluated(*args, **kwargs):
            out = evaluate(*args, **kwargs)
            self.evaluations += 1
            if self.first is None:
                self.first = out[1]
            return out

        def stepped(*args):
            out = beta(*args)
            torch.cuda.synchronize()
            self.steps.append(time.perf_counter())
            return out

        super().__init__(grassmann, **{name: evaluated, "_cg_beta": stepped})

    @property
    def gnorm0(self):
        import torch

        return float(torch.linalg.vector_norm(self.first))

    def seconds_per_step(self):
        """Mean time of the accepted steps after the first (their line
        searches and CG updates, without the set-up evaluation and the
        final environment solve)."""
        n = len(self.steps)
        return (self.steps[-1] - self.steps[0]) / (n - 1) if n > 1 else None


def phase_qp_f64():
    """Phase 13: GradientGrassmann, the quasiparticle solves, their gauges
    and FiniteExcited in float64 / complex128 on the card, each against
    an exact or JAX value."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, FiniteExcited, FiniteMPS, GradientGrassmann, InfiniteMPS,
        QuasiparticleAnsatz, excitations, find_groundstate,
        left_to_right_gauge, right_to_left_gauge,
        transverse_field_ising, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms.excitations import (
        excitations_infinite_batched,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.states.quasiparticle import LeftGaugedQP

    gen = torch.Generator(device="cuda").manual_seed(14)
    launches = k1.launches

    # the default infinite find_groundstate: VUMPS at 1e-9, then the
    # GradientGrassmann refinement at the default tol 1e-10
    g = QP_G
    with _grassmann_observed() as gg:
        H, psi, envs, eps, dt = _tfim_gs_f64(g, QP_D, gen, None)
    e = float(envs.e_density)
    log(f"[qp-f64] default find_groundstate(InfiniteMPS, H), TFIM g={g} "
        f"D={QP_D}: e={e:.16f} against JAX {E_GG_JAX} |de|="
        f"{abs(e - E_GG_JAX):.3e} (tol {E_TOL_GG}); GradientGrassmann "
        f"{len(gg.steps)} iterations, {gg.evaluations} evaluations, "
        f"gradient norm {gg.gnorm0:.3e} -> eps {eps:.3e}; {dt:.1f} s")
    if not abs(e - E_GG_JAX) <= E_TOL_GG:
        raise RuntimeError("the default infinite find_groundstate misses "
                           "the JAX energy density")

    # the reference quality gate on a finite chain
    Hg = transverse_field_ising(g=4.0)
    L = 10
    fpsi = FiniteMPS.random(L, 2, 6, torch.complex128, "cuda", gen)
    t0 = time.perf_counter()
    with _grassmann_observed(finite=True) as fgg:
        fpsi, _, feps = find_groundstate(fpsi, Hg, GradientGrassmann(
            tol=1e-6, maxiter=150, verbosity=0))
    v = _mps_vector(fpsi)
    Hm = Hg.to_matrix(L)
    var = float(np.linalg.norm(Hm @ v) ** 2 - np.vdot(v, Hm @ v).real ** 2)
    log(f"[qp-f64] finite GradientGrassmann TFIM g=4 L={L} D=6: variance "
        f"{var:.3e} (tol 1e-2), eps {feps:.3e}, "
        f"{len(fgg.steps)} iterations, "
        f"{time.perf_counter() - t0:.1f} s")
    if not abs(var) < 1e-2:
        raise RuntimeError("finite GradientGrassmann misses the quality gate")

    # the finite QP gap at g=10 (BASELINE.md row 2)
    gq, Lq, Dq = 10.0, 16, 32
    Hq = transverse_field_ising_lattice(g=gq)
    qpsi = FiniteMPS.random(Lq, 2, Dq, torch.float64, "cuda", gen)
    t0 = time.perf_counter()
    qpsi, _, _ = find_groundstate(qpsi, Hq, DMRG(tol=1e-9, maxiter=40,
                                                 verbosity=0))
    es, _ = excitations(Hq, QuasiparticleAnsatz(tol=1e-6), qpsi, num=1)
    rel = abs(float(es[0]) - 2 * (gq - 1)) / (2 * (gq - 1))
    log(f"[qp-f64] excitations_finite TFIM g={gq} L={Lq} D={Dq}: gap "
        f"{float(es[0]):.10f} against 2(g-1) = {2 * (gq - 1)}, rel "
        f"{rel:.3e} (tol 1e-2), {time.perf_counter() - t0:.1f} s")
    if not rel < 1e-2:
        raise RuntimeError("the finite QP gap misses 2(g-1)")

    # FiniteExcited against ED
    Le = 8
    He = transverse_field_ising_lattice(g=1.5)
    epsi = FiniteMPS.random(Le, 2, 16, torch.float64, "cuda", gen)
    epsi, _, _ = find_groundstate(epsi, He, DMRG(tol=1e-12, maxiter=50,
                                                 verbosity=0))
    t0 = time.perf_counter()
    ees, _ = excitations(He, FiniteExcited(tol=1e-10, maxiter=40), epsi,
                         num=1, generator=gen)
    e1 = float(np.linalg.eigvalsh(He.to_matrix(Le))[1])
    log(f"[qp-f64] FiniteExcited TFIM g=1.5 L={Le}: E1={float(ees[0]):.12f} "
        f"ED {e1:.12f} |dE|={abs(float(ees[0]) - e1):.3e} (tol 1e-6), "
        f"{time.perf_counter() - t0:.1f} s")
    if not abs(float(ees[0]) - e1) <= 1e-6:
        raise RuntimeError("FiniteExcited misses the ED energy")

    # the infinite QP at p = 0 and pi from the refined state
    t0 = time.perf_counter()
    ies, _ = excitations(H, QuasiparticleAnsatz(tol=1e-7), [0.0, np.pi],
                         psi, envs=envs)
    ies = ies[:, 0].numpy()
    exact = np.array([2 * (g - 1), 2 * (g + 1)])
    log(f"[qp-f64] excitations_infinite TFIM g={g} D={QP_D}: p=0 "
        f"{ies[0]:.10f}, p=pi {ies[1]:.10f} against {exact.tolist()}, max "
        f"|dE| {np.abs(ies - exact).max():.3e} (tol 5e-3), "
        f"{time.perf_counter() - t0:.1f} s")
    if not np.abs(ies - exact).max() < 5e-3:
        raise RuntimeError("the infinite QP misses the TFIM dispersion")

    # the dispersion in complex128 against the exact one
    cpsi = InfiniteMPS(*(x.to(torch.complex128) for x in (
        psi.AL, psi.AR, psi.AC, psi.C)))
    momenta = np.array([0.0, 0.7, np.pi])
    t0 = time.perf_counter()
    disp = excitations_infinite_batched(H, QuasiparticleAnsatz(tol=1e-10),
                                        momenta, cpsi).numpy()
    exact = 2 * np.sqrt(1 + g * g - 2 * g * np.cos(momenta))
    dd = float(np.abs(disp - exact).max())
    log(f"[qp-f64] complex128 dispersion at p = {momenta.tolist()}: "
        f"{disp.real} against {exact}, max |dE| {dd:.3e} (tol 5e-3), "
        f"{time.perf_counter() - t0:.1f} s")
    if not dd < 5e-3:
        raise RuntimeError("the complex128 dispersion misses the exact one")

    # the gauge round trip
    qp = LeftGaugedQP.random(cpsi, momentum=0.7, generator=gen)
    back = right_to_left_gauge(left_to_right_gauge(qp))
    db = float((back.bs() - qp.bs()).abs().max())
    log(f"[qp-f64] left -> right -> left gauge at p=0.7: max |dB| {db:.3e} "
        f"(tol 1e-10); K1 launches in this phase: {k1.launches - launches}")
    if not db <= 1e-10:
        raise RuntimeError("the QP gauge round trip changes B")
    if k1.launches != launches:
        raise RuntimeError("the float64 QP paths launched K1")
    return k1.launches - launches


def phase_haldane():
    """Phase 14: the spin-1 Haldane gap at D=48 through find_groundstate
    (VUMPS then GradientGrassmann) and excitations at p = pi."""
    import importlib

    import torch
    from mpskit_tpu_torch import (
        VUMPS, GradientGrassmann, InfiniteMPS, QuasiparticleAnsatz,
        excitations, find_groundstate, heisenberg_XXX,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.linalg import gmres
    from mpskit_tpu_torch.utils import sync

    fgs = importlib.import_module(
        "mpskit_tpu_torch.algorithms.find_groundstate")
    texc = importlib.import_module("mpskit_tpu_torch.algorithms.excitations")
    D = HALDANE_D
    H = heisenberg_XXX(spin=1)
    gen = torch.Generator(device="cuda").manual_seed(15)
    psi = InfiniteMPS.random(1, 3, D, torch.float64, "cuda", gen)
    k1.launches = 0

    # the chain's VUMPS stage is observed: its iterations (finalize hook),
    # its eps and energy (a recording wrapper in the dispatch table)
    stages = {}

    def vumps_recorded(psi, H, alg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fgs.find_groundstate_vumps(psi, H, alg)
        torch.cuda.synchronize()
        stages["vumps"] = (out[2], float(out[1].e_density),
                           time.perf_counter() - t0)
        return out

    iters = []
    table = tuple((cls, vumps_recorded if cls is VUMPS else run)
                  for cls, run in fgs._INFINITE)
    chain = (VUMPS(tol=1e-9, maxiter=200, verbosity=0,
                   finalize=lambda it, psi, H: iters.append(it))
             & GradientGrassmann(tol=1e-10, maxiter=20, verbosity=0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _patched(fgs, _INFINITE=table), _grassmann_observed() as gg:
        psi, envs, gnorm = find_groundstate(psi, H, chain)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    eps_v, e_v, t_v = stages["vumps"]
    e_g = float(envs.e_density)
    n_it = len(gg.steps)
    s_it = gg.seconds_per_step()
    if s_it is None:
        raise RuntimeError("GradientGrassmann took fewer than 2 CG steps")
    log(f"[haldane] spin-1 Heisenberg D={D} float64: VUMPS {len(iters)} "
        f"iterations, eps {eps_v:.3e}, e={e_v:.15f}, {t_v:.1f} s; "
        f"GradientGrassmann {n_it} iterations, {gg.evaluations} "
        f"energy-and-gradient evaluations (the set-up one and the line "
        f"searches'), gradient norm {gg.gnorm0:.3e} -> {gnorm:.3e}, "
        f"e={e_g:.15f} (de {e_g - e_v:.3e}), {t_all - t_v:.1f} s in all, "
        f"{s_it:.4f} s/iteration over iterations 2-{n_it}")
    log(json.dumps({"metric": f"grassmann_iteration_time_s1_D{D}_float64",
                    "value": s_it, "unit": "s", "iterations": n_it,
                    "evaluations": gg.evaluations}))

    # the QP solve at p = pi, its matvecs, restarts, Arnoldi steps, syncs
    counts = {"matvecs": 0, "arnoldi": 0, "restarts": 0}

    def matvec_counted(*args, **kwargs):
        counts["matvecs"] += 1
        return mv(*args, **kwargs)

    def cycle_counted(*args, **kwargs):
        out = cycle(*args, **kwargs)
        counts["arnoldi"] += out[2]
        return out

    def eigsolve_counted(*args, **kwargs):
        res = eigsolve(*args, **kwargs)
        counts["restarts"] += res.iterations
        return res

    mv, cycle = texc._qp_matvec_infinite, gmres._gmres_cycle_adaptive
    eigsolve = texc._qp_eigsolve
    torch.cuda.synchronize()
    c0 = sync.count
    t0 = time.perf_counter()
    with _patched(texc, _qp_matvec_infinite=matvec_counted,
                  _qp_eigsolve=eigsolve_counted), \
            _patched(gmres, _gmres_cycle_adaptive=cycle_counted):
        es, qps = excitations(H, QuasiparticleAnsatz(tol=1e-6), np.pi, psi,
                              envs=envs, num=1)
    torch.cuda.synchronize()
    t_qp = time.perf_counter() - t0
    syncs = sync.count - c0
    gap = float(es[0, 0]) / 4
    n_mv = max(counts["matvecs"], 1)
    log(f"[haldane] QP solve at p=pi: {t_qp:.2f} s, {counts['matvecs']} "
        f"matvecs in {counts['restarts']} restarts, {counts['arnoldi']} "
        f"GMRES Arnoldi steps ({counts['arnoldi'] / n_mv:.1f} per matvec), "
        f"{syncs} host syncs ({syncs / n_mv:.1f} per matvec), "
        f"{t_qp / n_mv * 1e3:.1f} ms per matvec")
    log(json.dumps({"metric": f"haldane_qp_solve_time_s1_D{D}_float64",
                    "value": t_qp, "unit": "s",
                    "matvecs": counts["matvecs"],
                    "host_syncs_per_matvec": syncs / n_mv}))

    # one QP matvec plainly and under the profiler
    qp = qps[0][0]
    Es = texc._renorm_energies_infinite(psi, H, envs)

    def one():
        return mv(qp.Xs, qp, H, envs.GLs, envs.GRs, Es, 1e-10)

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    one()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    busy, n_dev, by_name = _device_busy_ms(one)
    log(f"[haldane] one QP matvec: {plain:.1f} ms, {sync.count - c0} host "
        "syncs; under torch.profiler: " + (
            f"{n_dev} kernels and copies, busy {busy:.2f} ms, idle share "
            f"{1 - busy / plain:.1%}" if busy else
            "no device time in the trace: idle share not measured"))
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:5]:
        log(f"[haldane] device op {ms:.3f} ms in {count} calls: {name[:110]}")

    launches = k1.launches
    log(f"[haldane] gap E/4 = {gap:.10f} against {HALDANE_GAP} |d| "
        f"{abs(gap - HALDANE_GAP):.3e} (tol {HALDANE_TOL}); energy after "
        f"GradientGrassmann minus VUMPS's {e_g - e_v:.3e} (within -1e-10 "
        f"and 1e-12); K1 launches in this phase: {launches}")
    for name in ("AL", "AR", "AC", "C"):
        t = getattr(psi, name)
        if not torch.isfinite(t).all() or t.shape[1] != D:
            raise RuntimeError(f"the Haldane state's {name} is not finite or "
                               f"has the wrong width")
    if not abs(gap - HALDANE_GAP) < HALDANE_TOL:
        raise RuntimeError("the Haldane gap misses 0.41047925")
    if not -1e-10 <= e_g - e_v <= 1e-12:
        raise RuntimeError("GradientGrassmann moved the energy density "
                           "away from the converged VUMPS one")
    if launches != 0:
        raise RuntimeError("the Haldane path launched K1")
    return launches


def _boundary_gate(name, lam, ref, tol):
    """Log a boundary eigenvalue beside Onsager's and its gate; raise if it
    misses the gate."""
    lam = complex(lam)
    log(f"[boundary-f64] {name}: lambda={lam.real:.12f}{lam.imag:+.1e}j, "
        f"|lambda - Onsager| {abs(lam - ONSAGER):.3e}, |lambda - {ref}| "
        f"{abs(lam - ref):.3e} (tol {tol})")
    if not abs(lam - ref) <= tol:
        raise RuntimeError(f"{name}: the boundary eigenvalue misses {ref}")


def phase_boundary_f64():
    """Phase 15: the boundary algorithms in complex128 at the JAX tests'
    configurations (tests/test_statmech.py, test_multiline.py,
    test_statmech_qp.py, test_finite_statmech.py), each against the
    reference's oracle, and one iteration on the card against the CPU."""
    import torch
    from mpskit_tpu_torch import (
        VOMPS, FiniteMPS, FitDMRG, GradientGrassmann, InfiniteMPS,
        MPOMultiline, MPSMultiline, QuasiparticleAnsatz, VUMPS_Boundary,
        approximate, classical_ising, excitations, expectation_value,
        finite_classical_ising, leading_boundary, sixvertex,
    )
    from mpskit_tpu_torch.interop import mpo_from_numpy
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.operators.apply import apply_densempo_finite

    gen = torch.Generator(device="cuda").manual_seed(16)
    O, ref, tol = classical_ising(), BOUNDARY_ORACLE, BOUNDARY_ORACLE_TOL
    launches = k1.launches

    def rand(L, D):
        return InfiniteMPS.random(L, 2, D, torch.complex128, "cuda", gen)

    t0 = time.perf_counter()
    psi, envs, eps = leading_boundary(rand(1, 13), O,
                                      VUMPS_Boundary(tol=1e-9, maxiter=40))
    _boundary_gate(f"VUMPS_Boundary D=13 tol 1e-9, 40 iterations (eps "
                   f"{eps:.1e}, "
                   f"{time.perf_counter() - t0:.1f} s)",
                   expectation_value(psi, O, envs=envs), ref, tol)

    t0 = time.perf_counter()
    psi, envs, eps = leading_boundary(rand(1, 8), O,
                                      VOMPS(tol=1e-7, maxiter=350))
    _boundary_gate(f"VOMPS D=8 tol 1e-7 (eps {eps:.1e}, "
                   f"{time.perf_counter() - t0:.1f} s)",
                   expectation_value(psi, O, envs=envs), ref, 2e-3)

    t0 = time.perf_counter()
    psi, envs, _ = leading_boundary(rand(1, 10), O,
                                    VOMPS(tol=1e-3, maxiter=60))
    lam0 = complex(expectation_value(psi, O, envs=envs))
    psi, envs, gnorm = leading_boundary(
        psi, O, GradientGrassmann(tol=1e-7, maxiter=40))
    lam = complex(expectation_value(psi, O, envs=envs))
    _boundary_gate(f"GradientGrassmann D=10 after VOMPS(tol=1e-3) "
                   f"(lambda {lam0.real:.10f} -> {lam.real:.10f}, gradient "
                   f"norm {gnorm:.2e}, {time.perf_counter() - t0:.1f} s)",
                   lam, ref, tol)
    if not abs(lam) >= abs(lam0) - 1e-12:
        raise RuntimeError("GradientGrassmann lowered the boundary "
                           "eigenvalue")

    # an FSM MPOHamiltonian row: block diagonal, the Ising transfer on
    # level 0 and a 0.5-scaled copy on level 1
    T = O.site(0)
    w = T.shape[0]
    W = np.zeros((1, 2 * w, 2 * w, 2, 2), T.dtype)
    W[0, :w, :w], W[0, w:, w:] = T, 0.5 * T
    t0 = time.perf_counter()
    psi, _, eps = leading_boundary(rand(1, 13), mpo_from_numpy(W),
                                   VUMPS_Boundary(tol=1e-9, maxiter=40))
    _boundary_gate(f"MPOHamiltonian row D=13 (eps {eps:.1e}, "
                   f"{time.perf_counter() - t0:.1f} s)",
                   expectation_value(psi, O), ref, tol)

    t0 = time.perf_counter()
    psi, envs, eps = leading_boundary(
        MPSMultiline((rand(1, 8), rand(1, 8))), MPOMultiline.from_mpo(O, 2),
        VUMPS_Boundary(tol=1e-6, maxiter=60, krylovdim=20))
    lam_prod = envs[0].lambda_cell * envs[1].lambda_cell
    _boundary_gate(f"two-row MPOMultiline D=8, |lambda_0 lambda_1|^(1/2) "
                   f"(eps {eps:.1e}, {time.perf_counter() - t0:.1f} s)",
                   abs(lam_prod) ** 0.5, ref, 5e-3)

    # the six-vertex dispersion (reference test/algorithms.jl:212-219)
    O6 = sixvertex()
    t0 = time.perf_counter()
    psi, envs, eps = leading_boundary(rand(2, 10), O6,
                                      VUMPS_Boundary(tol=1e-8, maxiter=200))
    lams, _ = excitations(O6, QuasiparticleAnsatz(), [0.0, np.pi / 2], psi,
                          envs=envs, tol=1e-5)
    l0, l1 = complex(lams[0]), complex(lams[1])
    log(f"[boundary-f64] sixvertex two-site cell D=10 (eps {eps:.1e}): "
        f"|lambda_qp(0)| {abs(l0):.10f} > |lambda_qp(pi/2)| {abs(l1):.10f}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(abs(l0)) and np.isfinite(abs(l1))
            and abs(l0) > abs(l1)):
        raise RuntimeError("the six-vertex dispersion is not finite or not "
                           "largest at p = 0")

    # approximate: a finite Ising row applied to a random state
    N, D = 6, 12
    Orow = finite_classical_ising(N)
    phi = FiniteMPS.random(N, 2, D, torch.complex128, "cuda", gen)
    target = apply_densempo_finite(Orow, phi, Dmax=D)
    psi, _, eps = approximate(FiniteMPS.random(N, 2, D, torch.complex128,
                                               "cuda", gen),
                              (Orow, phi), FitDMRG(tol=1e-10, maxiter=40))
    fid = abs(complex(psi.dot(target))) / (
        abs(complex(psi.dot(psi))) * abs(complex(target.dot(target)))) ** 0.5
    log(f"[boundary-f64] approximate(FitDMRG) finite_classical_ising({N}) "
        f"D={D}: fidelity 1 - {1 - fid:.3e} (tol 1e-6), eps {eps:.1e}")
    if not 1 - fid <= 1e-6:
        raise RuntimeError("approximate(FitDMRG) misses the applied MPO")

    # one leading_boundary iteration at D=16 on the card and on the CPU
    psi = rand(1, 16)
    out = {}
    for dev in ("cuda", "cpu"):
        p = InfiniteMPS(*(x.to(dev) for x in (psi.AL, psi.AR, psi.AC,
                                              psi.C)))
        out[dev] = leading_boundary(p, O, VUMPS_Boundary(maxiter=1,
                                                         verbosity=0))
    (pc, ec, epsc), (ph, eh, epsh) = out["cuda"], out["cpu"]
    sv = [torch.linalg.svdvals(p.C[0]).cpu() for p in (pc, ph)]
    diffs = (abs(epsc - epsh), abs(ec.lambda_cell - eh.lambda_cell),
             float((sv[0] - sv[1]).abs().max()))
    log(f"[boundary-f64] one iteration D=16, card against CPU: |d eps| "
        f"{diffs[0]:.1e}, |d lambda| {diffs[1]:.1e}, Schmidt values "
        f"{diffs[2]:.1e} (tol {BOUNDARY_CARD_TOL}); device "
        f"{pc.C.device.type}")
    if not (max(diffs) <= BOUNDARY_CARD_TOL and pc.C.device.type == "cuda"):
        raise RuntimeError("the boundary iteration on the card differs from "
                           "the CPU's")
    if k1.launches != launches:
        raise RuntimeError("the float64 boundary path launched K1")


def _boundary_split(psi, Os, guesses, inner_tol, marks):
    """One boundary VUMPS iteration as `_boundary_vumps_iteration` runs it,
    with a synchronization and a mark (time, host syncs) after each
    part."""
    import torch
    from mpskit_tpu_torch import InfiniteMPS
    from mpskit_tpu_torch.algorithms import statmech as tsm
    from mpskit_tpu_torch.utils import sync

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(), sync.count))

    mark("start")
    envs = tsm.mpo_environments(psi, Os, tol=1e-12, krylovdim=30,
                                GL0=guesses[0], GR0=guesses[1])
    mark("environments (two Arnoldi fixed points)")
    ACs, _, _ = tsm._solve_acs(envs, Os, psi.AC, 30, inner_tol)
    mark("AC solve")
    Cs, _, _ = tsm._solve_cs(envs, psi.C, 30, inner_tol)
    mark("C solve")
    ALs, eps = tsm._boundary_regauge(ACs, Cs)
    mark("other (regauge, eps)")
    InfiniteMPS.from_AL(ALs, psi.C[-1], tol=1e-13)
    mark("from_AL gauge fix")


def phase_boundary():
    """Phase 16: the boundary slice at full width: leading_boundary of the
    critical classical Ising MPO at D=256 in complex128 with
    VUMPS_Boundary."""
    import torch
    from mpskit_tpu_torch import (
        InfiniteMPS, VUMPS_Boundary, classical_ising, expectation_value,
        leading_boundary,
    )
    from mpskit_tpu_torch.algorithms import statmech as tsm
    from mpskit_tpu_torch.environments.infinite_mpo import stack_O
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync
    from mpskit_tpu_torch.utils.dynamictols import updatetol

    D, O = BOUNDARY_D, classical_ising()
    gen = torch.Generator(device="cuda").manual_seed(17)
    psi = InfiniteMPS.random(1, 2, D, torch.complex128, "cuda", gen)

    # every iteration observed: its end time, host syncs, eps (read after
    # the run), the eigenvalue of the state it starts from (its
    # environment solve's, a host number) and its arguments
    rec, lams = [], []
    iteration, environments = tsm._boundary_vumps_iteration, \
        tsm.mpo_environments

    def iteration_recorded(*args, **kwargs):
        out = iteration(*args, **kwargs)
        torch.cuda.synchronize()
        rec.append((time.perf_counter(), sync.count, out[1], args, kwargs))
        return out

    def environments_recorded(*args, **kwargs):
        envs = environments(*args, **kwargs)
        lams.append(envs.lambda_cell)
        return envs

    k1.launches = 0
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    with _patched(tsm, _boundary_vumps_iteration=iteration_recorded,
                  mpo_environments=environments_recorded):
        psi, envs, eps = leading_boundary(
            psi, O, VUMPS_Boundary(tol=1e-9, maxiter=BOUNDARY_ITERS))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = k1.launches
    n = len(rec)
    ends = [t0] + [r[0] for r in rec]
    syncs = [c0] + [r[1] for r in rec]
    eps_it = sync.to_host(*[r[2] for r in rec])
    lam = complex(expectation_value(psi, O, envs=envs))
    for i in range(4, n, 5):
        # the eigenvalue of iteration i's output is the next one's first
        lam_i = complex(lams[i + 1]) if i + 1 < n else lam
        log(f"[boundary] iteration {i + 1}: eps {eps_it[i]:.3e}, lambda "
            f"{lam_i.real:.15f} (rel err {abs(lam_i - ONSAGER) / ONSAGER:.3e}"
            f"), {ends[i + 1] - ends[i]:.3f} s, {syncs[i + 1] - syncs[i]} "
            "host syncs")
    s_it = (ends[n] - ends[1]) / (n - 1)
    syncs_it = (syncs[n] - syncs[1]) / (n - 1)
    log(f"[boundary] critical Ising D={D} complex128: {n} iterations, "
        f"{t_all:.1f} s in leading_boundary (the final environments and the "
        f"uniqueness check included), {s_it:.4f} s/iteration and "
        f"{syncs_it:.1f} host syncs/iteration over iterations 2-{n}")
    log(json.dumps({
        "metric": f"boundary_vumps_iteration_time_ising_D{D}_complex128",
        "value": s_it, "unit": "s", "iterations": n,
        "host_syncs_per_iter": syncs_it}))

    # outside the timed run: the last iteration again, split by
    # synchronizations, plainly and under the profiler
    args, kwargs = rec[-1][3], rec[-1][4]
    Os = stack_O(O, 1, psi.dtype, psi.device)
    inner_tol = updatetol(eps_it[-2] if n > 1 else 1.0, n)
    marks = []
    _boundary_split(args[0], Os, (kwargs.get("GL_guess"),
                                  kwargs.get("GR_guess")), inner_tol, marks)
    total = marks[-1][1] - marks[0][1]
    log(f"[boundary] iteration {n} again, split ({total * 1e3:.1f} ms, "
        f"{marks[-1][2] - marks[0][2]} host syncs): " + "; ".join(
            f"{marks[i][0]} {(marks[i][1] - marks[i - 1][1]) * 1e3:.1f} ms "
            f"({(marks[i][1] - marks[i - 1][1]) / total:.1%}, "
            f"{marks[i][2] - marks[i - 1][2]} syncs)"
            for i in range(1, len(marks))))

    def one():
        return iteration(*args, **kwargs)

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t1) * 1e3
    busy, n_dev, by_name = _device_busy_ms(one)
    log(f"[boundary] iteration {n} again: {plain:.1f} ms; under "
        "torch.profiler: " + (
            f"{n_dev} kernels and copies, busy {busy:.1f} ms, idle share "
            f"{1 - busy / plain:.1%}" if busy else
            "no device time in the trace: idle share not measured"))
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        log(f"[boundary] device op {ms:.3f} ms in {count} calls: "
            f"{name[:110]}")

    rel = abs(lam - ONSAGER) / ONSAGER
    falling = n >= 5 and eps_it[-1] < eps_it[4]
    log(f"[boundary] lambda {lam.real:.15f}{lam.imag:+.1e}j, Onsager "
        f"{ONSAGER:.15f}, rel err {rel:.3e} (tol {BOUNDARY_REL_TOL}); "
        f"|lambda - {BOUNDARY_ORACLE}| {abs(lam - BOUNDARY_ORACLE):.3e} (tol "
        f"{BOUNDARY_ORACLE_TOL}); eps {eps_it[4] if n >= 5 else None} at "
        f"iteration 5 -> {eps_it[-1]:.3e} at {n}; K1 launches in this "
        f"phase: {launches}")
    for name in ("AL", "AR", "AC", "C"):
        t = getattr(psi, name)
        if not torch.isfinite(t).all() or t.shape[1] != D:
            raise RuntimeError(f"the boundary state's {name} is not finite or "
                               "has the wrong width")
    if not rel <= BOUNDARY_REL_TOL:
        raise RuntimeError("the D=256 boundary eigenvalue misses Onsager's")
    if not abs(lam - BOUNDARY_ORACLE) <= BOUNDARY_ORACLE_TOL:
        raise RuntimeError("the D=256 boundary eigenvalue misses 2.5337")
    if not falling:
        raise RuntimeError("boundary VUMPS eps did not fall")
    if launches != 0:
        raise RuntimeError("the boundary path launched K1")
    return launches

def _k1_shape_times(D, d, w, gen):
    """K1 at (w, d, D) against its plain version: the max abs error, the
    time per call eager (CUDA events, 50 calls, in turns with the plain
    version) and in a CUDA graph, and the bound."""
    import torch
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.kernels.ac_apply import (
        ac_apply_bf16, ac_apply_bf16_reference,
    )

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    with matmul_precision():
        GL, GR = randn(w, D, D) / D, randn(w, D, D) / D
        W, x = randn(w, w, d, d), randn(D, d, D)
        y = ac_apply_bf16(GL, W, GR, x)
        y_plain = ac_apply_bf16_reference(GL, W, GR, x)
        torch.cuda.synchronize()
        rel = float((y - y_plain).norm() / y_plain.norm())
        if not (torch.isfinite(y).all() and rel <= K1_TOL_PLAIN):
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"w={w} d={d} D={D}")
        fns = {"ms": lambda: ac_apply_bf16(GL, W, GR, x),
               "plain_ms": lambda: ac_apply_bf16_reference(GL, W, GR, x)}
        runs = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(cuda_time_ms(fns[k], 50))
        t = {k: sum(v) / len(v) for k, v in runs.items()}
        t["graph_ms"] = graph_time_ms(fns["ms"], 50)
    t["max_abs_err"] = float((y - y_plain).abs().max())
    t["bound_ms"], t["bound_by"] = k1_bound(D, d, w)
    return t


def _measured(rows, leg, name, fn, *args, **kwargs):
    """fn(*args, **kwargs) with its seconds and host syncs, recorded in
    rows and printed."""
    import torch
    from mpskit_tpu_torch.utils import sync

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    dt, syncs = time.perf_counter() - t0, sync.count - c0
    rows.append((leg, name, dt, syncs))
    log(f"[measure] {leg}: {name} {dt:.3f} s, {syncs} host syncs")
    return out


def _free_fermion_exact(L: int):
    """The exact ground state of -sum (c^dag c + h.c.) on L open sites:
    the correlation matrix C_ij = <c_i^dag c_j> of the filled modes and
    the entanglement entropy at every bond x = 1..L-1 from the
    eigenvalues nu of C restricted to [0, x)."""
    h = -(np.eye(L, k=1) + np.eye(L, k=-1))
    e, v = np.linalg.eigh(h)
    occ = v[:, e < 0]
    C = occ @ occ.T
    S = []
    for x in range(1, L):
        nu = np.clip(np.linalg.eigvalsh(C[:x, :x]), 1e-300, 1 - 1e-16)
        S.append(float(-np.sum(nu * np.log(nu) + (1 - nu) * np.log1p(-nu))))
    return C, np.array(S), (-1) ** occ.shape[1]


def _measure_free_fermions(rows):
    """Leg (a): the free-fermion chain L=32 at D=512, float32 DMRG (K1 on
    its first restarts), a float64 continuation, and the measurements
    against the exact free-fermion state."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, DenseMPO, FiniteMPS, correlator, entropy_profile,
        expectation_value, find_groundstate, free_fermions,
        kitaev_bdg_energy, string_correlator, variance,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1

    L, D = FF_L, FF_D
    H = free_fermions(t=1.0, mu=0.0)
    e_exact = kitaev_bdg_energy(L, 1.0, 0.0, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    psi = FiniteMPS.random(L, 2, D, torch.float32, "cuda", gen)
    k1.launches = 0
    psi, envs, eps32 = _measured(
        rows, "a", f"float32 DMRG ({FF_SWEEPS32} sweeps)", find_groundstate,
        psi, H, DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
                     maxiter=FF_SWEEPS32, verbosity=0))
    torch.cuda.synchronize()
    launches = k1.launches
    E32 = float(expectation_value(psi, H, envs=envs))
    rel32 = abs(E32 - e_exact) / abs(e_exact)
    log(f"[measure] a: free fermions L={L} w={H.odim} D={D} float32: "
        f"E={E32:.8f}, exact {e_exact:.12f}, rel err {rel32:.3e} (tol "
        f"{E_TOL_F32}), eps {eps32:.2e}, K1 launches {launches}")
    if not rel32 <= E_TOL_F32:
        raise RuntimeError("float32 free-fermion energy misses the exact one")
    if launches <= 0:
        raise RuntimeError("leg (a) never launched K1")

    psi = FiniteMPS(psi.ALs.double(), psi.ARs.double(), psi.AC.double(),
                    psi.center)
    k1.launches = 0
    psi, envs, eps64 = _measured(
        rows, "a", "float64 DMRG continuation", find_groundstate, psi, H,
        DMRG(tol=FF_TOL64, maxiter=FF_SWEEPS64, verbosity=0))
    E64 = float(expectation_value(psi, H, envs=envs))
    log(f"[measure] a: float64 continuation E={E64:.15f}, |dE| "
        f"{abs(E64 - e_exact):.3e} (tol {FF_E_TOL64}), eps {eps64:.2e}")
    if not abs(E64 - e_exact) <= FF_E_TOL64:
        raise RuntimeError("float64 free-fermion energy misses the exact one")

    C, S_exact, parity_exact = _free_fermion_exact(L)
    c = np.array([[0.0, 1.0], [0.0, 0.0]])
    cdag, n, Z = c.T, c.T @ c, np.diag([1.0, -1.0])
    i, js = FF_I, list(range(FF_I + 1, FF_JMAX))
    S = _measured(rows, "a", "entropy_profile", entropy_profile, psi)
    sc = _measured(rows, "a", "string_correlator <c_i^dag c_j>",
                   string_correlator, psi, cdag @ Z, Z, c, i, js)
    nn = _measured(rows, "a", "correlator <n_i n_j>", correlator, psi, n,
                   n, i, js)
    k = L // 2 - 1
    hop = np.einsum("st,uv->sutv", cdag @ Z, c) + \
        np.einsum("st,uv->sutv", Z @ c, cdag)
    bond = _measured(rows, "a", "two-site string <c^dag c + h.c.>",
                     expectation_value, psi, (k, hop))
    parity = _measured(rows, "a", "parity (finite DenseMPO)",
                       expectation_value, psi,
                       DenseMPO.from_array(Z[None, None], period=L))
    var = _measured(rows, "a", "variance (H @ H)", variance, psi, H)
    S, sc, nn = (t.cpu().numpy() for t in (S, sc, nn))
    errs = {
        "entropy_profile": (np.abs(S - S_exact).max(), FF_TOL_ENTROPY),
        "string_correlator": (np.abs(sc - C[i, js]).max(), FF_TOL_CORR),
        "correlator": (np.abs(nn - (C[i, i] * np.diag(C)[js]
                                    - C[i, js] ** 2)).max(), FF_TOL_CORR),
        "two-site string": (abs(complex(bond) - 2 * C[k, k + 1]),
                            FF_TOL_CORR),
        "parity": (abs(complex(parity) - parity_exact), FF_TOL_CORR),
        "variance": (abs(float(var)), FF_TOL_VAR),
    }
    log(f"[measure] a: S at the middle bond {S[L // 2 - 1]:.12f} (exact "
        f"{S_exact[L // 2 - 1]:.12f}); <c_{i}^dag c_{i + 1}> "
        f"{sc[0].real:.12f} (exact {C[i, i + 1]:.12f}); parity "
        f"{complex(parity).real:.12f}; variance {float(var):.3e}")
    for name, (err, tol) in errs.items():
        log(f"[measure] a: {name} max error {err:.3e} (tol {tol})")
        if not err <= tol:
            raise RuntimeError(f"leg (a): {name} misses the exact value")
    return launches


def _hubbard_block(psi, H, n_tot, rows, leg, env_init=None):
    """Leg (b)'s measurements of one state, each recorded in rows."""
    from mpskit_tpu_torch import (
        calc_galerkin, correlation_length, correlator, expectation_value,
        marek_gap, transfer_spectrum, variance,
    )
    from mpskit_tpu_torch.environments.infinite_ham import (
        hamiltonian_environments,
    )

    def m(name, fn, *args, **kwargs):
        return _measured(rows, leg, name, fn, *args, **kwargs)

    n, k = HUB_RANGE_N, HUB_KRYLOVDIM
    out = {"spectrum": m("transfer_spectrum", transfer_spectrum, psi, num=5,
                         krylovdim=k),
           "marek_gap": m("marek_gap", marek_gap, psi, krylovdim=k),
           "correlation_length": m("correlation_length", correlation_length,
                                   psi, krylovdim=k)}
    envs = m("environments", hamiltonian_environments, psi, H,
             env_init=env_init)
    out["envs"] = envs
    out["energy"] = m("expectation_value", expectation_value, psi, H,
                      envs=envs)
    out["variance"] = m("variance", variance, psi, H, envs=envs)
    out["galerkin"] = m("calc_galerkin", calc_galerkin, psi, H, envs=envs)
    out["E_n"] = m(f"ranged energy range(0, {n})", expectation_value, psi,
                   H, range(0, n), envs=envs)
    out["E_2n"] = m(f"ranged energy range(0, {2 * n})", expectation_value,
                    psi, H, range(0, 2 * n), envs=envs)
    out["density"] = m("density <n> per site", lambda: [
        expectation_value(psi, (i, n_tot)) for i in range(psi.period)])
    out["nn"] = m(f"correlator <n_0 n_{HUB_CORR_J}>", correlator, psi, n_tot,
                  n_tot, 0, [HUB_CORR_J])
    return out


def _hubbard_numbers(out):
    """The block's results as host numbers."""
    e = out["energy"].cpu().numpy()
    eps, delta = out["marek_gap"]
    return {"|spectrum|": np.abs(out["spectrum"].cpu().numpy()),
            "marek_gap": np.array([eps, delta]),
            "correlation_length": np.array([out["correlation_length"]]),
            "energy": e, "variance": np.array([float(out["variance"])]),
            "galerkin": np.array([float(out["galerkin"])]),
            "E_n": np.array([complex(out["E_n"]).real]),
            "E_2n": np.array([complex(out["E_2n"]).real]),
            "density": np.array([complex(x).real for x in out["density"]]),
            "nn": out["nn"].cpu().numpy().real}


def _measure_hubbard(rows):
    """Leg (b): the half-filled Hubbard chain U=4 on a two-site cell at
    D=256 in float64: VUMPS from a seeded random state for a fixed number
    of iterations (its eps stalls near 1e-4 at this width: the spin sector
    is critical), then the measurements on the card, under
    torch.profiler, and on the CPU from the same state."""
    import torch
    from mpskit_tpu_torch import VUMPS, InfiniteMPS, find_groundstate, hubbard
    from mpskit_tpu_torch.environments.infinite_ham import InfiniteHamEnv
    from mpskit_tpu_torch.models.fermions import _spinful_ops

    D = HUB_D
    H = hubbard(t=1.0, U=HUB_U, mu=HUB_U / 2, period=2)
    _, _, n_up, n_dn, _ = _spinful_ops()
    n_tot = n_up + n_dn
    gen = torch.Generator(device="cuda").manual_seed(29)
    psi = InfiniteMPS.random(2, 4, D, torch.float64, "cuda", gen)
    ends = []

    def mark(it, psi, H):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    torch.cuda.synchronize()
    ends.append(time.perf_counter())
    psi, envs, eps = _measured(
        rows, "b", f"VUMPS D={D} (at most {HUB_VUMPS_ITERS} iterations)",
        find_groundstate, psi, H,
        VUMPS(tol=1e-8, maxiter=HUB_VUMPS_ITERS, finalize=mark, verbosity=0))
    n_it = len(ends) - 1
    s_it = (ends[-1] - ends[1]) / (n_it - 1)
    log(f"[measure] b: VUMPS D={D}: {n_it} iterations, eps {eps:.3e}, "
        f"{s_it:.4f} s/iteration over iterations 2-{n_it}")
    log(json.dumps({
        "metric": f"vumps_iteration_time_hubbard_U4_D{D}_float64",
        "value": s_it, "unit": "s", "iterations": n_it, "eps": eps}))

    card = _hubbard_block(psi, H, n_tot, rows, "b card", env_init=envs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _hubbard_block(psi, H, n_tot, [], "b again", env_init=envs)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    busy, n_dev, _ = _device_busy_ms(
        lambda: _hubbard_block(psi, H, n_tot, [], "b profiled",
                               env_init=envs))
    log(f"[measure] b: the measurement block again {plain:.1f} ms; under "
        "torch.profiler: " + (
            f"{n_dev} kernels and copies, busy {busy:.1f} ms, idle share "
            f"{1 - busy / plain:.1%}" if busy else
            "no device time in the trace: idle share not measured"))

    psi_cpu = InfiniteMPS(*(t.cpu() for t in (psi.AL, psi.AR, psi.AC,
                                              psi.C)))
    env_cpu = InfiniteHamEnv(card["envs"].GLs.cpu(), card["envs"].GRs.cpu(),
                             card["envs"].e_density.cpu())
    cpu = _hubbard_block(psi_cpu, H, n_tot, rows, "b CPU", env_init=env_cpu)
    a, b = _hubbard_numbers(card), _hubbard_numbers(cpu)

    e = float(np.mean(a["energy"]))
    lam = a["|spectrum|"]
    n = HUB_RANGE_N
    ranged = a["E_2n"][0] - a["E_n"][0]
    dens = a["density"]
    eps_m, delta_m = a["marek_gap"]
    log(f"[measure] b: Hubbard U={HUB_U} D={psi.D} float64: e per site "
        f"{e:.12f} (sites {a['energy'][0]:.12f}, {a['energy'][1]:.12f}), "
        f"Lieb-Wu {HUB_E_LIEB_WU:.12f}, |de| {abs(e - HUB_E_LIEB_WU):.3e} "
        f"(tol {HUB_E_TOL}); <n> {dens[0]:.14f}, {dens[1]:.14f}")
    log(f"[measure] b: |transfer spectrum| {', '.join(f'{x:.12f}' for x in lam)}"
        f"; marek gap eps {eps_m:.6e} delta {delta_m:.3e}; correlation "
        f"length {a['correlation_length'][0]:.4f} sites; variance "
        f"{a['variance'][0]:.3e}; Galerkin {a['galerkin'][0]:.3e}")
    log(f"[measure] b: E(range(0, {2 * n})) - E(range(0, {n})) "
        f"{ranged:.12f}, {n} e {n * e:.12f}, diff {abs(ranged - n * e):.3e}"
        f" (tol {HUB_RANGE_TOL}); <n_0 n_{HUB_CORR_J}> {a['nn'][0]:.14f}, "
        f"<n_0>^2 {dens[0] ** 2:.14f}")
    worst = 0.0
    for key in a:
        scale = max(np.abs(a[key]).max(), np.abs(b[key]).max(), 1e-300)
        rel = float(np.abs(a[key] - b[key]).max() / scale)
        worst = max(worst, rel)
        log(f"[measure] b: card against CPU, {key}: rel diff {rel:.3e} "
            f"(tol {HUB_CARD_TOL})")
    gates = [
        (abs(e - HUB_E_LIEB_WU) <= HUB_E_TOL, "the energy misses Lieb-Wu"),
        (np.abs(dens - 1).max() <= HUB_DENSITY_TOL, "the density is not 1"),
        (abs(lam[0] - 1) <= 1e-10 and lam[1] < 1,
         "the transfer spectrum is not normalized"),
        (a["variance"][0] < HUB_VAR_TOL, "the variance is too large"),
        (abs(ranged - n * e) <= HUB_RANGE_TOL, "the ranged energy is off"),
        (abs(a["nn"][0] - dens[0] ** 2) <= HUB_NN_TOL,
         "<n_0 n_j> misses <n>^2"),
        (worst <= HUB_CARD_TOL, "card and CPU disagree"),
    ]
    for ok, why in gates:
        if not ok:
            raise RuntimeError(f"leg (b): {why}")


def _measure_ed_and_fidelity(rows):
    """Leg (c): exact diagonalization of the open TFIM L=20 in complex128
    at D=1024, then the fidelity susceptibility of the infinite TFIM
    g=1.5 at D=48, on the card and on the CPU."""
    import torch
    from mpskit_tpu_torch import (
        VUMPS, InfiniteMPS, MPOHamiltonian, exact_diagonalization,
        fidelity_susceptibility, find_groundstate,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms import toolbox

    L, g = ED_L, ED_G
    H = transverse_field_ising_lattice(g=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energies, states = _measured(rows, "c", f"exact_diagonalization L={L}",
                                 exact_diagonalization, H, L, num=2,
                                 device="cuda")
    dt = time.perf_counter() - t0
    E0, E1 = energies.cpu().tolist()
    e0 = tfim_open_chain_e0(L, g)
    sigma = np.linalg.svd(g * np.eye(L) + np.eye(L, k=1), compute_uv=False)
    e1 = e0 + 2 * sigma.min()
    log(json.dumps({"metric": f"exact_diagonalization_time_tfim_L{L}"
                              "_complex128", "value": dt, "unit": "s",
                    "D": states[0].D}))
    log(f"[measure] c: ED TFIM g={g} L={L} D={states[0].D} complex128: "
        f"E0 {E0:.12f} (exact {e0:.12f}, |dE| {abs(E0 - e0):.3e}, tol "
        f"{ED_TOL_E0}), E1 {E1:.12f} (exact {e1:.12f}, |dE| "
        f"{abs(E1 - e1):.3e}, tol {ED_TOL_E1})")
    if not (abs(E0 - e0) <= ED_TOL_E0 and abs(E1 - e1) <= ED_TOL_E1):
        raise RuntimeError("leg (c): ED misses the free-fermion energies")

    gen = torch.Generator(device="cuda").manual_seed(31)
    psi = InfiniteMPS.random(1, 2, FS_D, torch.float64, "cuda", gen)
    psi, envs, eps = _measured(rows, "c", f"VUMPS TFIM D={FS_D}",
                               find_groundstate, psi, H,
                               VUMPS(tol=1e-10, maxiter=200, verbosity=0))
    V = MPOHamiltonian.from_local(-np.array([[0.0, 1.0], [1.0, 0.0]]))
    calls = [0]
    matvec = toolbox._qp_matvec_infinite

    def counted(*args, **kwargs):
        calls[0] += 1
        return matvec(*args, **kwargs)

    out = {}
    for where, p in (("card", psi), ("CPU", InfiniteMPS(*(
            t.cpu() for t in (psi.AL, psi.AR, psi.AC, psi.C))))):
        calls[0] = 0
        with _patched(toolbox, _qp_matvec_infinite=counted):
            G = _measured(rows, "c", f"fidelity_susceptibility ({where})",
                          fidelity_susceptibility, p, H, [V], tol=FS_TOL)
        out[where] = G.cpu().numpy()
        # one matvec for the initial residual, one per CG step
        log(f"[measure] c: fidelity susceptibility ({where}) "
            f"{out[where][0, 0].real:.15f}, {calls[0] - 1} CG steps")
    G, Gc = out["card"], out["CPU"]
    rel = float(np.abs(G - Gc).max() / np.abs(Gc).max())
    herm = float(np.abs(G - G.conj().T).max())
    # the per-site fidelity susceptibility of the infinite TFIM for g > 1
    chi = 1 / (16 * g * g * (g * g - 1))
    rel_chi = abs(G[0, 0] - chi) / chi
    log(f"[measure] c: D={FS_D} eps {eps:.2e}: Hermitian to {herm:.1e}, "
        f"smallest eigenvalue {np.linalg.eigvalsh(G).min():.6e}, card "
        f"against CPU rel diff {rel:.3e} (tol {FS_CARD_TOL}); exact "
        f"1/(16 g^2 (g^2 - 1)) = {chi:.15f}, rel err {rel_chi:.3e} (tol "
        f"{FS_EXACT_TOL})")
    if not (herm <= 1e-12 * np.abs(G).max()
            and np.linalg.eigvalsh(G).min() > 0):
        raise RuntimeError("leg (c): the fidelity susceptibility is not "
                           "Hermitian positive")
    if not rel <= FS_CARD_TOL:
        raise RuntimeError("leg (c): card and CPU fidelity disagree")
    if not rel_chi <= FS_EXACT_TOL:
        raise RuntimeError("leg (c): the fidelity susceptibility misses the "
                           "exact one")


def _window_local(psi, ops):
    """Real parts of <op> at every site (one-site op) or bond (two-site op)
    of a window, as numpy arrays."""
    from mpskit_tpu_torch import expectation_value

    out = []
    for op in ops:
        k = 1 if op.ndim == 2 else 2
        out.append(np.array([complex(expectation_value(psi, (i, op))).real
                             for i in range(psi.length - k + 1)]))
    return out


def _window_dmrg():
    """Leg (a): VUMPS of the infinite TFIM g=1.5 at D=256 in float32, then
    window DMRG of L=32 at D=256 in float32 from a seeded random window
    (full-rank random tensors, far from the answer), through find_groundstate,
    with K1 on the first restarts."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, VUMPS, FiniteMPS, InfiniteMPS, WindowMPS, expectation_value,
        find_groundstate, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    L, D, d = WIN_L, WIN_D, 2
    H = transverse_field_ising_lattice(g=WIN_G)
    gen = torch.Generator(device="cuda").manual_seed(41)
    t0 = time.perf_counter()
    psi_inf = InfiniteMPS.random(1, d, D, torch.float32, "cuda", gen)
    psi_inf, _, eps_inf = find_groundstate(psi_inf, H, VUMPS(
        tol=1e-8, krylovdim=10, eig_maxrestarts=2, gauge_tol=1e-8,
        maxiter=WIN_VUMPS_ITERS, verbosity=0))
    e_inf = float(expectation_value(psi_inf, H)[0])
    log(f"[window] a: VUMPS TFIM g={WIN_G} D={D} float32: e {e_inf:.8f} "
        f"(exact {tfim_density(WIN_G):.8f}), eps {eps_inf:.2e}, "
        f"{time.perf_counter() - t0:.1f} s")

    As = torch.randn((L, D, d, D), generator=gen, device="cuda")
    win = WindowMPS(psi_inf, FiniteMPS.from_tensors(As), psi_inf)
    marks = []

    def mark(it, psi, H):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), sync.count))

    torch.cuda.synchronize()
    k1.launches = 0
    sync.count = 0
    marks.append((time.perf_counter(), 0))
    win, _, eps = find_groundstate(win, H, DMRG(
        krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True, tol=1e-6,
        maxiter=WIN_SWEEPS, finalize=mark, verbosity=0))
    torch.cuda.synchronize()
    launches = k1.launches
    times = [marks[k][0] - marks[k - 1][0] for k in range(1, len(marks))]
    syncs = [marks[k][1] - marks[k - 1][1] for k in range(1, len(marks))]
    for k, (t, c) in enumerate(zip(times, syncs), 1):
        log(f"[window] a: sweep {k}: {t:.3f} s, {c} host syncs")
    later = times[1:] or times
    log(json.dumps({
        "metric": f"window_dmrg_sweep_time_tfim_L{L}_D{D}_float32",
        "value": sum(later) / len(later), "unit": "s", "sweeps": len(times),
        "host_syncs_per_sweep": sum(syncs[1:] or syncs) / len(later),
        "eps": eps}))
    log(f"[window] a: {len(times)} sweeps, eps {eps:.2e}, K1 launches in "
        f"this leg: {launches}")

    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    ZZ = np.einsum("st,uv->sutv", np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
    x_inf = complex(expectation_value(psi_inf, (0, X))).real
    zz_inf = complex(expectation_value(psi_inf, (0, ZZ))).real
    x, zz = _window_local(win, (X, ZZ))
    E = float(expectation_value(win, H))
    E_ref = float(expectation_value(WindowMPS.from_infinite(
        psi_inf, L, device="cuda"), H))
    grown, dev = win.grow(1, 1).shrink(1, 1)
    x_back = _window_local(grown, (X,))[0]
    errs = {"<X_i>": (np.abs(x - x_inf).max(), WIN_TOL),
            "<Z_i Z_i+1>": (np.abs(zz - zz_inf).max(), WIN_TOL),
            "energy (relative)": (abs(E - E_ref) / abs(E_ref), WIN_TOL),
            "grow/shrink deviation": (float(dev), WIN_TOL),
            "<X_i> after grow/shrink": (np.abs(x_back - x).max(), 1e-6)}
    log(f"[window] a: infinite <X> {x_inf:.8f}, <ZZ> {zz_inf:.8f}; window "
        f"energy {E:.6f}, from_infinite window {E_ref:.6f}")
    for name, (err, tol) in errs.items():
        log(f"[window] a: {name} max error {err:.3e} (tol {tol})")
        if not err <= tol:
            raise RuntimeError(f"leg (a): {name} misses its reference")
    if not (torch.isfinite(win.window.AC).all()
            and win.window.ALs.shape == (L, D, d, D)):
        raise RuntimeError("leg (a): the window is not finite or misshapen")
    if launches <= 0:
        raise RuntimeError("leg (a): window DMRG never launched K1")
    return psi_inf, win, launches


def _window_ramp(psi_inf):
    """Leg (b): the co-evolving window TDVP of H(t) = H_zz + f(t) H_x,
    f(t) = 1.5 - 0.6 t, under Window(LazySum) in complex64, against the
    infinite TDVP of the same LazySum step by step; then the frozen
    boundaries (a plain LazySum) for comparison, printed only."""
    import torch
    from mpskit_tpu_torch import (
        TDVP, InfiniteMPS, LazySum, MPOHamiltonian, TimedOperator, Window,
        WindowMPS, expectation_value, timestep,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Zm = np.diag([1.0, -1.0])
    ZZ = np.einsum("st,uv->sutv", Zm, Zm)
    Hs = LazySum([MPOHamiltonian.from_local(-ZZ),
                  TimedOperator(MPOHamiltonian.from_local(-X),
                                lambda t: 1.5 - 0.6 * t)])
    psi = InfiniteMPS(*(t.to(torch.complex64) for t in (
        psi_inf.AL, psi_inf.AR, psi_inf.AC, psi_inf.C)))
    L, c, dt = WIN_L, WIN_L // 2, RAMP_DT
    # the environment GMRES floor of complex64 at D=256 (~4e-4) is above
    # the warning threshold: quiet, the gates judge the result
    alg = TDVP(expalg_m=RAMP_M, verbosity=0)

    def centre(w):
        return [complex(expectation_value(w, (c, op))).real for op in (X, ZZ)]

    def oracle(p):
        return [complex(expectation_value(p, (0, op))).real for op in (X, ZZ)]

    win = WindowMPS.from_infinite(psi, L, device="cuda")
    frozen = win
    inf, ienvs, wenvs = psi, None, None
    times, syncs, worst, ref = [], [], 0.0, []
    k1.launches = 0
    for k in range(RAMP_STEPS):
        t = k * dt
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        win, wenvs = timestep(win, Window(Hs), t, dt, alg, envs=wenvs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(sync.count - c0)
        inf, ienvs = timestep(inf, Hs, t, dt, alg, envs=ienvs)
        got, want = centre(win), oracle(inf)
        ref.append(want)
        err = max(abs(a - b) for a, b in zip(got, want))
        norm = float(win.window.norm())
        worst = max(worst, err)
        log(f"[window] b: step {k + 1} t={t + dt:.2f}: {times[-1]:.3f} s, "
            f"{syncs[-1]} host syncs; centre <X> {got[0]:.7f} <ZZ> "
            f"{got[1]:.7f}, infinite {want[0]:.7f} {want[1]:.7f}, |diff| "
            f"{err:.2e} (tol {RAMP_TOL}), norm - 1 {norm - 1:.1e}")
        if not err <= RAMP_TOL:
            raise RuntimeError("leg (b): the window centre leaves the "
                               "infinite evolution")
        if not abs(norm - 1) <= RAMP_NORM_TOL:
            raise RuntimeError("leg (b): the window norm drifts")
    launches = k1.launches
    later = times[1:]
    log(json.dumps({
        "metric": f"window_tdvp_step_time_tfim_ramp_L{L}_D{psi.D}_complex64",
        "value": sum(later) / len(later), "unit": "s", "steps": len(times),
        "host_syncs_per_step": sum(syncs[1:]) / len(later)}))
    for k in range(FROZEN_STEPS):
        frozen, _ = timestep(frozen, Hs, k * dt, dt, alg)
    err_frozen = max(abs(a - b) for a, b in zip(centre(frozen),
                                                ref[FROZEN_STEPS - 1]))
    log(f"[window] b: over {RAMP_STEPS} steps the centre's error is "
        f"{worst:.2e} at worst with co-evolving boundaries; after "
        f"{FROZEN_STEPS} steps {err_frozen:.2e} with frozen ones (printed, "
        f"not gated); K1 launches in this leg: {launches}")
    if launches != 0:
        raise RuntimeError("leg (b): complex64 TDVP launched K1")


def _dense_vector(psi):
    p = psi.move_center(0)
    v = p.AC[:1].cpu().numpy()
    for i in range(1, psi.length):
        v = np.einsum("...m,mpr->...pr", v, p.ARs[i].cpu().numpy())
    return v[..., :1].reshape(-1)


def _ddmrg():
    """Leg (c): propagator in complex128, the ground-state pole at L=32
    D=64 and a random state at L=10 D=32 against the dense solve, on the
    card and on the CPU."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, DynamicalDMRG, FiniteMPS, Jeckelmann, NaiveInvert,
        find_groundstate, propagator, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.utils import sync

    H = transverse_field_ising_lattice(g=1.5)
    gen = torch.Generator(device="cuda").manual_seed(43)
    psi = FiniteMPS.random(DD_L, 2, DD_D, torch.float64, "cuda", gen)
    psi, _, _ = find_groundstate(psi, H, DMRG(tol=1e-12, maxiter=30,
                                              verbosity=0))
    E0 = tfim_open_chain_e0(DD_L, 1.5)
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    G, _ = propagator(psi, E0 + 0.5 + 0.3j, H, device="cuda")
    torch.cuda.synchronize()
    want = 1 / (0.5 + 0.3j)
    rel = abs(complex(G) - want) / abs(want)
    log(f"[window] c: pole L={DD_L} D={DD_D}: G {complex(G):.12f}, "
        f"1/(0.5+0.3i) {want:.12f}, rel err {rel:.3e} (tol {DD_POLE_TOL}); "
        f"{time.perf_counter() - t0:.2f} s, {sync.count - c0} host syncs")
    if not rel <= DD_POLE_TOL:
        raise RuntimeError("leg (c): the propagator misses the pole")

    Ld = DD_DENSE_L
    psi0 = FiniteMPS.random(Ld, 2, DD_DENSE_D, torch.complex128, "cuda", gen)
    v = _dense_vector(psi0)
    G_ex = np.vdot(v, np.linalg.solve(DD_Z * np.eye(2 ** Ld)
                                      - H.to_matrix(Ld), v))
    for name, alg, tol in (
            ("NaiveInvert", DynamicalDMRG(NaiveInvert(), tol=1e-9,
                                          maxiter=60), DD_NAIVE_TOL),
            ("Jeckelmann", DynamicalDMRG(Jeckelmann(), tol=1e-9, maxiter=60,
                                         linsolve_tol=1e-11), DD_JECK_TOL)):
        out = {}
        for where in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), sync.count
            out[where] = complex(propagator(psi0, DD_Z, H, alg,
                                            device=where)[0])
            torch.cuda.synchronize()
            log(f"[window] c: {name} L={Ld} D={DD_DENSE_D} on {where}: G "
                f"{out[where]:.12f} in {time.perf_counter() - t0:.2f} s, "
                f"{sync.count - c0} host syncs")
        err, card = abs(out["cuda"] - G_ex), abs(out["cuda"] - out["cpu"])
        log(f"[window] c: {name}: dense {G_ex:.12f}, |diff| {err:.3e} (tol "
            f"{tol}), card against CPU {card:.3e} (tol {DD_CARD_TOL})")
        if not (err <= tol and card <= DD_CARD_TOL):
            raise RuntimeError(f"leg (c): {name} misses its references")


def _thermal():
    """Leg (d): the thermal purification at beta=1 of the open TFIM g=1.2
    at L=32 Dmax=128 in complex128 against the free-fermion Gibbs energy,
    and at L=8 Dmax=24 on the card against the CPU."""
    import torch
    from mpskit_tpu_torch import (
        thermal_expectation, thermal_state, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.utils import sync

    H = transverse_field_ising_lattice(g=TH_G)
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    psi = thermal_state(H, TH_L, TH_BETA, TH_DBETA, TH_DMAX, device="cuda")
    e = float(thermal_expectation(psi, H))
    torch.cuda.synchronize()
    e_ex = tfim_open_chain_thermal_energy(TH_L, TH_G, TH_BETA)
    rel = abs(e - e_ex) / abs(e_ex)
    log(f"[window] d: thermal_state L={TH_L} beta={TH_BETA} dbeta="
        f"{TH_DBETA} Dmax={TH_DMAX}: E {e:.10f}, free fermions {e_ex:.10f}, "
        f"rel err {rel:.3e} (tol {TH_TOL}); {time.perf_counter() - t0:.2f} s,"
        f" {sync.count - c0} host syncs; ground energy "
        f"{tfim_open_chain_e0(TH_L, TH_G):.6f}")
    if not rel <= TH_TOL:
        raise RuntimeError("leg (d): the thermal energy misses the Gibbs one")
    es = [float(thermal_expectation(thermal_state(
        H, TH_CARD_L, TH_BETA, TH_DBETA, TH_CARD_DMAX, device=where), H))
        for where in ("cuda", "cpu")]
    diff = abs(es[0] - es[1]) / abs(es[1])
    log(f"[window] d: L={TH_CARD_L} Dmax={TH_CARD_DMAX}: card {es[0]:.14f}, "
        f"CPU {es[1]:.14f}, rel diff {diff:.3e} (tol {TH_CARD_TOL})")
    if not diff <= TH_CARD_TOL:
        raise RuntimeError("leg (d): card and CPU thermal energies differ")


def _checkpoints(psi_inf, win):
    """Leg (e): save_state / load_state of leg (a)'s window and infinite
    state through a temporary directory, bit for bit on the card."""
    import tempfile

    import torch
    from mpskit_tpu_torch import load_state, save_state
    from mpskit_tpu_torch.utils.serialize import _leaves

    with tempfile.TemporaryDirectory() as tmp:
        for name, state in (("window", win), ("infinite", psi_inf)):
            path = str(Path(tmp) / f"{name}.npz")
            save_state(path, state)
            back = load_state(path, device="cuda")
            same = all(a.is_cuda and torch.equal(a, b) for a, b in
                       zip(_leaves(back), _leaves(state)))
            log(f"[window] e: {name} checkpoint of {len(_leaves(state))} "
                f"tensors reloaded on the card bit for bit: {same}")
            if not same or type(back) is not type(state):
                raise RuntimeError(f"leg (e): the {name} checkpoint changed")


def phase_windows():
    """Phase 18: K1 at the window's shape (w=3, d=2, D=256), then legs
    (a)-(e). Returns (window K1 launches, K1's times at that shape)."""
    import torch

    t = _k1_shape_times(WIN_D, 2, 3, torch.Generator(device="cuda")
                        .manual_seed(47))
    log(f"[window] K1 D={WIN_D} d=2 w=3: {t['ms']:.4f} ms per call (plain "
        f"{t['plain_ms']:.4f} ms), {t['graph_ms']:.4f} ms in a CUDA graph, "
        f"max abs err vs plain {t['max_abs_err']:.3e}, bound "
        f"{t['bound_ms']:.5f} ms ({t['bound_by']}): "
        f"{t['bound_ms'] / t['ms']:.1%} of it per call")
    legs = {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        legs[name] = time.perf_counter() - t0
        return out

    psi_inf, win, launches = leg("a", _window_dmrg)
    leg("b", _window_ramp, psi_inf)
    leg("c", _ddmrg)
    leg("d", _thermal)
    leg("e", _checkpoints, psi_inf, win)
    log("[window] seconds per leg: " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()))
    return launches, t


def _gate(tag, name, err, tol):
    """Print a gate's value beside its tolerance; fail the run if it
    misses."""
    log(f"[{tag}] {name}: {err:.3e} (tol {tol})")
    if not err <= tol:
        raise RuntimeError(f"[{tag}] {name} misses its tolerance")


def _idle_share(tag, name, fn):
    """One more run of fn timed plainly, then under torch.profiler: its
    device busy time and idle share, printed."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    busy, n_dev, _ = _device_busy_ms(fn)
    log(f"[{tag}] {name}: {plain:.1f} ms plainly; under torch.profiler " + (
        f"{n_dev} kernels and copies, busy {busy:.1f} ms, idle share "
        f"{1 - busy / plain:.1%}" if busy else
        "no device time in the trace: idle share not measured"))


def _round_marks():
    """A finalize hook that records (time, host syncs) after every round or
    sweep, with the list it fills (one entry before the run)."""
    import torch
    from mpskit_tpu_torch.utils import sync

    torch.cuda.synchronize()
    marks = [(time.perf_counter(), sync.count)]

    def mark(it, psi, H):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), sync.count))
    return mark, marks


def _intervals(marks):
    return ([marks[k][0] - marks[k - 1][0] for k in range(1, len(marks))],
            [marks[k][1] - marks[k - 1][1] for k in range(1, len(marks))])


@contextlib.contextmanager
def _launches_in_rounds(k1):
    """Reads K1's count at the entry and exit of every RS-DMRG round
    (`rsdmrg._rs_round`: capture, segment sweeps, stitch), so that the
    launches of the serial warmup sweeps and those of the segment sweeps
    are told apart. Yields {"warmup": count before the first round,
    "rounds": launches inside the rounds}."""
    from mpskit_tpu_torch.algorithms import rsdmrg

    inner = rsdmrg._rs_round
    seen = {"warmup": None, "rounds": 0}

    def counted(*args, **kw):
        n0 = k1.launches
        if seen["warmup"] is None:
            seen["warmup"] = n0
        out = inner(*args, **kw)
        seen["rounds"] += k1.launches - n0
        return out
    rsdmrg._rs_round = counted
    try:
        yield seen
    finally:
        rsdmrg._rs_round = inner


def _rs_dmrg():
    """Leg (a): RealSpaceParallelDMRG of the TFIM at L=32 D=512 float32
    through find_groundstate, K1 launches of the warmup sweeps and of the
    segment sweeps counted apart; then the same rounds with the stitch in
    float32 (printed, the measurement behind the auto stitch_f64); then
    one round with no warmup from a fresh random state, whose segment
    sweeps' probes start far from convergence and take K1."""
    import torch
    from mpskit_tpu_torch import (
        FiniteMPS, RealSpaceParallelDMRG, expectation_value,
        find_groundstate, transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1

    H = transverse_field_ising_lattice(g=RS_G)
    e0 = tfim_open_chain_e0(RS_L, RS_G)
    out = {}
    for stitch in (None, False):
        gen = torch.Generator(device="cuda").manual_seed(53)
        psi = FiniteMPS.random(RS_L, 2, RS_D, torch.float32, "cuda", gen)
        mark, marks = _round_marks()
        k1.launches = 0
        with _launches_in_rounds(k1) as split:
            psi, envs, eps = find_groundstate(psi, H, RealSpaceParallelDMRG(
                nseg=RS_NSEG, warmup=2, krylovdim=10, eig_maxrestarts=2,
                maxiter=RS_ROUNDS, finalize=mark, verbosity=0,
                stitch_f64=stitch))
            torch.cuda.synchronize()
        launches = k1.launches
        E = float(expectation_value(psi, H, envs=envs))
        times, syncs = _intervals(marks)
        name = "float64 stitch (auto)" if stitch is None else "float32 stitch"
        for k, (t, c) in enumerate(zip(times, syncs), 1):
            log(f"[rs] a: {name} round {k}{' (with the 2 warmup sweeps)' if k == 1 else ''}: "
                f"{t:.3f} s, {c} host syncs")
        rel = abs(E - e0) / abs(e0)
        log(f"[rs] a: {name}: {len(times)} rounds, E {E:.8f}, closed form "
            f"{e0:.8f}, rel err {rel:.3e}, eps {eps:.2e}, K1 launches "
            f"{launches}: {split['warmup']} in the 2 warmup sweeps, "
            f"{split['rounds']} in the rounds' segment sweeps")
        out[stitch] = (psi, envs, E, rel, times, syncs, launches, split)
    psi, envs, E, rel, times, syncs, launches, split = out[None]
    _idle_share("rs", "a: one more round from the result", lambda: (
        find_groundstate(psi, H, RealSpaceParallelDMRG(
            nseg=RS_NSEG, warmup=0, krylovdim=10, eig_maxrestarts=2,
            maxiter=1, verbosity=0))))
    later = times[1:] or times
    log(json.dumps({
        "metric": f"rsdmrg_round_time_tfim_L{RS_L}_D{RS_D}_float32",
        "value": sum(later) / len(later), "unit": "s",
        "rounds": len(times), "host_syncs_per_round":
        sum(syncs[1:] or syncs) / len(later), "nseg": RS_NSEG}))
    if not (torch.isfinite(psi.AC).all() and psi.ARs.shape ==
            (RS_L, RS_D, 2, RS_D)):
        raise RuntimeError("leg (a): the RS-DMRG state is not finite")
    _gate("rs", "a: RS-DMRG energy, relative to the closed form", rel,
          E_TOL_F32)
    if launches <= 0:
        raise RuntimeError("leg (a): RS-DMRG never launched K1")
    if split["warmup"] + split["rounds"] != launches:
        raise RuntimeError("leg (a): the warmup and round launches do not "
                           "add up to the run's")

    # the segment sweeps from a cold start: one round, no warmup
    gen = torch.Generator(device="cuda").manual_seed(61)
    cold = FiniteMPS.random(RS_L, 2, RS_D, torch.float32, "cuda", gen)
    k1.launches = 0
    with _launches_in_rounds(k1) as cold_split:
        cold, cold_envs, _ = find_groundstate(cold, H, RealSpaceParallelDMRG(
            nseg=RS_NSEG, warmup=0, krylovdim=10, eig_maxrestarts=2,
            maxiter=1, verbosity=0))
        torch.cuda.synchronize()
    segment_launches = k1.launches
    E_cold = float(expectation_value(cold, H, envs=cold_envs))
    log(f"[rs] a: one round with no warmup from a random state: K1 "
        f"launches {segment_launches} (all in the segment sweeps: "
        f"{cold_split['rounds']}), E {E_cold:.8f} (closed form {e0:.8f})")
    if not np.isfinite(E_cold):
        raise RuntimeError("leg (a): the cold-start round's energy is not "
                           "finite")
    if segment_launches <= 0 or cold_split["rounds"] != segment_launches:
        raise RuntimeError("leg (a): RS-DMRG's segment sweeps never "
                           "launched K1")
    return H, psi, envs, {"launches": launches,
                          "warmup": split["warmup"],
                          "rounds": split["rounds"],
                          "segments_cold": segment_launches}


def _rs_dmrg2():
    """Leg (b): RS-DMRG2 (two-site segment sweeps, truncdim(64)) of the
    same chain at D=64 float64."""
    import torch
    from mpskit_tpu_torch import (
        FiniteMPS, RealSpaceParallelDMRG, expectation_value,
        find_groundstate, transverse_field_ising_lattice, truncdim,
    )

    H = transverse_field_ising_lattice(g=RS_G)
    gen = torch.Generator(device="cuda").manual_seed(59)
    psi = FiniteMPS.random(RS_L, 2, RS2_D, torch.float64, "cuda", gen)
    mark, marks = _round_marks()
    psi, envs, eps = find_groundstate(psi, H, RealSpaceParallelDMRG(
        nseg=RS_NSEG, two_site=True, trscheme=truncdim(RS2_D), maxiter=30,
        finalize=mark, verbosity=0))
    times, syncs = _intervals(marks)
    E = float(expectation_value(psi, H, envs=envs))
    log(f"[rs] b: RS-DMRG2 L={RS_L} D={RS2_D} float64: {len(times)} rounds "
        f"of {np.mean(times):.3f} s mean, {np.mean(syncs):.0f} host syncs "
        f"each, E {E:.12f}, eps {eps:.2e}")
    _gate("rs", "b: RS-DMRG2 |E - closed form|",
          abs(E - tfim_open_chain_e0(RS_L, RS_G)), RS2_TOL)
    return psi


def _param_scan():
    """Leg (c): scan_groundstate_vumps over g in SCAN_GS at D=256 float32
    from seeded random states; each member iteration timed from outside
    (synchronized), so a lockstep iteration is the sum over members."""
    import torch
    from mpskit_tpu_torch import (
        VUMPS, InfiniteMPS, scan_groundstate_vumps,
        transverse_field_ising_lattice,
    )
    from mpskit_tpu_torch.algorithms import paramscan
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    gen = torch.Generator(device="cuda").manual_seed(61)
    psis = [InfiniteMPS.random(1, 2, SCAN_D, torch.float32, "cuda", gen)
            for _ in SCAN_GS]
    Hs = [transverse_field_ising_lattice(g=g) for g in SCAN_GS]
    calls = []
    iterate = paramscan._vumps_iteration_impl

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        out = iterate(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, sync.count - c0))
        return out

    k1.launches = 0
    t0 = time.perf_counter()
    with _patched(paramscan, _vumps_iteration_impl=timed):
        res = scan_groundstate_vumps(psis, Hs, VUMPS(
            tol=1e-6, maxiter=SCAN_ITERS, krylovdim=10, eig_maxrestarts=2,
            gauge_tol=1e-8, verbosity=0))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    B = len(SCAN_GS)
    its = [(sum(c[0] for c in calls[k: k + B]),
            sum(c[1] for c in calls[k: k + B]))
           for k in range(0, len(calls), B)]
    later = its[1:] or its
    log(json.dumps({
        "metric": f"vumps_scan_iteration_time_tfim_B{B}_D{SCAN_D}_float32",
        "value": sum(t for t, _ in later) / len(later), "unit": "s",
        "iterations": res.iterations,
        "host_syncs_per_iteration": sum(c for _, c in later) / len(later)}))
    es = res.energies.cpu().numpy().real
    log(f"[rs] c: scan of {B} members, {res.iterations} lockstep "
        f"iterations, {total:.1f} s with the closing gauge fix and "
        f"environments; eps " + ", ".join(
            f"{e:.2e}" for e in res.eps.cpu().numpy()))
    _idle_share("rs", "c: one more lockstep iteration (with the closing)",
                lambda: scan_groundstate_vumps(res.psis, Hs, VUMPS(
                    maxiter=1, krylovdim=10, eig_maxrestarts=2,
                    gauge_tol=1e-8, verbosity=0)))
    for g, e in zip(SCAN_GS, es):
        log(f"[rs] c: g={g}: e {e:.8f}, exact {tfim_density(g):.8f}")
        _gate("rs", f"c: g={g} |e - exact density|",
              abs(e - tfim_density(g)), SCAN_TOL)
    if k1.launches != 0:
        raise RuntimeError("leg (c): the parameter scan launched K1")
    return res


def _compat_and_plots(H, psi, envs, psi2, scan):
    """Leg (d): the compat surface on leg (a)'s state and the plot data on
    the card against the CPU."""
    import torch
    from mpskit_tpu_torch import (
        FiniteMPS, InfiniteMPS, TransferMatrix, entanglement_plot_data,
        environments, leftenv, rightenv, transfer_left, transfer_plot_data,
    )

    env2 = environments(psi, H)
    rel = 0.0
    for i in range(psi.length):
        for a, b in ((leftenv(env2, i, psi), envs.GLs[i]),
                     (rightenv(env2, i, psi), envs.GRs[i + 1])):
            rel = max(rel, float((a - b).norm() / b.norm()))
    _gate("rs", "d: environments / leftenv / rightenv against the sweep's",
          rel, COMPAT_TOL32)
    gen = torch.Generator(device="cuda").manual_seed(67)
    v = torch.randn((RS_D, RS_D), generator=gen, device="cuda")
    A = psi.ARs[RS_L // 2]
    ref = transfer_left(v, A, A)
    _gate("rs", "d: TransferMatrix against transfer_left (relative)",
          float((TransferMatrix(A, A)(v) - ref).norm() / ref.norm()),
          COMPAT_TOL32)
    ent = [entanglement_plot_data(p, RS_L // 2) for p in (
        psi2, FiniteMPS(*(t.cpu() for t in (psi2.ALs, psi2.ARs, psi2.AC)),
                        psi2.center))]
    # the data drop values below 1e-30, where the two devices may differ
    n = max(len(e) for e in ent)
    ent = [np.pad(e, (0, n - len(e))) for e in ent]
    _gate("rs", "d: entanglement_plot_data card against CPU",
          float(np.abs(ent[0] - ent[1]).max()), PLOT_CARD_TOL)
    member = InfiniteMPS(*(t[1].double() for t in (
        scan.psis.AL, scan.psis.AR, scan.psis.AC, scan.psis.C)))
    radii = [transfer_plot_data(p, num=5)[1] for p in (member, InfiniteMPS(
        *(t.cpu() for t in (member.AL, member.AR, member.AC, member.C))))]
    _gate("rs", "d: transfer_plot_data |lambda| card against CPU",
          float(np.abs(np.sort(radii[0]) - np.sort(radii[1])).max()),
          PLOT_CARD_TOL)


def phase_rsdmrg():
    """Phase 19: segment-parallel DMRG, its two-site form, the parameter
    scan and the compat / plotting surface. Returns RS-DMRG's K1
    launches: {"launches": leg (a)'s run, "warmup" and "rounds": its
    warmup sweeps' and its rounds' shares, "segments_cold": the cold-start
    round's}."""
    legs = {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        legs[name] = time.perf_counter() - t0
        return out

    H, psi, envs, launches = leg("a", _rs_dmrg)
    psi2 = leg("b", _rs_dmrg2)
    scan = leg("c", _param_scan)
    leg("d", _compat_and_plots, H, psi, envs, psi2, scan)
    log("[rs] seconds per leg: " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()))
    return launches


def _charge_leak(spsi):
    """The largest entry outside the charge mask over AC, the left-gauged
    tensors left of the center and the right-gauged ones right of it."""
    import torch

    m = torch.as_tensor(spsi.masks, device=spsi.state.device)
    st = spsi.state
    c = st.center
    parts = [st.AC * ~m[c]]
    if c > 0:
        parts.append(st.ALs[:c] * ~m[:c])
    if c < st.length - 1:
        parts.append(st.ARs[c + 1:] * ~m[c + 1:])
    return max(float(p.abs().max()) for p in parts)


def _occupations(psi):
    """<n_i> at every site (charge 1 = physical index 1): the weight of
    index 1 in the center tensor as the center walks left to right, one
    gauge move per site and one host read in all."""
    import torch

    p, out = psi.move_center(0), []
    for i in range(psi.length):
        p = p.move_center(i)
        w = p.AC.abs() ** 2
        out.append(w[:, 1].sum() / w.sum())
    return torch.stack(out).cpu().numpy()


def _u1_dmrg():
    """Leg (a): U(1) one-site DMRG of the XX chain in the sector N=16 at
    L=32 D=512 float32 through find_groundstate, K1 (w=4) on the first
    restarts; each sweep timed from outside."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, SymmetricFiniteMPS, expectation_value, find_groundstate,
        xx_chain_with_field,
    )
    from mpskit_tpu_torch.algorithms import dmrg
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.utils import sync

    H = xx_chain_with_field(h=0.0)
    gen = torch.Generator(device="cuda").manual_seed(71)
    spsi = SymmetricFiniteMPS.random(U1_L, (0, 1), U1_D, U1_N,
                                     torch.float32, None, "cuda", gen)
    sweep = dmrg._dmrg_sweep_impl
    rows = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        out = sweep(*args, **kwargs)
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, sync.count - c0))
        return out

    k1.launches = 0
    with _patched(dmrg, _dmrg_sweep_impl=timed):
        spsi, envs, eps = find_groundstate(spsi, H, DMRG(
            krylovdim=10, eig_maxrestarts=2, tol=1e-6, maxiter=U1_SWEEPS,
            verbosity=0))
    torch.cuda.synchronize()
    launches = k1.launches
    for k, (t, c) in enumerate(rows, 1):
        log(f"[u1] a: sweep {k}: {t:.3f} s, {c} host syncs")
    later = rows[1:] or rows
    log(json.dumps({
        "metric": f"u1_dmrg_sweep_time_xx_L{U1_L}_D{U1_D}_float32",
        "value": sum(t for t, _ in later) / len(later), "unit": "s",
        "sweeps": len(rows),
        "host_syncs_per_sweep": sum(c for _, c in later) / len(later),
        "eps": eps}))
    E = float(expectation_value(spsi.state, H, envs=envs))
    _idle_share("u1", "a: one more sweep from the result", lambda: (
        find_groundstate(spsi, H, DMRG(krylovdim=10, eig_maxrestarts=2,
                                       maxiter=1, verbosity=0))))
    e_ex = float(np.sum(-2 * np.cos(np.arange(1, U1_N + 1) * np.pi
                                    / (U1_L + 1))))
    N = float(_occupations(spsi.state).sum())
    log(f"[u1] a: XX chain L={U1_L} D={U1_D} N={U1_N} float32: E {E:.8f}, "
        f"exact {e_ex:.8f}, <N> {N:.8f}, eps {eps:.2e}, K1 launches "
        f"{launches}")
    _gate("u1", "a: energy, relative to the free-fermion sum",
          abs(E - e_ex) / abs(e_ex), U1_TOL)
    _gate("u1", "a: |<N> - 16|", abs(N - U1_N), U1_N_TOL)
    _gate("u1", "a: largest entry outside the charge mask",
          _charge_leak(spsi), 0.0)
    if launches <= 0:
        raise RuntimeError("leg (a): the U(1) sweep never launched K1")
    return launches


def _u1_dmrg2():
    """Leg (b): sector-resolved DMRG2 then the one-site sector DMRG at
    D=128 float64 in N=16 and N=17 (the N=17 DMRG2 split by
    synchronizations into eigensolves and per-sector SVD splits), the
    merged sector spectrum and the entropy, and the charged quasiparticles
    above the h=4 vacuum."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, DMRG2, QuasiparticleAnsatz, SymmetricFiniteMPS,
        entanglement_spectrum, entropy_profile, excitations,
        expectation_value, find_groundstate, sector_entanglement_spectrum,
        xx_chain_with_field,
    )
    from mpskit_tpu_torch.symmetry import charges

    H = xx_chain_with_field(h=0.0)
    gen = torch.Generator(device="cuda").manual_seed(73)
    energies, states = {}, {}
    for N in (U1_N, U1_N + 1):
        spsi = SymmetricFiniteMPS.random(U1_L, (0, 1), U1_D2, N,
                                         torch.float64, None, "cuda", gen)
        alg2 = DMRG2(tol=1e-10, maxiter=U1_DMRG2_SWEEPS, verbosity=0)
        if N == U1_N + 1:
            box = {}

            def run():
                box["out"] = find_groundstate(spsi, H, alg2)
            total, parts = _split_by_sync(run, charges, {
                "eigsh_smallest": "eigensolves",
                "_sector_split": "per-sector SVD splits",
                "transfer_left_mpo": "environment pushes",
                "transfer_right_mpo": "environment pushes"})
            spsi, _, eps2 = box["out"]
            log(f"[u1] b: N={N} DMRG2 ({U1_DMRG2_SWEEPS} sweeps) split "
                f"({total:.1f} ms): " + "; ".join(
                    f"{k} {t:.1f} ms ({t / total:.1%}, {c} syncs)"
                    for k, (t, c) in parts.items()))
        else:
            t0 = time.perf_counter()
            spsi, _, eps2 = find_groundstate(spsi, H, alg2)
            log(f"[u1] b: N={N} DMRG2 ({U1_DMRG2_SWEEPS} sweeps) "
                f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        spsi, envs, eps = find_groundstate(spsi, H, DMRG(
            tol=1e-10, maxiter=20, verbosity=0))
        energies[N] = float(expectation_value(spsi.state, H, envs=envs))
        states[N] = spsi
        live = [int((np.asarray(c) < 10**5).sum()) for c in
                spsi.bond_charges]
        log(f"[u1] b: N={N}: E {energies[N]:.12f} (DMRG2 eps {eps2:.1e}, "
            f"DMRG eps {eps:.1e}, {time.perf_counter() - t0:.1f} s), live "
            f"labels at the middle bond {live[U1_L // 2]}")
    gap = energies[U1_N + 1] - energies[U1_N]
    _gate("u1", "b: |E(17) - E(16) + 2 cos(17 pi / 33)|",
          abs(gap + 2 * np.cos((U1_N + 1) * np.pi / (U1_L + 1))),
          U1_GAP_TOL)
    spsi = states[U1_N]
    sec = sector_entanglement_spectrum(spsi, U1_L // 2)
    merged = np.sort(np.concatenate(list(sec.values())))[::-1]
    plain = np.sort(entanglement_spectrum(spsi.state, U1_L // 2)
                    .cpu().numpy())[::-1]
    log(f"[u1] b: sectors at bond {U1_L // 2}: " + ", ".join(
        f"{q}: {len(v)}" for q, v in sec.items()))
    _gate("u1", "b: merged sector spectrum against entanglement_spectrum",
          float(np.abs(merged - plain[: len(merged)]).max()
                + np.abs(plain[len(merged):]).sum()), U1_SPEC_TOL)
    S = entropy_profile(spsi.state).cpu().numpy()
    _gate("u1", "b: entropy at the middle bond against the exact one",
          abs(S[U1_L // 2 - 1] - _free_fermion_exact(U1_L)[1][U1_L // 2 - 1]),
          U1_S_TOL)

    Hh = xx_chain_with_field(h=U1_QP_H)
    vac = SymmetricFiniteMPS.random(U1_L, (0, 1), U1_QP_D, 0, torch.float64,
                                    None, "cuda", gen)
    vac, _, _ = find_groundstate(vac, Hh, DMRG(tol=1e-11, maxiter=20,
                                               verbosity=0))
    t0 = time.perf_counter()
    es, _ = excitations(Hh, QuasiparticleAnsatz(tol=1e-10), vac, sector=1,
                        num=3, generator=torch.Generator(device="cuda")
                        .manual_seed(79))
    got = np.sort(es.numpy())
    ks = np.pi * np.arange(1, U1_L + 1) / (U1_L + 1)
    want = np.sort(U1_QP_H - 2 * np.cos(ks))[:3]
    log(f"[u1] b: charged QP on the h={U1_QP_H} vacuum L={U1_L} "
        f"D={U1_QP_D}: {got} against {want}, "
        f"{time.perf_counter() - t0:.1f} s")
    _gate("u1", "b: charged QP against h - 2 cos(n pi / 33)",
          float(np.abs(got - want).max()), U1_QP_TOL)


def _u1_tdvp():
    """Leg (c): the quench XX -> XXZ(delta=0.5) of an N=16 ground state at
    D=256 in complex64, symmetric and unsymmetric from the same state."""
    import torch
    from mpskit_tpu_torch import (
        DMRG, TDVP, SymmetricFiniteMPS, expectation_value, find_groundstate,
        heisenberg_XXZ, timestep, xx_chain_with_field,
    )
    from mpskit_tpu_torch.kernels import ac_apply as k1
    from mpskit_tpu_torch.models.spins import spinmatrices
    from mpskit_tpu_torch.utils import sync

    gen = torch.Generator(device="cuda").manual_seed(83)
    spsi = SymmetricFiniteMPS.random(U1_L, (0, 1), U1_TDVP_D, U1_N,
                                     torch.float32, None, "cuda", gen)
    spsi, _, _ = find_groundstate(spsi, xx_chain_with_field(h=0.0), DMRG(
        krylovdim=10, eig_maxrestarts=2, tol=1e-6, maxiter=8, verbosity=0))
    _, _, Sz, _ = spinmatrices(0.5)
    affine = np.allclose(2 * np.real(np.diag(Sz)), 1 - 2 * np.array((0, 1)))
    log(f"[u1] c: spin-1/2 basis: 2 Sz = {2 * np.real(np.diag(Sz))}, "
        f"1 - 2 q = {1 - 2 * np.array((0, 1))}: charge (0, 1) is an affine "
        f"map of 2 Sz: {affine}")
    if not affine:
        raise RuntimeError("leg (c): the basis order does not match")
    start = _complex_start(spsi.state)[torch.complex64]
    sym = SymmetricFiniteMPS(start, spsi.bond_charges, spsi.phys_charges)
    plain = start
    H1 = heisenberg_XXZ(spin=0.5, delta=0.5)
    alg = TDVP(expalg_m=20, verbosity=0)
    times, syncs = [], []
    N0 = float(_occupations(start).sum())
    worst = {"energy": 0.0, "<n_i>": 0.0, "N": 0.0}
    k1.launches = 0
    for k in range(U1_TDVP_STEPS):
        t = k * U1_TDVP_DT
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        sym, _ = timestep(sym, H1, t, U1_TDVP_DT, alg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(sync.count - c0)
        plain, _ = timestep(plain, H1, t, U1_TDVP_DT, alg)
        es = [complex(expectation_value(p, H1)).real
              for p in (sym.state, plain)]
        ns = [_occupations(p) for p in (sym.state, plain)]
        worst["energy"] = max(worst["energy"],
                              abs(es[0] - es[1]) / abs(es[1]))
        worst["<n_i>"] = max(worst["<n_i>"],
                             float(np.abs(ns[0] - ns[1]).max()))
        worst["N"] = max(worst["N"], abs(float(ns[0].sum()) - N0))
        log(f"[u1] c: step {k + 1}: {times[-1]:.3f} s, {syncs[-1]} host "
            f"syncs; E symmetric {es[0]:.7f}, unsymmetric {es[1]:.7f}, "
            f"<N> {ns[0].sum():.7f}")
    launches = k1.launches
    _idle_share("u1", "c: one more symmetric step", lambda: timestep(
        sym, H1, U1_TDVP_STEPS * U1_TDVP_DT, U1_TDVP_DT, alg))
    later = times[1:]
    log(json.dumps({
        "metric": f"u1_tdvp_step_time_xxz_L{U1_L}_D{U1_TDVP_D}_complex64",
        "value": sum(later) / len(later), "unit": "s",
        "steps": len(times), "host_syncs_per_step": sum(syncs[1:])
        / len(later)}))
    _gate("u1", "c: |E symmetric - unsymmetric| / |E| over the steps",
          worst["energy"], U1_TDVP_TOL)
    _gate("u1", "c: |<n_i> symmetric - unsymmetric| over the steps",
          worst["<n_i>"], U1_TDVP_TOL)
    _gate("u1", "c: |<N>(t) - <N>(0)|", worst["N"], U1_TDVP_TOL)
    _gate("u1", "c: largest entry outside the charge mask",
          _charge_leak(sym), 0.0)
    if launches != 0:
        raise RuntimeError("leg (c): complex64 TDVP launched K1")


def _u1_infinite():
    """Leg (d): sector VUMPS of the XXX chain (two-site cell, charges +-1)
    at D=128 float64 with its sector transfer spectra, and the Z_2 gap of
    the parity TFIM at D=48. Returns the XXX state and its energy
    density."""
    import torch
    from mpskit_tpu_torch import (
        VUMPS, QuasiparticleAnsatz, SymmetricInfiniteMPS, excitations,
        find_groundstate, heisenberg_XXX, transfer_spectrum,
        transverse_field_ising_parity,
    )

    H = heisenberg_XXX(spin=0.5)
    gen = torch.Generator(device="cuda").manual_seed(89)
    spsi = SymmetricInfiniteMPS.random(2, (1, -1), U1_INF_D, torch.float64,
                                       None, "cuda", gen)
    t0 = time.perf_counter()
    spsi, envs, eps = find_groundstate(spsi, H, VUMPS(tol=1e-8, maxiter=100,
                                                      verbosity=0))
    e = float(envs.e_density)
    e_ex = 1 - 4 * np.log(2)
    # the critical chain's |lambda_1| is 0.992 at D=128: 60 Arnoldi steps
    # left |lambda_0| 9.3e-11 from 1 (H100 80GB HBM3, 700 W)
    lams = {q: transfer_spectrum(spsi, num=3, krylovdim=100, sector=q)
            .cpu().numpy() for q in (0, 2)}
    log(f"[u1] d: XXX two-site cell D={U1_INF_D} float64: e {e:.10f}, "
        f"1 - 4 ln 2 = {e_ex:.10f} (gap {e - e_ex:.3e}), eps {eps:.2e}, "
        f"{time.perf_counter() - t0:.1f} s; |lambda| sector 0 "
        f"{np.abs(lams[0])}, sector 2 {np.abs(lams[2])}")
    _gate("u1", "d: |e - (1 - 4 ln 2)|", abs(e - e_ex), U1_INF_TOL)
    _, C_mask = spsi.device_masks()
    _gate("u1", "d: largest C entry outside its mask",
          float((spsi.state.C * ~C_mask).abs().max()), 1e-12)
    _gate("u1", "d: ||lambda_0| - 1| in sector 0",
          abs(abs(lams[0][0]) - 1), 1e-10)
    _gate("u1", "d: leading |lambda| in sector 2 (below 1)",
          abs(lams[2][0]), 1 - 1e-6)

    Hz = transverse_field_ising_parity(g=Z2_G)
    z2 = SymmetricInfiniteMPS.random(1, (0, 1), Z2_D, torch.float64, 2,
                                     "cuda", gen)
    z2, _, eps_z = find_groundstate(z2, Hz, VUMPS(tol=1e-10, maxiter=100,
                                                  verbosity=0))
    t0 = time.perf_counter()
    es, _ = excitations(Hz, QuasiparticleAnsatz(tol=1e-10), 0.0, z2,
                        sector=1, generator=torch.Generator(device="cuda")
                        .manual_seed(97))
    gap = float(es[0, 0])
    log(f"[u1] d: Z_2 parity TFIM g={Z2_G} D={Z2_D}: VUMPS eps {eps_z:.1e}, "
        f"sector-1 QP at p=0 {gap:.10f} (exact 2|g - 1| = "
        f"{2 * abs(Z2_G - 1):.1f}), {time.perf_counter() - t0:.1f} s")
    _gate("u1", "d: |Z_2 gap - 2|g - 1||", abs(gap - 2 * abs(Z2_G - 1)),
          Z2_GAP_TOL)
    return H, spsi, e


def _u1_expand_and_checkpoints(H, spsi, e_before):
    """Leg (e): changebonds_symmetric (OptimalExpand by U1_EXPAND) on leg
    (d)'s state, then VUMPS at the larger D; checkpoints of a Z_2
    SymmetricFiniteMPS and of leg (d)'s state."""
    import tempfile

    import torch
    from mpskit_tpu_torch import (
        VUMPS, OptimalExpand, SymmetricFiniteMPS, find_groundstate,
        load_state, save_state,
    )
    from mpskit_tpu_torch.environments.infinite_ham import (
        hamiltonian_environments,
    )
    from mpskit_tpu_torch.symmetry import changebonds_symmetric
    from mpskit_tpu_torch.utils.serialize import _leaves

    big = changebonds_symmetric(spsi, H, alg=OptimalExpand(dims=U1_EXPAND))
    A_mask, C_mask = big.device_masks()
    leak = max(float((big.state.AL * ~A_mask).abs().max()),
               float((big.state.C * ~C_mask).abs().max()))
    e_big = float(hamiltonian_environments(big.state, H).e_density)
    big, envs, _ = find_groundstate(big, H, VUMPS(tol=1e-8, maxiter=10,
                                                  verbosity=0))
    e_after = float(envs.e_density)
    added = [sorted(set(np.asarray(c)[U1_INF_D:].tolist()))
             for c in big.bond_charges]
    log(f"[u1] e: OptimalExpand(+{U1_EXPAND}): D {big.state.D}, new labels "
        f"{added}; e before {e_before:.10f}, expanded {e_big:.10f}, after "
        f"10 VUMPS iterations {e_after:.10f}")
    _gate("u1", "e: largest entry outside the expanded masks", leak, 0.0)
    _gate("u1", "e: e after expansion and VUMPS above e before",
          max(e_after - e_before, 0.0), 0.0)
    gen = torch.Generator(device="cuda").manual_seed(101)
    z2 = SymmetricFiniteMPS.random(16, (0, 1), 32, 0, torch.float64, 2,
                                   "cuda", gen)
    with tempfile.TemporaryDirectory() as tmp:
        for name, state in (("Z_2 finite", z2), ("U(1) infinite", spsi)):
            path = str(Path(tmp) / "s.npz")
            save_state(path, state)
            back = load_state(path, device="cuda")
            same = (type(back) is type(state)
                    and back.modulus == state.modulus
                    and back.phys_charges == state.phys_charges
                    and all(np.array_equal(a, b) for a, b in
                            zip(back.bond_charges, state.bond_charges))
                    and all(a.device == b.device and torch.equal(a, b)
                            for a, b in zip(_leaves(back), _leaves(state))))
            masks = (back.masks, state.masks)
            same = same and all(np.array_equal(a, b) for a, b in zip(
                *(m if isinstance(m, tuple) else (m,) for m in masks)))
            log(f"[u1] e: {name} checkpoint (modulus {state.modulus}) "
                f"reloaded bit for bit, labels, masks and modulus: {same}")
            if not same:
                raise RuntimeError(f"leg (e): the {name} checkpoint changed")


def phase_symmetric():
    """Phase 20: the abelian symmetric states. Returns the U(1) sweep's K1
    launches."""
    legs = {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        legs[name] = time.perf_counter() - t0
        return out

    launches = leg("a", _u1_dmrg)
    leg("b", _u1_dmrg2)
    leg("c", _u1_tdvp)
    H, spsi, e = leg("d", _u1_infinite)
    leg("e", _u1_expand_and_checkpoints, H, spsi, e)
    log("[u1] seconds per leg: " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()))
    return launches


def _su2_state_to(st, device):
    """An SU2ReducedState or SU2FiniteMPS with every block on `device`
    (the legs draw their starts on the CPU, so that the card and the CPU
    start from the same numbers)."""
    import dataclasses

    from mpskit_tpu_torch.symmetry import SU2ReducedState

    if isinstance(st, SU2ReducedState):
        return SU2ReducedState(*(b.to(device) for b in (st.AL, st.AR, st.AC,
                                                         st.C)), st.tjp)
    return dataclasses.replace(st, sites=tuple(s.to(device)
                                               for s in st.sites))


def _su2_reduced_start(mult, seed, device):
    import torch
    from mpskit_tpu_torch.symmetry import SU2Bond, SU2ReducedState

    gen = torch.Generator().manual_seed(seed)
    return _su2_state_to(SU2ReducedState.random(
        SU2Bond(mult), 2, torch.float64, "cpu", gen), device)


def _su2_finite_start(L, max_mult, seed, device, tj_max=None):
    """A random spin-1 chain in the total-spin-0 sector on
    `finite_bonds(L, 2, 0, max_mult)`, its bond sectors cut to 2j <=
    tj_max when given (a low-spin start: the full fusion tree reaches 2j=L
    at mid-chain, sectors that carry no weight in the ground state but
    whose structure coefficients cost the host seconds to probe)."""
    import torch
    from mpskit_tpu_torch.symmetry import SU2FiniteMPS
    from mpskit_tpu_torch.symmetry.su2_finite import _random_site, \
        finite_bonds

    gen = torch.Generator().manual_seed(seed)
    if tj_max is None:
        psi = SU2FiniteMPS.random(L, 2, 0, max_mult, torch.float64, "cpu",
                                  gen)
    else:
        bonds = tuple(tuple((tj, m) for tj, m in b if tj <= tj_max)
                      for b in finite_bonds(L, 2, 0, max_mult))
        sites = tuple(_random_site(bonds[i], 2, bonds[i + 1], torch.float64,
                                   "cpu", gen) for i in range(L))
        psi = SU2FiniteMPS(sites, bonds, L - 1, 2).move_center(0).normalize()
    return _su2_state_to(psi, device)


def _su2_reduced_vumps():
    """Leg (a): the reduced VUMPS of the spin-1 Heisenberg chain at dense
    D=216 through find_groundstate from a random state; then steady
    iterations at the converged state timed, counted in host syncs and
    profiled; the plain dense VUMPS at D=216 timed at the same state
    (embedded), and from a random state."""
    import torch
    from mpskit_tpu_torch import VUMPS, InfiniteMPS, find_groundstate, \
        heisenberg_XXX
    from mpskit_tpu_torch.algorithms.vumps import _vumps_iteration_impl
    from mpskit_tpu_torch.config import matmul_precision
    from mpskit_tpu_torch.symmetry import SU2Bond, heisenberg_reduced, \
        schmidt_spectrum_reduced
    from mpskit_tpu_torch.symmetry import su2_reduced as tr
    from mpskit_tpu_torch.utils import sync

    mpo = heisenberg_reduced(2)
    bond = SU2Bond(SU2_BOND)
    st = _su2_reduced_start(SU2_BOND, 81, "cuda")
    n_conv = [0]
    inner = tr.reduced_vumps_iteration

    def counted(*args, **kw):
        n_conv[0] += 1
        return inner(*args, **kw)

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    with _patched(tr, reduced_vumps_iteration=counted):
        st, e, eps = find_groundstate(st, mpo, VUMPS(tol=1e-9, maxiter=60,
                                                     krylovdim=10))
    torch.cuda.synchronize()
    t_conv, c_conv = time.perf_counter() - t0, sync.count - c0
    log(f"[su2] a: reduced VUMPS dense D={bond.dim} float64 from a random "
        f"state: e {e:.12f}, eps {eps:.2e}, {n_conv[0]} iterations in "
        f"{t_conv:.2f} s ({t_conv / n_conv[0]:.3f} s and "
        f"{c_conv / n_conv[0]:.0f} host syncs per iteration)")

    # steady iterations at the converged state, bench_su2_reduced.py's
    # settings (krylovdim 10, 2 restarts, inner tolerance 1e-6)
    a = VUMPS_ARGS
    carry = [st.AL, st.AR, st.AC, st.C, None, None]

    def iteration():
        AL, AR, AC, C, gls, grs = carry
        with matmul_precision():
            AL, AR, AC, C, eps_d, e_d, _, gls, grs = inner(
                AL, AR, AC, C, mpo, 2, a["inner_tol"], a["m"],
                a["restarts"], gls, grs)
        carry[:] = [AL, AR, AC, C, gls, grs]
        return sync.to_host(eps_d, e_d)

    iteration()
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    for _ in range(SU2_TIMED):
        iteration()
    torch.cuda.synchronize()
    t_it = (time.perf_counter() - t0) / SU2_TIMED
    syncs = (sync.count - c0) / SU2_TIMED
    terms, gemms = tr.rac_terms(carry[4], carry[5], mpo, carry[2])
    plain = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - plain) * 1e3
    busy, n_dev, by_name = _device_busy_ms(iteration)
    idle = None if not busy else 1 - busy / plain
    log(json.dumps({
        "metric": "su2_reduced_vumps_iteration_time_heisenberg_s1_D216_"
                  "float64", "value": t_it, "unit": "s",
        "host_syncs_per_iteration": syncs, "gemm_terms_per_rac_apply": terms,
        "gemms_per_rac_apply": gemms, "idle_share": idle,
        "device_ops_per_iteration": n_dev,
        "converging_s_per_iteration": t_conv / n_conv[0],
        "converging_host_syncs_per_iteration": c_conv / n_conv[0],
        "iterations_to_converge": n_conv[0]}))
    log(f"[su2] a: one more iteration {plain:.1f} ms plainly; under "
        "torch.profiler " + (f"busy {busy:.1f} ms, idle share {idle:.1%}"
                             if busy else "no device time in the trace"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, n) in top:
        log(f"[su2] a: device op {ms:8.3f} ms {n:6d}x  {name[:90]}")

    # the plain dense VUMPS at the same dense width: at the embedded
    # converged state (the same regime), then from a random state
    H = heisenberg_XXX(spin=1, dtype=np.float64)
    ALd = tr.embed_site(carry[0], bond, 2, bond)[None]
    Cd = tr.embed_c(carry[3], bond)[None]
    emb = InfiniteMPS.from_AL(torch.as_tensor(ALd, device="cuda"),
                              torch.as_tensor(Cd[0], device="cuda"),
                              tol=a["gauge_tol"])
    gen = torch.Generator(device="cuda").manual_seed(83)
    dense = {}
    for start, psi in (("converged", emb), ("random", InfiniteMPS.random(
            1, 3, bond.dim, torch.float64, "cuda", gen))):
        env = None
        with matmul_precision():
            for k in range(SU2_DENSE_WARM + SU2_DENSE_TIMED):
                if k == SU2_DENSE_WARM:
                    torch.cuda.synchronize()
                    t0, c0 = time.perf_counter(), sync.count
                psi, eps_d, env, _ = _vumps_iteration_impl(
                    psi, H, **a, env_guess=env)
                sync.to_host(eps_d)
            torch.cuda.synchronize()
        dense[start] = ((time.perf_counter() - t0) / SU2_DENSE_TIMED,
                        (sync.count - c0) / SU2_DENSE_TIMED,
                        float(env.e_density) / 4)
    t_dense = dense["converged"][0]
    log(json.dumps({
        "metric": "dense_vumps_iteration_time_heisenberg_s1_D216_float64",
        "value": t_dense, "unit": "s",
        "host_syncs_per_iteration": dense["converged"][1],
        "energy_density": dense["converged"][2],
        "from_random_s_per_iteration": dense["random"][0],
        "from_random_host_syncs_per_iteration": dense["random"][1]}))
    log(f"[su2] a: reduced / dense iteration time at the converged state "
        f"{t_it / t_dense:.2f}; while converging from random states "
        f"{t_conv / n_conv[0] / dense['random'][0]:.2f}")

    _gate("su2", "a: |e - E0| of the reduced VUMPS", abs(e - SU2_E0),
          SU2_E_TOL)
    _gate("su2", "a: |e - E0| of the dense VUMPS at the embedded state",
          abs(dense["converged"][2] - SU2_E0), SU2_E_TOL)
    spec = schmidt_spectrum_reduced(st)
    want = np.sort(np.concatenate([np.repeat(v, tj + 1)
                                   for tj, v in spec.items()]))[::-1]
    dense_s = np.linalg.svd(tr.embed_c(st.C, bond), compute_uv=False)
    _gate("su2", "a: dense Schmidt values against the (2j+1)-fold "
          "multiplets", float(np.abs(dense_s - want).max()), 1e-10)
    if set(spec) != {1, 3, 5} or spec[1][0] != max(v[0]
                                                   for v in spec.values()):
        raise RuntimeError("leg (a): the Schmidt multiplets are not the "
                           "Haldane phase's (half-integer, j=1/2 largest)")


def _su2_haldane():
    """Leg (b): the reduced Haldane gap at dense D=42, p = pi, spin-1
    excitation, against the oracle and the port's dense QP on the
    embedded state."""
    import torch
    from mpskit_tpu_torch import VUMPS, QuasiparticleAnsatz, excitations, \
        find_groundstate
    from mpskit_tpu_torch.interop import infinite_mps_from_numpy, \
        mpo_from_numpy
    from mpskit_tpu_torch.symmetry import SU2Bond, heisenberg_reduced
    from mpskit_tpu_torch.symmetry import su2_reduced as tr
    from mpskit_tpu_torch.utils import sync

    mpo = heisenberg_reduced(2)
    bond = SU2Bond(SU2_QP_BOND)
    st = _su2_reduced_start(SU2_QP_BOND, 85, "cuda")
    st, e, eps = find_groundstate(st, mpo, VUMPS(tol=1e-9, maxiter=150))
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), sync.count
    es, _ = excitations(mpo, QuasiparticleAnsatz(tol=1e-7), np.pi, st,
                        sector=2)
    torch.cuda.synchronize()
    t_qp, n_sync = time.perf_counter() - t0, sync.count - c0
    gap = float(es[0, 0])
    log(json.dumps({"metric": "su2_haldane_qp_solve_time_s1_D42_float64",
                    "value": t_qp, "unit": "s", "host_syncs": n_sync,
                    "gap": gap, "ground_eps": eps}))
    # the port's dense quasiparticle solve on the embedded state
    ALd = tr.embed_site(st.AL, bond, 2, bond)[None]
    ARd = tr.embed_site(st.AR, bond, 2, bond)[None]
    Cd = tr.embed_c(st.C, bond)[None]
    psi = infinite_mps_from_numpy(
        ALd, ARd, np.einsum("ilpm,imr->ilpr", ALd, Cd), Cd, device="cuda")
    t0 = time.perf_counter()
    es_d, _ = excitations(mpo_from_numpy(mpo.dense_fsm()[None]),
                          QuasiparticleAnsatz(tol=1e-9), np.pi, psi, num=1)
    log(f"[su2] b: reduced gap {gap:.10f} in {t_qp:.2f} s ({n_sync} host "
        f"syncs); dense QP on the embedded state {float(es_d[0, 0]):.10f} "
        f"in {time.perf_counter() - t0:.2f} s")
    _gate("su2", "b: |gap - 0.41047925|", abs(gap - SU2_HALDANE),
          SU2_HALDANE_TOL)
    _gate("su2", "b: |reduced - dense QP on the embedded state|",
          abs(gap - float(es_d[0, 0])), SU2_QP_DENSE_TOL)


def _su2_finite(E64):
    """Leg (c): SU2DMRG2 then SU2DMRG of the spin-1 Heisenberg chain at
    L=32 in the total-spin-0 sector through find_groundstate from a
    low-spin random start, each sweep timed; the energy against phase 9's
    float64 continuation; then the middle bond grown by
    expand_bond_reduced."""
    import torch
    from mpskit_tpu_torch import find_groundstate
    from mpskit_tpu_torch.symmetry import (
        SU2DMRG, SU2DMRG2, energy_reduced, expand_bond_reduced,
        heisenberg_reduced,
    )
    from mpskit_tpu_torch.symmetry.su2_finite import _secs_dim
    from mpskit_tpu_torch.utils import sync

    mpo = heisenberg_reduced(2)
    psi = _su2_finite_start(SU2_L, 4, 87, "cuda", tj_max=6)
    rows = {"dmrg2": [], "dmrg": []}
    e = None
    for kind, n, alg in (
            ("dmrg2", SU2_DMRG2_SWEEPS, SU2DMRG2(
                tol=1e-12, maxiter=1, krylovdim=10, eig_maxrestarts=2,
                max_mult=SU2_MAX_MULT, max_dense=SU2_MAX_DENSE)),
            ("dmrg", SU2_DMRG_SWEEPS, SU2DMRG(tol=1e-12, maxiter=1,
                                               krylovdim=10,
                                               eig_maxrestarts=2))):
        for k in range(n):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), sync.count
            psi, e_new, _ = find_groundstate(psi, mpo, alg)
            torch.cuda.synchronize()
            width = max(_secs_dim(b) for b in psi.bonds)
            rows[kind].append((time.perf_counter() - t0, sync.count - c0,
                               e_new, width))
            log(f"[su2] c: {kind} sweep {k + 1}: {rows[kind][-1][0]:.2f} s, "
                f"{rows[kind][-1][1]} host syncs, E {4 * e_new:.12f}, widest "
                f"dense bond {width}")
            e = e_new
    later2 = rows["dmrg2"][1:] or rows["dmrg2"]
    later1 = rows["dmrg"]
    width = max(_secs_dim(b) for b in psi.bonds)
    log(json.dumps({
        "metric": "su2_dmrg2_sweep_time_heisenberg_s1_L32_float64",
        "value": sum(r[0] for r in later2) / len(later2), "unit": "s",
        "host_syncs_per_sweep": sum(r[1] for r in later2) / len(later2),
        "widest_dense_bond": max(r[3] for r in rows["dmrg2"]),
        "max_mult": SU2_MAX_MULT, "max_dense": SU2_MAX_DENSE}))
    log(json.dumps({
        "metric": "su2_dmrg_sweep_time_heisenberg_s1_L32_float64",
        "value": sum(r[0] for r in later1) / len(later1), "unit": "s",
        "host_syncs_per_sweep": sum(r[1] for r in later1) / len(later1),
        "widest_dense_bond": width}))
    E = 4 * e
    log(f"[su2] c: E (H = 4 S.S) {E:.12f} against phase 9's float64 "
        f"continuation {E64:.12f}")
    if not 200 <= width <= 256:
        raise RuntimeError(f"leg (c): widest dense bond {width} is outside "
                           "phase 9's two-site width, 200-256")
    _gate("su2", "c: energy relative to phase 9's float64 continuation",
          abs(E - E64) / abs(E64), SU2_E_REL_TOL)
    e_before = energy_reduced(psi, mpo)
    n0 = sum(m for _, m in psi.bonds[SU2_L // 2])
    t0 = time.perf_counter()
    grown = expand_bond_reduced(psi, mpo, SU2_L // 2, extra_mult=2)
    n1 = sum(m for _, m in grown.bonds[SU2_L // 2])
    log(f"[su2] c: expand_bond_reduced at bond {SU2_L // 2}: multiplets "
        f"{n0} -> {n1} in {time.perf_counter() - t0:.2f} s")
    if not n1 > n0:
        raise RuntimeError("leg (c): expand_bond_reduced did not grow the "
                           "bond")
    _gate("su2", "c: |energy change| of the bond growth",
          abs(energy_reduced(grown, mpo) - e_before), SU2_EXPAND_TOL)


def _su2_tdvp():
    """Leg (d): complex128 SU2TDVP through timestep at L=32 from a narrower
    state after one DMRG2 sweep (no eigenstate), SU2_TDVP_STEPS steps of
    dt=0.05."""
    import torch
    from mpskit_tpu_torch import find_groundstate, timestep
    from mpskit_tpu_torch.symmetry import (
        SU2DMRG2, SU2TDVP, energy_reduced, heisenberg_reduced,
    )
    from mpskit_tpu_torch.utils import sync

    mpo = heisenberg_reduced(2)
    psi = _su2_finite_start(SU2_L, 2, 89, "cuda", tj_max=4)
    psi, _, _ = find_groundstate(psi, mpo, SU2DMRG2(
        tol=1e-12, maxiter=1, krylovdim=10, eig_maxrestarts=2,
        max_dense=SU2_TDVP_DENSE))
    psi = psi.astype(torch.complex128)
    e0, n0 = energy_reduced(psi, mpo), psi.norm()
    rows = []
    for k in range(SU2_TDVP_STEPS):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), sync.count
        psi, _ = timestep(psi, mpo, k * SU2_TDVP_DT, SU2_TDVP_DT,
                          SU2TDVP(dt=SU2_TDVP_DT, krylovdim=20))
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, sync.count - c0))
        log(f"[su2] d: step {k + 1}: {rows[-1][0]:.2f} s, {rows[-1][1]} "
            f"host syncs, E {energy_reduced(psi, mpo):.12f}")
    later = rows[1:] or rows
    log(json.dumps({
        "metric": "su2_tdvp_step_time_heisenberg_s1_L32_complex128",
        "value": sum(r[0] for r in later) / len(later), "unit": "s",
        "host_syncs_per_step": sum(r[1] for r in later) / len(later),
        "widest_dense_bond": SU2_TDVP_DENSE}))
    e1 = energy_reduced(psi, mpo)
    _gate("su2", "d: energy drift, relative", abs(e1 - e0) / abs(e0),
          SU2_TDVP_E_TOL)
    _gate("su2", "d: norm drift", abs(psi.norm() - n0), SU2_TDVP_NORM_TOL)


def _su2_dense_projector():
    """Leg (e): the dense-projector SU(2) VUMPS at dense D=22."""
    import torch
    from mpskit_tpu_torch import VUMPS, heisenberg_XXX
    from mpskit_tpu_torch.interop import su2_infinite_mps_from_numpy
    from mpskit_tpu_torch.symmetry import (
        SU2Bond, SU2InfiniteMPS, find_groundstate_su2_vumps,
    )
    from mpskit_tpu_torch.symmetry.su2 import (
        su2_dense_schmidt_degeneracies, su2_schmidt_spectrum,
    )

    gen = torch.Generator().manual_seed(91)
    sp = SU2InfiniteMPS.random(SU2Bond(SU2_DENSE_BOND), 2, torch.float64,
                               "cpu", gen)
    s = sp.state
    sp = su2_infinite_mps_from_numpy(
        *(x.numpy() for x in (s.AL, s.AR, s.AC, s.C)), SU2_DENSE_BOND, 2,
        device="cuda")
    t0 = time.perf_counter()
    sp, envs, eps = find_groundstate_su2_vumps(
        sp, heisenberg_XXX(spin=1, dtype=np.float64),
        VUMPS(tol=1e-9, maxiter=300))
    e = float(envs.e_density)
    ok, s_dense = su2_dense_schmidt_degeneracies(sp, atol=1e-9)
    log(f"[su2] e: projected VUMPS D={sp.bond.dim}: e {e:.10f}, eps "
        f"{eps:.2e}, {time.perf_counter() - t0:.2f} s, multiplet sectors "
        f"{sorted(su2_schmidt_spectrum(sp))}")
    _gate("su2", "e: |e - 4 E0|", abs(e - 4 * SU2_E0), SU2_DENSE_E_TOL)
    if not (ok and eps < 1e-8):
        raise RuntimeError("leg (e): not converged or the dense Schmidt "
                           "spectrum is not multiplet-degenerate")


def _su2_card_vs_cpu():
    """Leg (f): (a)-(d) at small sizes on the card and on the CPU from the
    same starts."""
    import torch
    from mpskit_tpu_torch import (
        VUMPS, QuasiparticleAnsatz, excitations, find_groundstate, timestep,
    )
    from mpskit_tpu_torch.symmetry import (
        SU2DMRG2, SU2TDVP, energy_reduced, heisenberg_reduced,
    )

    mpo = heisenberg_reduced(2)
    out = {}
    for dev in ("cuda", "cpu"):
        st = _su2_reduced_start(SU2_SMALL_BOND, 93, dev)
        st, e, _ = find_groundstate(st, mpo, VUMPS(tol=1e-11, maxiter=200))
        es, _ = excitations(mpo, QuasiparticleAnsatz(tol=1e-10), np.pi, st)
        psi = _su2_finite_start(SU2_SMALL_L, 2, 95, dev)
        psi, E, _ = find_groundstate(psi, mpo, SU2DMRG2(tol=1e-12,
                                                        maxiter=8,
                                                        max_mult=4))
        psi = _su2_finite_start(SU2_SMALL_L, 2, 97, dev)
        psi, _, _ = find_groundstate(psi, mpo, SU2DMRG2(
            tol=1e-12, maxiter=1, max_mult=2))
        psi = psi.astype(torch.complex128)
        for k in range(2):
            psi, _ = timestep(psi, mpo, k * 0.05, 0.05, SU2TDVP(dt=0.05))
        spec = psi.schmidt(SU2_SMALL_L // 2)
        out[dev] = (e, float(es[0, 0]), E, energy_reduced(psi, mpo),
                    np.concatenate([spec[k] for k in sorted(spec)]))
    c, h = out["cuda"], out["cpu"]
    for k, name in enumerate(("a: reduced VUMPS energy", "b: reduced gap",
                              "c: DMRG2 energy", "d: TDVP energy")):
        _gate("su2", f"f: card against CPU, {name}", abs(c[k] - h[k]),
              SU2_CARD_TOL)
    # the split's singular vectors may differ in sign between cuSOLVER and
    # LAPACK: the evolved states are compared by their Schmidt values
    _gate("su2", "f: card against CPU, d: middle Schmidt values after the "
          "steps", float(np.abs(c[4] - h[4]).max()), SU2_CARD_TOL)


def phase_su2(E64):
    """Phase 21: the SU(2) family. Returns K1's launches in it (gated 0:
    no SU(2) path runs the kernel)."""
    from mpskit_tpu_torch.kernels import ac_apply as k1

    k1.launches = 0
    legs = {}
    for name, fn, args in (("a", _su2_reduced_vumps, ()),
                           ("b", _su2_haldane, ()),
                           ("c", _su2_finite, (E64,)),
                           ("d", _su2_tdvp, ()),
                           ("e", _su2_dense_projector, ()),
                           ("f", _su2_card_vs_cpu, ())):
        t0 = time.perf_counter()
        fn(*args)
        legs[name] = time.perf_counter() - t0
    launches = k1.launches
    log("[su2] seconds per leg: " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + f"; K1 launches in this "
        f"phase: {launches}")
    if launches != 0:
        raise RuntimeError("phase 21 launched K1: no SU(2) path runs it")
    return launches


def phase_measure():
    """Phase 17: the measurement surface on three ground states with exact
    oracles, and K1 at leg (a)'s shape (w=4) and on its general path."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(37)
    k1_times = {}
    for tag, (D, d, w) in (("w4", (512, 2, 4)), ("general_w13",
                                                  (512, 2, 13))):
        t = _k1_shape_times(D, d, w, gen)
        k1_times[tag] = t
        log(f"[measure] K1 D={D} d={d} w={w}: {t['ms']:.4f} ms per call "
            f"(plain {t['plain_ms']:.4f} ms), {t['graph_ms']:.4f} ms in a "
            f"CUDA graph, max abs err vs plain {t['max_abs_err']:.3e}, "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}): "
            f"{t['bound_ms'] / t['ms']:.1%} of it per call")
    rows = []
    launches = _measure_free_fermions(rows)
    _measure_hubbard(rows)
    _measure_ed_and_fidelity(rows)
    for leg in sorted({r[0] for r in rows}):
        mine = [r for r in rows if r[0] == leg]
        log(f"[measure] {leg}: {sum(r[2] for r in mine):.1f} s and "
            f"{sum(r[3] for r in mine)} host syncs in {len(mine)} measured "
            "calls")
    return launches, k1_times


def main():
    sys.path.insert(0, str(REPO))
    phase_device()
    import torch

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    timed(phase_build)
    k1 = timed(phase_k1)
    psi_dmrg = timed(phase_f64)
    launches = timed(phase_slice)
    psi_vumps = timed(phase_vumps_f64)
    timed(phase_vumps_slice)
    timed(phase_dmrg2_f64)
    E64_dmrg2 = timed(phase_dmrg2_slice)
    timed(phase_bonds, psi_vumps, psi_dmrg)
    timed(phase_tdvp_f64)
    launches_tdvp = timed(phase_tdvp_slice)
    launches_qp = timed(phase_qp_f64) + timed(phase_haldane)
    timed(phase_boundary_f64)
    launches_boundary = timed(phase_boundary)
    launches_measure, k1_more = timed(phase_measure)
    launches_window, k1_window = timed(phase_windows)
    launches_rsdmrg = timed(phase_rsdmrg)
    launches_u1 = timed(phase_symmetric)
    launches_su2 = timed(phase_su2, E64_dmrg2)
    log(json.dumps({"kernels": [{
        "name": "ac_apply_bf16", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "exact_ms": k1["exact_ms"], "launches_tdvp": launches_tdvp,
        "launches_qp": launches_qp,
        "launches_boundary": launches_boundary,
        "launches_measure": launches_measure,
        "w4_ms": k1_more["w4"]["ms"],
        "w4_graph_ms": k1_more["w4"]["graph_ms"],
        "w4_plain_ms": k1_more["w4"]["plain_ms"],
        "w4_max_abs_err": k1_more["w4"]["max_abs_err"],
        "w4_bound_ms": k1_more["w4"]["bound_ms"],
        "general_w13_ms": k1_more["general_w13"]["ms"],
        "general_w13_graph_ms": k1_more["general_w13"]["graph_ms"],
        "general_w13_plain_ms": k1_more["general_w13"]["plain_ms"],
        "general_w13_max_abs_err": k1_more["general_w13"]["max_abs_err"],
        "general_w13_bound_ms": k1_more["general_w13"]["bound_ms"],
        "launches_window": launches_window,
        "window_D256_ms": k1_window["ms"],
        "window_D256_graph_ms": k1_window["graph_ms"],
        "window_D256_plain_ms": k1_window["plain_ms"],
        "window_D256_max_abs_err": k1_window["max_abs_err"],
        "window_D256_bound_ms": k1_window["bound_ms"],
        "launches_rsdmrg": launches_rsdmrg["launches"],
        "launches_rsdmrg_warmup": launches_rsdmrg["warmup"],
        "launches_rsdmrg_rounds": launches_rsdmrg["rounds"],
        "launches_rsdmrg_segments_cold": launches_rsdmrg["segments_cold"],
        "launches_u1": launches_u1, "launches_su2": launches_su2}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
