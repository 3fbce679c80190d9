"""mpskit_tpu_torch: the PyTorch / CUDA port of mpskit_tpu for an NVIDIA
H100.

Slice 0 covers finite one-site DMRG on MPO Hamiltonians: the substrate
(config, tensor ops, Lanczos), MPOs and models, FiniteMPS, environments,
the effective-Hamiltonian matvecs with the bf16 kernel K1, DMRG and the
finite expectation value. Slice 1 redesigned K1 for Hopper. Slice 4 adds
the infinite ground states: GMRES and Arnoldi, uniform gauging and
InfiniteMPS, the infinite environments, VUMPS, the infinite expectation
values and the InfiniteMPS and chained branches of find_groundstate.
Slice 5 adds two-site DMRG, IDMRG1/2 and bond-dimension management: the
truncated SVD and its schemes, null spaces, `changebonds` with SvdCut,
RandExpand, OptimalExpand and VUMPSSvdCut, and the entanglement spectrum
and entropy. Slice 6 adds time evolution in native complex64/complex128:
the Krylov exponentials, one-site TDVP on finite and infinite states,
TDVP2, the WI/WII/TaylorCluster evolution MPOs as DenseMPOs, their
application to finite states and time_evolve. Slice 7 adds
GradientGrassmann (finite and infinite, and the default refinement of an
infinite find_groundstate), the quasiparticle states, their environments
and gauge conversions, the QuasiparticleAnsatz excitations (finite,
infinite and the momentum dispersion) and FiniteExcited. Slice 8 adds the
statmech boundaries and fitting: the exact host Ritz solve of the dominant
Arnoldi pair, the small spectra and the fixed-point uniqueness check, the
classical transfer MPOs, the DenseMPO channel environments and
expectation value, `leading_boundary` (VUMPS_Boundary, VOMPS,
GradientGrassmann, MPOHamiltonian rows, MPSMultiline / MPOMultiline), the
boundary excitations, the multi-row and MPO branches of `changebonds`, and
`approximate` (FitDMRG, FitDMRG2, FitIDMRG, FitIDMRG2). Slice 9 adds the
measurements and the remaining models: transfer spectra and correlation
lengths, the energy variance and the Galerkin residual, entropy profiles,
finite and infinite local, string, ranged and DenseMPO expectation values,
two-point and string correlators, exact diagonalization, periodic
boundary conditions, the fidelity susceptibility (on a conjugate-gradient
solve), the rest of the MPOHamiltonian algebra (`from_fsm`, `-`, `@`,
`repeat`, `conj`, `remove_orphans`, `add_physical_charge`), the spin and
fermion models, and `FiniteMPS.from_dense`, `+` and `*`. Slice 10 adds
windows, lazy sums and projections: WindowMPS (from_infinite, grow,
shrink, boundary environments), the Window, LazySum, MultipliedOperator
(TimedOperator, UntimedOperator), ProjectionOperator and
LinearCombination operators with their branches of find_groundstate
(window DMRG), timestep (frozen and co-evolving window TDVP, time-dependent
sums at the midpoint), expectation_value, variance and the entanglement
spectrum, the per-summand LazySum environments, dynamical DMRG
(`propagator` with NaiveInvert and Jeckelmann), thermal purifications,
`save_state` / `load_state` in the JAX package's .npz layout, and
PeriodicArray. Slice 11 adds segment-parallel DMRG (RealSpaceParallelDMRG,
its segments a host loop), parameter scans of VUMPS ground states, the
reference-name compatibility surface (`compat.py`), the plotting data,
and the abelian (U(1) / Z_n) symmetric states of `symmetry/`: bond charge
labels and masks, SymmetricFiniteMPS and SymmetricInfiniteMPS, the sector
DMRG, DMRG2 and VUMPS, sector entanglement spectra, sector-aware bond
expansion, and the symmetric branches of timestep, excitations (sector=),
transfer_spectrum (sector=) and the checkpoints. Slice 12 adds the SU(2)
family; slice 13 the category / anyon family of `symmetry/` (fusion
categories with and without multiplicities, anyonic chain MPOs, the
Fibonacci hard-hexagon boundary, masked anyonic VUMPS and the
sector-resolved anyonic DMRG2 / IDMRG2) with the sector-masked boundary
and environment paths. Slice 14 adds the device mesh (`parallel/`,
MeshConfig): bond-sharded one-site DMRG, VUMPS (the unit cell optionally
over the mesh's site axis) and finite TDVP on local shards with explicit
`torch.distributed` collectives, RS-DMRG's segments over the site axis,
and every other entry point replicated under a mesh. The package imports
torch and never jax; the JAX package stays the reference the tests hold
it to."""

from . import config, models
from .config import Defaults, MeshConfig
from .algorithms import (
    DMRG, DMRG2, IDMRG1, IDMRG2, TDVP, TDVP2, VOMPS, VUMPS, WI, WII,
    ChainedAlg, DynamicalDMRG, RealSpaceParallelDMRG, ScanResult, UnionAlg, FiniteExcited, FitDMRG, FitDMRG2, FitIDMRG, FitIDMRG2,
    GradientGrassmann, Jeckelmann, NaiveInvert, OptimalExpand,
    QuasiparticleAnsatz, RandExpand, SvdCut, TaylorCluster,
    VUMPS_Boundary, VUMPSSvdCut, approximate, calc_galerkin, changebonds,
    correlation_length, correlator, entanglement_spectrum, entropy,
    entropy_profile, exact_diagonalization, excitations,
    excitations_boundary, excitations_boundary_multiline, expectation_value,
    fidelity_susceptibility, find_groundstate, find_groundstate_dmrg,
    find_groundstate_dmrg2, find_groundstate_dmrg_window,
    find_groundstate_grassmann, find_groundstate_idmrg1,
    find_groundstate_idmrg2, find_groundstate_vumps, infinite_temperature,
    leading_boundary, lift_densempo, lift_hamiltonian, make_time_mpo,
    marek_gap, periodic_boundary_conditions,
    periodic_boundary_conditions_densempo, propagator, purification_mps,
    scan_groundstate_vumps, stack_hamiltonians, string_correlator,
    thermal_expectation, thermal_state, time_evolve, timestep,
    transfer_spectrum, variance,
)
from .environments.lazysum_env import (
    MultipleEnvironments, lazysum_ac_apply, lazysum_c_apply,
    lazysum_environments,
)
from .linalg.arnoldi import dominant_eigs
from .linalg.expm import expm_multiply
from .linalg.gmres import linsolve, linsolve_cg
from .linalg.lanczos import eigsh_smallest, lanczos_groundstate
from .models import (
    bilinear_biquadratic_model, bose_hubbard, free_fermions, heisenberg_XXX,
    heisenberg_XXZ, heisenberg_XYZ, hubbard, hubbard_model, j1_j2_model,
    kitaev_bdg_energy, kitaev_chain, quantum_clock, quantum_potts,
    transverse_field_ising,
    transverse_field_ising_lattice, transverse_field_ising_parity,
    xx_chain_with_field, xy_model,
)
from .models.statmech import (
    classical_ising, finite_classical_ising, hard_hexagon, sixvertex,
)
from .operators.apply import apply_densempo_finite, apply_densempo_infinite
from .operators.mpo import DenseMPO, MPOHamiltonian, mpo_to_mps, mps_to_mpo
from .operators.lazysum import (
    LazySum, MultipliedOperator, TimedOperator, UntimedOperator,
)
from .operators.multiline import MPOMultiline
from .operators.projection import LinearCombination, ProjectionOperator
from .operators.window import Window
from .states.finitemps import FiniteMPS
from .states.infinitemps import InfiniteMPS
from .states.multiline import MPSMultiline
from .states.windowmps import WindowMPS
from .states.qp_gauge import (
    finite_left_to_right_gauge, finite_right_to_left_gauge,
    left_to_right_gauge, right_to_left_gauge,
)
from .states.quasiparticle import (
    FiniteQP, FiniteQPRight, LeftGaugedQP, RightGaugedQP, qp_to_finitemps,
)
from .tensors.ops import (
    TruncationScheme, isometry, leftnull, leftorth, lq_pos, notrunc, qr_pos,
    rightnull, rightorth, svd_truncated, truncbelow, truncdim, truncerr,
)
from .utils.periodic import PeriodicArray, PeriodicVector
from .utils.plotting import (
    entanglement_plot, entanglement_plot_data, transfer_plot,
    transfer_plot_data,
)
from .utils.serialize import load_state, save_state

# the reference-name surface; `environments` (the function) is bound after
# the subpackage of the same name was imported, as in the JAX package
from . import compat
from .compat import (
    MPOTensor, MPSBondTensor, MPSTensor, TransferMatrix, add_util_leg,
    effective_excitation_hamiltonian, environments, left_virtualspace,
    leftenv, max_Ds, physicalspace, right_virtualspace, rightenv,
    transfer_left, transfer_right, uniform_leftorth, uniform_rightorth,
)

entanglementplot = entanglement_plot
transferplot = transfer_plot

# abelian symmetry (charge-sector states)
from . import symmetry
from .symmetry import (
    SymmetricFiniteMPS, SymmetricInfiniteMPS, find_groundstate_symmetric,
    find_groundstate_symmetric_infinite, sector_entanglement_spectrum,
)

# the reference's sparse FSM container is MPOHamiltonian's dense stacked
# FSM; QP is the union of the quasiparticle containers, for isinstance()
SparseMPO = MPOHamiltonian
QP = (LeftGaugedQP, RightGaugedQP, FiniteQP, FiniteQPRight)

__version__ = "0.1.0"
