"""Algorithms of the PyTorch port: finite one- and two-site DMRG, VUMPS,
IDMRG, GradientGrassmann, bond-dimension management, the expectation
values, the entanglement toolbox, the find_groundstate dispatcher, time
evolution (TDVP, TDVP2, the evolution MPOs and time_evolve), the
excitations (QuasiparticleAnsatz and FiniteExcited), the statmech
boundaries (leading_boundary with VUMPS_Boundary, VOMPS or
GradientGrassmann), the fitting of `approximate`, and the measurements:
correlators, transfer spectra, variance, exact diagonalization, periodic
boundary conditions and the fidelity susceptibility; window DMRG and
TDVP, dynamical DMRG (`propagator`) and thermal purifications;
segment-parallel DMRG (RealSpaceParallelDMRG) and parameter scans of
VUMPS ground states.

Under a device mesh (`parallel/`), one-site DMRG, VUMPS and the finite
TDVP step run on a sharded state's shards; the entry points wrapped at
the end of this file gather a sharded state once and run replicated."""

from .approximate import FitDMRG, FitDMRG2, FitIDMRG, FitIDMRG2, approximate

from .changebonds import (
    OptimalExpand, RandExpand, SvdCut, VUMPSSvdCut, changebonds,
)
from .dmrg import DMRG, find_groundstate_dmrg, find_groundstate_dmrg_window
from .dmrg2 import DMRG2, find_groundstate_dmrg2
from .dmrgexcitation import FiniteExcited, excitations_dmrg
from .excitations import (
    QuasiparticleAnsatz, excitations, excitations_finite,
    excitations_infinite, excitations_infinite_batched,
)
from .correlators import correlator, string_correlator
from .expval import expectation_value, infinite_temperature
from .find_groundstate import find_groundstate
from .grassmann import (
    GradientGrassmann, find_groundstate_grassmann,
    find_groundstate_grassmann_finite,
)
from .excitations_statmech import (
    excitations_boundary, excitations_boundary_multiline,
)
from .idmrg import IDMRG1, IDMRG2, find_groundstate_idmrg1, \
    find_groundstate_idmrg2
from .paramscan import (
    ScanResult, scan_groundstate_vumps, stack_hamiltonians, stack_states,
    unstack_states,
)
from .propagator import DynamicalDMRG, Jeckelmann, NaiveInvert, propagator
from .rsdmrg import RealSpaceParallelDMRG, find_groundstate_rsdmrg
from .statmech import VOMPS, VUMPS_Boundary, leading_boundary
from .tdvp import TDVP, TDVP2, timestep
from .time_evolve import time_evolve
from .thermal import (
    lift_densempo, lift_hamiltonian, purification_mps, thermal_expectation,
    thermal_state,
)
from .timeevmpo import WI, WII, TaylorCluster, make_time_mpo
from .toolbox import (
    calc_galerkin, correlation_length, entanglement_spectrum, entropy,
    entropy_profile, exact_diagonalization, fidelity_susceptibility,
    marek_gap, periodic_boundary_conditions,
    periodic_boundary_conditions_densempo, transfer_spectrum, variance,
)
from .unionalg import ChainedAlg, UnionAlg
from .vumps import VUMPS, find_groundstate_vumps

# the entry points that run replicated under a mesh: a sharded argument is
# gathered once at entry and the result handed back in its placements
from ..parallel.replicated import replicated_under_mesh as _replicated

(approximate, calc_galerkin, changebonds, correlation_length, correlator,
 entanglement_spectrum, entropy, entropy_profile, excitations,
 excitations_boundary, excitations_boundary_multiline, expectation_value,
 fidelity_susceptibility, find_groundstate_dmrg2, find_groundstate_grassmann,
 find_groundstate_idmrg1, find_groundstate_idmrg2, find_groundstate_rsdmrg,
 leading_boundary, marek_gap, propagator, string_correlator, time_evolve,
 transfer_spectrum, variance) = map(
    _replicated,
    (approximate, calc_galerkin, changebonds, correlation_length, correlator,
     entanglement_spectrum, entropy, entropy_profile, excitations,
     excitations_boundary, excitations_boundary_multiline,
     expectation_value, fidelity_susceptibility, find_groundstate_dmrg2,
     find_groundstate_grassmann, find_groundstate_idmrg1,
     find_groundstate_idmrg2, find_groundstate_rsdmrg, leading_boundary,
     marek_gap, propagator, string_correlator, time_evolve,
     transfer_spectrum, variance))
