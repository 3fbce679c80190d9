"""Symmetric states of the PyTorch port: the abelian (U(1) / Z_n) static
bond charge labels, conservation masks, sector-constrained solvers,
sector-resolved entanglement spectra and sector-aware bond expansion; and
the SU(2) family (the dense-projector uniform states, the reduced
fusion-tree VUMPS, finite DMRG / DMRG2 / TDVP and quasiparticles); and
the category / anyon family: fusion categories (with and without
multiplicities, braided or not) as host data, anyonic chain MPOs, the
Fibonacci boundary states of the hard-hexagon transfer MPO, masked
anyonic VUMPS and the sector-resolved anyonic DMRG2 / IDMRG2."""

from .charges import (
    DEAD_LABEL,
    SymmetricFiniteMPS,
    SymmetricInfiniteMPS,
    assign_bond_charges,
    charge_masks_finite,
    find_groundstate_symmetric,
    find_groundstate_symmetric_dmrg2,
    find_groundstate_symmetric_infinite,
    flux_masks_finite,
    sector_entanglement_spectrum,
    sector_entanglement_spectrum_infinite,
    uniform_bond_charges_cell,
    uniform_charge_masks,
)
from .expand import (
    changebonds_symmetric,
    expand_symmetric_finite,
    expand_symmetric_infinite,
)
from .su2 import (
    SU2Bond,
    SU2InfiniteMPS,
    find_groundstate_su2_vumps,
)
from .su2_reduced import (
    SU2ReducedState,
    ReducedMPO,
    heisenberg_reduced,
    bilinear_biquadratic_reduced,
    find_groundstate_su2_reduced,
    schmidt_spectrum_reduced,
)
from .su2_reduced_qp import (
    ReducedQP,
    excitations_su2_reduced,
)
from .su2_finite import (
    SU2FiniteMPS,
    SU2DMRG,
    SU2DMRG2,
    SU2TDVP,
    find_groundstate_su2_finite_dmrg,
    find_groundstate_su2_finite_dmrg2,
    expand_bond_reduced,
    timestep_su2_finite_tdvp,
    energy_reduced,
)
from .fibonacci import (
    FibonacciInfiniteMPS,
    leading_boundary_fibonacci,
    anyonic_entropy,
    fibonacci_bond_labels,
)
from .category import (
    FusionCategory,
    BraidedCategory,
    fibonacci_category,
    ising_category,
    zn_category,
    fibonacci_braided,
    ising_braided,
    zn_braided,
    su2k_category,
    su2k_braided,
    bond_labels,
    chain_masks,
    chain_bond_labels,
    quantum_schmidt,
    quantum_entropy,
)
from .anyonic import (
    AnyonicInfiniteMPS,
    find_groundstate_anyonic,
)
from .anyonic_finite import (
    AnyonicFiniteMPS,
    find_groundstate_anyonic_dmrg2,
    find_groundstate_anyonic_idmrg2,
    anyon_bond_labels_finite,
    anyon_masks_finite,
    anyon_theta_mask,
    anyon_split,
)
from .multiplicity import (
    MultiplicityCategory,
    BraidedMultiplicityCategory,
    lift_braided,
    rep_category,
    rep_s3,
    rep_a4,
)
