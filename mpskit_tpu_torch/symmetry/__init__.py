"""Symmetric states of the PyTorch port: the abelian (U(1) / Z_n) static
bond charge labels, conservation masks, sector-constrained solvers,
sector-resolved entanglement spectra and sector-aware bond expansion; and
the SU(2) family (the dense-projector uniform states, the reduced
fusion-tree VUMPS, finite DMRG / DMRG2 / TDVP and quasiparticles). The
category / anyon backends of the JAX package come with a later slice
(ROADMAP.md, queue-1 item 11b)."""

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
