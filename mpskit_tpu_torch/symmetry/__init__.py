"""Abelian (U(1) / Z_n) symmetric states of the PyTorch port: static bond
charge labels, conservation masks, the sector-constrained solvers, the
sector-resolved entanglement spectra and the sector-aware bond expansion.
The SU(2) and anyonic backends of the JAX package come with later slices
(ROADMAP.md, queue-1 item 11)."""

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
