"""models of the PyTorch port (see mpskit_tpu/models)."""

from .fermions import free_fermions, hubbard, kitaev_bdg_energy, kitaev_chain
from .hamiltonians import (
    bilinear_biquadratic_model, bose_hubbard, heisenberg_XXX, heisenberg_XXZ,
    heisenberg_XYZ, quantum_clock, quantum_potts, transverse_field_ising,
    transverse_field_ising_lattice, transverse_field_ising_parity,
    xx_chain_with_field, xy_model,
)
from .lattices import hubbard_model, j1_j2_model
from .spins import pauli, spinmatrices
from .statmech import (
    classical_ising, finite_classical_ising, hard_hexagon,
    hard_hexagon_fibonacci, sixvertex,
)
from .anyons import (
    anyon_chain, anyon_chain_finite, golden_chain, ising_anyon_chain,
    rsos_chain,
)
