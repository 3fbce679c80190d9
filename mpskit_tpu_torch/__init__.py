"""mpskit_tpu_torch: the PyTorch / CUDA port of mpskit_tpu for an NVIDIA
H100.

Slice 0 covers finite one-site DMRG on MPO Hamiltonians: the substrate
(config, tensor ops, Lanczos), MPOs and models, FiniteMPS, environments,
the effective-Hamiltonian matvecs with the bf16 kernel K1, DMRG and the
finite expectation value. The package imports torch and never jax; the
JAX package stays the reference the tests hold it to."""

from .algorithms import (
    DMRG, expectation_value, find_groundstate, find_groundstate_dmrg,
)
from .models.hamiltonians import (
    heisenberg_XXX, transverse_field_ising, transverse_field_ising_lattice,
)
from .operators.mpo import MPOHamiltonian
from .states.finitemps import FiniteMPS
