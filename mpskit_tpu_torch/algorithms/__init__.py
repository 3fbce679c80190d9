"""Algorithms of the PyTorch port on the finite DMRG slice."""

from .dmrg import DMRG, find_groundstate_dmrg
from .expval import expectation_value
from .find_groundstate import find_groundstate
