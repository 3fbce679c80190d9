"""Algorithms of the PyTorch port: finite one-site DMRG, VUMPS, the
expectation values and the find_groundstate dispatcher."""

from .dmrg import DMRG, find_groundstate_dmrg
from .expval import expectation_value
from .find_groundstate import find_groundstate
from .unionalg import ChainedAlg, UnionAlg
from .vumps import VUMPS, find_groundstate_vumps
