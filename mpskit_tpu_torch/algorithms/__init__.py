"""Algorithms of the PyTorch port: finite one- and two-site DMRG, VUMPS,
IDMRG, bond-dimension management, the expectation values, the
entanglement toolbox and the find_groundstate dispatcher."""

from .changebonds import (
    OptimalExpand, RandExpand, SvdCut, VUMPSSvdCut, changebonds,
)
from .dmrg import DMRG, find_groundstate_dmrg
from .dmrg2 import DMRG2, find_groundstate_dmrg2
from .expval import expectation_value
from .find_groundstate import find_groundstate
from .idmrg import IDMRG1, IDMRG2, find_groundstate_idmrg1, \
    find_groundstate_idmrg2
from .toolbox import entanglement_spectrum, entropy
from .unionalg import ChainedAlg, UnionAlg
from .vumps import VUMPS, find_groundstate_vumps
