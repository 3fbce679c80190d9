"""time_evolve (counterpart of mpskit_tpu/algorithms/time_evolve.py):
iterate `timestep` over a time span, or evolve by applying a
`make_time_mpo` evolution operator and re-compressing (the W^I/W^II
method)."""

from __future__ import annotations

from typing import Sequence

from ..operators.apply import apply_densempo_finite
from ..states.finitemps import FiniteMPS
from .tdvp import TDVP, TDVP2, timestep
from .timeevmpo import TaylorCluster, WII, make_time_mpo


def time_evolve(psi, H, t_span: Sequence[float], alg=None, envs=None,
                verbosity: int = 0):
    """Evolve psi through the times in t_span (pairwise steps). Returns
    (psi, envs): an InfiniteMPS's environments warm-start its first step
    when given and come back from its last."""
    if alg is None:
        alg = TDVP()
    t_span = list(t_span)
    out_envs = envs
    for t0, t1 in zip(t_span[:-1], t_span[1:]):
        dt = t1 - t0
        if isinstance(alg, (TDVP, TDVP2)):
            psi, out_envs = timestep(psi, H, t0, dt, alg, envs=out_envs)
        elif isinstance(alg, (WII, TaylorCluster)):
            if not isinstance(psi, FiniteMPS):
                raise TypeError("MPO evolution targets finite states, got "
                                f"{type(psi).__name__}")
            U = make_time_mpo(H, dt, alg)
            psi = apply_densempo_finite(U, psi).normalize()
        else:
            raise TypeError(type(alg))
    return psi, out_envs
