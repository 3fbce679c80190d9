"""`find_groundstate` dispatcher (counterpart of
mpskit_tpu/algorithms/find_groundstate.py, its FiniteMPS -> DMRG branch)."""

from __future__ import annotations

from ..states.finitemps import FiniteMPS
from .dmrg import DMRG, find_groundstate_dmrg


def find_groundstate(psi, H, alg=None, envs=None, tol: float = 1e-10,
                     maxiter: int = 100, trscheme=None, verbosity=None):
    """find_groundstate(psi, H[, alg]) -> (psi, envs, epsilon).

    A FiniteMPS runs one-site DMRG (`alg` None or a DMRG). The other
    branches of the JAX dispatcher come with later slices of the port and
    raise NotImplementedError naming theirs (ROADMAP.md, queue 1)."""
    del envs  # accepted for signature parity; DMRG builds its own
    if not isinstance(psi, FiniteMPS):
        raise NotImplementedError(
            f"find_groundstate for {type(psi).__name__} is not ported yet: "
            "infinite states (VUMPS, IDMRG, GradientGrassmann) come with "
            "queue-1 slice 4, windows and symmetric states later "
            "(ROADMAP.md)")
    if trscheme is not None:
        raise NotImplementedError(
            "find_groundstate with trscheme runs DMRG2, which comes with "
            "queue-1 slice 6 (ROADMAP.md)")
    if alg is None:
        kw = {} if verbosity is None else {"verbosity": verbosity}
        alg = DMRG(tol=tol, maxiter=maxiter, **kw)
    if not isinstance(alg, DMRG):
        raise NotImplementedError(
            f"find_groundstate with {type(alg).__name__} is not ported yet: "
            "DMRG2 comes with queue-1 slice 6, chained algorithms with "
            "slice 5 (ROADMAP.md)")
    return find_groundstate_dmrg(psi, H, alg)
