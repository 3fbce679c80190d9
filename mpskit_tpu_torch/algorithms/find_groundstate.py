"""`find_groundstate` dispatcher (counterpart of
mpskit_tpu/algorithms/find_groundstate.py: its FiniteMPS -> DMRG,
InfiniteMPS -> VUMPS and chained-algorithm branches)."""

from __future__ import annotations

from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from .dmrg import DMRG, find_groundstate_dmrg
from .unionalg import ChainedAlg
from .vumps import VUMPS, find_groundstate_vumps


def find_groundstate(psi, H, alg=None, envs=None, tol: float = 1e-10,
                     maxiter: int = 100, trscheme=None, verbosity=None):
    """find_groundstate(psi, H[, alg]) -> (psi, envs, epsilon).

    A FiniteMPS runs one-site DMRG (`alg` None or a DMRG). An InfiniteMPS
    runs VUMPS: with `alg` None at max(tol, 1e-9), where the JAX package
    refines a tighter tol by GradientGrassmann. A ChainedAlg runs its
    stages in turn. The other branches of the JAX dispatcher come with
    later slices of the port and raise NotImplementedError naming theirs
    (ROADMAP.md, queue 1)."""
    kw = {} if verbosity is None else {"verbosity": verbosity}
    if isinstance(alg, ChainedAlg):
        envs_out, eps = envs, None
        for stage in alg:
            psi, envs_out, eps = find_groundstate(psi, H, stage)
        return psi, envs_out, eps
    if isinstance(psi, InfiniteMPS):
        if alg is None:
            vumps_tol = max(tol, 1e-9)
            psi, envs_out, eps = find_groundstate_vumps(
                psi, H, VUMPS(tol=vumps_tol, maxiter=maxiter, **kw))
            if tol < vumps_tol and eps > tol:
                raise NotImplementedError(
                    f"find_groundstate: VUMPS stopped at eps={eps:.3e} above "
                    f"tol={tol:.1e}; the GradientGrassmann refinement that "
                    "follows comes with queue-1 item 9 (ROADMAP.md). Pass "
                    "tol >= 1e-9 or an explicit VUMPS")
            return psi, envs_out, eps
        if isinstance(alg, VUMPS):
            return find_groundstate_vumps(psi, H, alg)
        raise NotImplementedError(
            f"find_groundstate for InfiniteMPS with {type(alg).__name__} is "
            "not ported yet: IDMRG comes with queue-1 slice 6, "
            "GradientGrassmann with item 9 (ROADMAP.md)")
    if not isinstance(psi, FiniteMPS):
        raise NotImplementedError(
            f"find_groundstate for {type(psi).__name__} is not ported yet: "
            "windows and symmetric states come with later slices "
            "(ROADMAP.md)")
    if trscheme is not None:
        raise NotImplementedError(
            "find_groundstate with trscheme runs DMRG2, which comes with "
            "queue-1 slice 6 (ROADMAP.md)")
    if alg is None:
        alg = DMRG(tol=tol, maxiter=maxiter, **kw)
    if not isinstance(alg, DMRG):
        raise NotImplementedError(
            f"find_groundstate with {type(alg).__name__} is not ported yet: "
            "DMRG2 comes with queue-1 slice 6 (ROADMAP.md)")
    return find_groundstate_dmrg(psi, H, alg)
