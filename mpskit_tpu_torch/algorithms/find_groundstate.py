"""`find_groundstate` dispatcher (counterpart of
mpskit_tpu/algorithms/find_groundstate.py: its FiniteMPS, InfiniteMPS,
WindowMPS, LazySum and chained-algorithm branches, with the abelian
symmetric states routed to their sector solvers)."""

from __future__ import annotations

from ..operators.lazysum import LazySum, MultipliedOperator
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.windowmps import WindowMPS
from ..symmetry.charges import (
    SymmetricFiniteMPS, SymmetricInfiniteMPS, find_groundstate_symmetric,
    find_groundstate_symmetric_dmrg2, find_groundstate_symmetric_infinite,
)
from ..symmetry.su2_finite import (
    SU2DMRG, SU2DMRG2, SU2FiniteMPS, find_groundstate_su2_finite_dmrg,
    find_groundstate_su2_finite_dmrg2,
)
from ..symmetry.su2_reduced import (
    ReducedMPO, SU2ReducedState, find_groundstate_su2_reduced,
)
from .dmrg import DMRG, find_groundstate_dmrg, find_groundstate_dmrg_window
from .dmrg2 import DMRG2, find_groundstate_dmrg2
from .grassmann import (
    GradientGrassmann, find_groundstate_grassmann,
    find_groundstate_grassmann_finite,
)
from .idmrg import IDMRG1, IDMRG2, find_groundstate_idmrg1, \
    find_groundstate_idmrg2
from .rsdmrg import RealSpaceParallelDMRG, find_groundstate_rsdmrg
from .unionalg import ChainedAlg
from .vumps import VUMPS, find_groundstate_vumps

_FINITE = ((DMRG, find_groundstate_dmrg), (DMRG2, find_groundstate_dmrg2),
           (GradientGrassmann, find_groundstate_grassmann_finite),
           (RealSpaceParallelDMRG, find_groundstate_rsdmrg))
_INFINITE = ((VUMPS, find_groundstate_vumps),
             (IDMRG1, find_groundstate_idmrg1),
             (IDMRG2, find_groundstate_idmrg2),
             (GradientGrassmann, find_groundstate_grassmann))


def find_groundstate(psi, H, alg=None, envs=None, tol: float = 1e-10,
                     maxiter: int = 100, trscheme=None, verbosity=None):
    """find_groundstate(psi, H[, alg]) -> (psi, envs, epsilon).

    With `alg` None a FiniteMPS runs one-site DMRG, first DMRG2 at
    max(tol, 1e-8) when a `trscheme` is given; an InfiniteMPS runs VUMPS at
    max(tol, 1e-9) and, when VUMPS stops above a tighter tol, refines by
    GradientGrassmann(tol=tol). Otherwise `alg` picks the solver: DMRG,
    DMRG2 or GradientGrassmann for a FiniteMPS, VUMPS, IDMRG1, IDMRG2 or
    GradientGrassmann for an InfiniteMPS, DMRG for a WindowMPS (which
    has no default); a ChainedAlg runs its stages in turn. A
    RealSpaceParallelDMRG runs on a FiniteMPS. A SymmetricFiniteMPS runs
    the sector DMRG (`find_groundstate_symmetric`, DMRG2 its two-site
    form), a SymmetricInfiniteMPS the sector VUMPS. A LazySum is
    materialized by `sum_materialized()`, a MultipliedOperator by
    `eval_at(0.0)`. An SU2ReducedState runs the reduced VUMPS and returns
    (state, e_density, eps); an SU2FiniteMPS runs the reduced DMRG2 /
    DMRG (the generic DMRG and DMRG2 translate) and returns (psi, E, eps);
    both need a ReducedMPO. The anyonic states come with a later slice and
    raise NotImplementedError naming queue-1 item 11b (ROADMAP.md)."""
    if isinstance(H, LazySum):
        # a time-independent sum is materialized eagerly: the summed FSM is
        # one wider MPO, the fastest form for the matvecs
        H = H.sum_materialized()
    elif isinstance(H, MultipliedOperator):
        H = H.eval_at(0.0)
    kw = {} if verbosity is None else {"verbosity": verbosity}
    if isinstance(psi, (SU2ReducedState, SU2FiniteMPS)):
        return _find_groundstate_su2(psi, H, alg, tol, maxiter)
    if isinstance(psi, WindowMPS):
        if not isinstance(alg, (DMRG, ChainedAlg)):
            raise TypeError(f"{type(alg).__name__} does not run on a "
                            "WindowMPS; a window takes DMRG")
    elif isinstance(psi, SymmetricFiniteMPS):
        if isinstance(alg, DMRG2):
            return find_groundstate_symmetric_dmrg2(psi, H, alg)
        if alg is not None and not isinstance(alg, DMRG):
            raise TypeError(f"{type(alg).__name__} does not run on a "
                            "SymmetricFiniteMPS; it takes DMRG or DMRG2")
        return find_groundstate_symmetric(psi, H, alg)
    elif isinstance(psi, SymmetricInfiniteMPS):
        if alg is not None and not isinstance(alg, VUMPS):
            raise TypeError(f"{type(alg).__name__} does not run on a "
                            "SymmetricInfiniteMPS; it takes VUMPS")
        return find_groundstate_symmetric_infinite(psi, H, alg)
    elif not isinstance(psi, (FiniteMPS, InfiniteMPS)):
        raise NotImplementedError(
            f"find_groundstate for {type(psi).__name__} is not ported yet: "
            "anyonic states come with queue-1 item 11b (ROADMAP.md)")
    if isinstance(alg, ChainedAlg):
        envs_out, eps = envs, None
        for stage in alg:
            psi, envs_out, eps = find_groundstate(psi, H, stage)
        return psi, envs_out, eps
    if alg is None and isinstance(psi, FiniteMPS):
        if trscheme is not None:
            psi, _, _ = find_groundstate_dmrg2(
                psi, H, DMRG2(tol=max(tol, 1e-8), maxiter=maxiter,
                              trscheme=trscheme, **kw))
        return find_groundstate_dmrg(
            psi, H, DMRG(tol=tol, maxiter=maxiter, **kw))
    if alg is None:
        vumps_tol = max(tol, 1e-9)
        psi, envs_out, eps = find_groundstate_vumps(
            psi, H, VUMPS(tol=vumps_tol, maxiter=maxiter, **kw))
        if tol < vumps_tol and eps > tol:
            psi, envs_out, eps = find_groundstate_grassmann(
                psi, H, GradientGrassmann(tol=tol, **kw))
        return psi, envs_out, eps
    if isinstance(psi, WindowMPS):
        return find_groundstate_dmrg_window(psi, H, alg)
    table = _FINITE if isinstance(psi, FiniteMPS) else _INFINITE
    for cls, run in table:
        if isinstance(alg, cls):
            return run(psi, H, alg)
    if isinstance(alg, tuple(cls for cls, _ in _FINITE + _INFINITE)):
        raise TypeError(
            f"{type(alg).__name__} does not run on {type(psi).__name__}")
    raise TypeError(type(alg))


def _find_groundstate_su2(psi, H, alg, tol, maxiter):
    """The SU(2)-reduced branches of `find_groundstate`, as in the JAX
    package: the uniform state takes VUMPS, the finite chain DMRG2 then
    DMRG (alg None), SU2DMRG(2), or the generic DMRG / DMRG2 translated."""
    if not isinstance(H, ReducedMPO):
        raise TypeError(
            f"{type(psi).__name__} needs a ReducedMPO, got {type(H)}")
    if isinstance(psi, SU2ReducedState):
        if alg is not None and not isinstance(alg, VUMPS):
            raise TypeError(
                f"uniform SU2ReducedState supports VUMPS, got {type(alg)}; "
                "finite-chain algorithms run on SU2FiniteMPS")
        a = alg or VUMPS(tol=max(tol, 1e-9), maxiter=maxiter)
        return find_groundstate_su2_reduced(
            psi, H, tol=a.tol, maxiter=a.maxiter, krylovdim=a.krylovdim,
            verbosity=getattr(a, "verbosity", 0))
    if alg is None:
        psi, e, eps = find_groundstate_su2_finite_dmrg2(
            psi, H, SU2DMRG2(tol=max(tol, 1e-10), maxiter=maxiter))
        if eps > tol:
            psi, e, eps = find_groundstate_su2_finite_dmrg(
                psi, H, SU2DMRG(tol=tol, maxiter=maxiter))
        return psi, e, eps
    if isinstance(alg, SU2DMRG):
        return find_groundstate_su2_finite_dmrg(psi, H, alg)
    if isinstance(alg, SU2DMRG2):
        return find_groundstate_su2_finite_dmrg2(psi, H, alg)
    if isinstance(alg, DMRG):
        return find_groundstate_su2_finite_dmrg(
            psi, H, SU2DMRG(tol=alg.tol, maxiter=alg.maxiter,
                            krylovdim=alg.krylovdim,
                            verbosity=alg.verbosity))
    if isinstance(alg, DMRG2):
        return find_groundstate_su2_finite_dmrg2(
            psi, H, SU2DMRG2(tol=alg.tol, maxiter=alg.maxiter,
                             krylovdim=alg.krylovdim,
                             verbosity=alg.verbosity))
    raise TypeError(
        f"SU2FiniteMPS supports DMRG/DMRG2 (or SU2DMRG/SU2DMRG2), "
        f"got {type(alg)}")
