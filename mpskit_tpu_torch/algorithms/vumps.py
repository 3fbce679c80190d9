"""VUMPS ground-state search for infinite MPS (counterpart of
mpskit_tpu/algorithms/vumps.py).

The JAX package runs one iteration as one jit-compiled function and the
per-site AC and C eigensolves as a `vmap` over the unit cell. Here the
iteration is a sequence of host-driven steps: the environments
(`hamiltonian_environments`, GMRES with host exits), a loop over the sites
for the local solves (`eigsh_smallest` with its host exits; each site gets
what the vmapped solve gives it), and the regauge, one batched QR/LQ over
the cell. The site solves use the exact `ac_apply`: the JAX package passes
no inexact `matvec_fast` here, so kernel K1 does not run on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import Defaults, VERBOSE_ITER, VERBOSE_WARN, matmul_precision
from ..environments.finite import stack_W
from ..environments.infinite_ham import hamiltonian_environments
from ..linalg.lanczos import eigsh_smallest
from ..parallel.replicated import is_sharded
from ..states.gauging import regauge_ACC, regauge_CAC
from ..states.infinitemps import InfiniteMPS
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog, logger
from ..utils.sync import to_host
from ..utils.trace import span
from .derivatives import ac_apply, ac_operands, c_apply, c_operands
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class VUMPS(Chainable):
    """VUMPS parameters (same fields and defaults as
    mpskit_tpu.algorithms.vumps.VUMPS).

    device_batch is kept for signature parity and changes nothing: the JAX
    package batches that many iterations into one dispatch of its remote
    TPU, checking convergence once per batch. The port runs and checks the
    iterations one by one, and `maxiter` counts iterations."""

    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 4
    gauge_tol: float = Defaults.tolgauge
    verbosity: int = Defaults.verbosity
    finalize: Optional[Callable] = None
    device_batch: int = 1


def _solve_acs(envs, Ws, ACs, m: int, restarts: int, inner_tol: float,
               split=None, sites=None):
    """Smallest eigenvector of each site's AC effective Hamiltonian,
    started from the current AC. Returns (ACs', converged flags). With a
    `parallel.split.BondSplit` the matvecs run split over "bond"; `sites`
    (default all) are the sites to solve."""
    out, conv = [], []
    for i in range(ACs.shape[0]) if sites is None else sites:
        GL, W, GR = envs.GLs[i], Ws[i], envs.GRs[i]
        if split is not None:
            GR = split.local(GR)
        ops = ac_operands(GL, W, GR) if split is None else None
        res = eigsh_smallest(
            (lambda x: ac_apply(GL, W, GR, x, prepared=ops)) if split is None
            else (lambda x: split.ac_apply(GL, W, GR, x)), ACs[i], m,
            restarts, inner_tol, reorth="local1")
        out.append(res.eigenvector)
        conv.append(res.converged)
    return torch.stack(out), conv


def _solve_cs(envs, Cs, m: int, restarts: int, inner_tol: float,
              split=None, sites=None):
    """The same for each bond's C: bond i uses (GLs[i+1], GRs[i])."""
    L = Cs.shape[0]
    out, conv = [], []
    for i in range(L) if sites is None else sites:
        GL, GR = envs.GLs[(i + 1) % L], envs.GRs[i]
        if split is not None:
            GR = split.local(GR)
        ops = c_operands(GL, GR) if split is None else None
        res = eigsh_smallest(
            (lambda x: c_apply(GL, GR, x, prepared=ops)) if split is None
            else (lambda x: split.c_apply(GL, GR, x)), Cs[i], m, restarts,
            inner_tol, reorth="local1")
        out.append(res.eigenvector)
        conv.append(res.converged)
    return torch.stack(out), conv


def _regauge(ACs, Cs, A_mask=None, C_mask=None):
    """The new state from the solved ACs and Cs: AL_i = argmin |AC_i -
    AL C_i| and AR_i = argmin |AC_i - C_{i-1} AR| by QRpos/LQpos (no
    uniform-gauging loop: AL and AR stay exact isometries), and the
    convergence measure eps = max_i |AC_i - AL_i C_i| (a 0-dim tensor).
    Optional masks enforce charge-sector structure after the solves."""
    L = ACs.shape[0]
    if A_mask is not None:
        ACs = ACs * A_mask.to(ACs.dtype)
        ACs = ACs / torch.linalg.vector_norm(
            ACs.reshape(L, -1), dim=1)[:, None, None, None]
        Cs = Cs * C_mask.to(Cs.dtype)
        Cs = Cs / torch.linalg.vector_norm(Cs.reshape(L, -1),
                                           dim=1)[:, None, None]
    ALs = regauge_ACC(ACs, Cs)
    if A_mask is not None:
        ALs = ALs * A_mask.to(ALs.dtype)
    ALC = torch.einsum("ilpm,imr->ilpr", ALs, Cs)
    eps = torch.linalg.vector_norm((ACs - ALC).reshape(L, -1), dim=1).max()
    ARs = regauge_CAC(torch.roll(Cs, 1, dims=0), ACs)
    if A_mask is not None:
        Am, Cm = A_mask.to(ACs.dtype), C_mask.to(Cs.dtype)
        return InfiniteMPS(ALs * Am, ARs * Am, ACs * Am, Cs * Cm), eps
    return InfiniteMPS(ALs, ARs, ACs, Cs), eps


def _vumps_iteration_impl(psi: InfiniteMPS, H, m: int, restarts: int,
                          gauge_tol: float, env_tol_static: float,
                          inner_tol=1e-6, A_mask=None, C_mask=None,
                          env_guess=None, split=None, site=None):
    """One VUMPS iteration: returns (psi', eps, envs, diag), eps a 0-dim
    tensor and diag the host pair (# unconverged local solves, worst
    environment-GMRES relative residual). `env_guess` (the previous
    iteration's environments) warm-starts the geometric-series solves.
    Run it inside `config.matmul_precision()`.

    On a mesh psi stays whole: `split` (a `parallel.split.BondSplit`) runs
    the environment walk and the local solves split over "bond", and with
    `site` (a `MeshAxis` over "site") each site rank solves its own block
    of the unit cell and the solutions are all-gathered."""
    with span("iteration", "vumps"):
        envs = hamiltonian_environments(psi, H, tol=env_tol_static,
                                        env_init=env_guess, split=split)
        Ws = stack_W(H, psi.period, psi.dtype, psi.device)
        sites = None if site is None else site.block(psi.period, "sites")
        ACs, conv_ac = _solve_acs(envs, Ws, psi.AC, m, restarts, inner_tol,
                                  split, sites)
        Cs, conv_c = _solve_cs(envs, psi.C, m, restarts, inner_tol, split,
                               sites)
        n_unconv = sum(not c for c in conv_ac + conv_c)
        if site is not None:
            ACs, Cs = site.gather(ACs, 0), site.gather(Cs, 0)
            n_unconv = int(to_host(site.all_reduce(torch.tensor(
                float(n_unconv), dtype=torch.float64,
                device=psi.device)))[0])
        diag = (n_unconv, envs.resid)
        psi_new, eps = _regauge(ACs, Cs, A_mask, C_mask)
        return psi_new, eps, envs, diag


def find_groundstate_vumps(psi: InfiniteMPS, H, alg: VUMPS = VUMPS()):
    """Run VUMPS. Returns (psi, envs, eps). A sharded state
    (`parallel.mesh`) runs the same iterations on its whole tensors with
    the products split over the mesh (`parallel.sharded.InfiniteShards`),
    and comes back in its placements, the environments sharded over
    "bond"."""
    shards = split = site = None
    if is_sharded(psi.AL):
        from ..parallel.sharded import InfiniteShards
        shards = InfiniteShards(psi)
        split, site = shards.split, shards.site
        psi = shards.whole(psi)
    name = "VUMPS" if shards is None else "VUMPS(mesh)"
    log = IterLog(name, alg.verbosity)
    eps = 1.0
    it = 0
    env_guess = None
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            psi, eps_dev, env_guess, diag = _vumps_iteration_impl(
                psi, H, alg.krylovdim, alg.eig_maxrestarts, alg.gauge_tol,
                1e-12, inner_tol, env_guess=env_guess, split=split, site=site)
            if alg.finalize is not None:
                if shards is None:
                    psi = alg.finalize(it, psi, H) or psi
                else:
                    new = alg.finalize(it, shards.state(psi), H)
                    psi = psi if new is None else shards.whole(new)
            eps = to_host(eps_dev)[0]
            log.solver_warn(it, diag, inner_tol)
            if diag[1] > 1e-6 and alg.verbosity >= VERBOSE_WARN:
                logger.warning(
                    "%s: iteration %d: environment GMRES residual %.4e "
                    "(geometric-series solve not converged)", name, it,
                    diag[1])
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(it, 0.0, eps)

        # the iterations regauge locally (AL C = C AR holds only to eps):
        # re-canonicalize once, so the returned state is an exactly
        # consistent mixed-gauge triple
        psi = InfiniteMPS.from_AL(psi.AL, psi.C[psi.period - 1],
                                  tol=alg.gauge_tol)
        envs = hamiltonian_environments(psi, H, env_init=env_guess,
                                        split=split)
    if shards is not None:
        return shards.state(psi), shards.envs(envs), eps
    return psi, envs, eps
