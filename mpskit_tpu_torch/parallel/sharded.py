"""The drivers that run on a sharded state: one-site DMRG, VUMPS and the
finite one-site TDVP step over a DeviceMesh (the paths of the JAX
package's tests/test_sharding.py).

A sharded state holds DTensors (`parallel.mesh`); these drivers work on
their local shards with the split products of `parallel.split`:

- DMRG and TDVP keep the stacks of a finite chain (ALs, ARs and the left
  and right environments) as this rank's columns of the bond axis, so a
  rank holds 1/bond of them; the center tensor, the environment carried
  through the sweep and the Krylov vectors are whole on every rank. The
  float32 first-restart probe runs kernel K1 on the gathered, contiguous
  environment, as the unsharded sweep does.
- VUMPS holds the state and its environments whole; the environment walk
  and the local solves run split over "bond", and with the unit cell
  sharded over "site" each "site" rank solves its own sites' AC and C and
  the solutions are all-gathered.

The outputs carry the input's placements. The sweeps follow the unsharded
ones (`algorithms.dmrg._dmrg_sweep_impl`, `algorithms.tdvp._timestep_finite`,
`algorithms.vumps._vumps_iteration_impl`) step for step.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..algorithms.derivatives import ac_apply_fast
from ..algorithms.dmrg import (
    DMRG, _galerkin_left, _galerkin_right, bulk_rank_flags,
)
from ..algorithms.vumps import VUMPS, _regauge
from ..config import VERBOSE_ITER, VERBOSE_WARN, matmul_precision
from ..environments.finite import (
    FiniteEnv, left_boundary, right_boundary, stack_W,
)
from ..environments.infinite_ham import InfiniteHamEnv, \
    hamiltonian_environments
from ..linalg.expm import expm_multiply_err
from ..linalg.lanczos import eigsh_smallest
from ..states.finitemps import FiniteMPS, support_mask
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import (
    leftorth, leftorth_hybrid, orth_in, rightorth, rightorth_hybrid,
)
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog, logger
from ..utils.sync import to_host
from .split import BondSplit, MeshAxis

def shard_like(x, mesh, placements):
    """A whole tensor, identical on every rank, as a DTensor with these
    placements: each rank keeps its chunk, no data moves."""
    local = x
    for dim, p in enumerate(placements):
        if p.is_shard():
            ax = p.dim % x.dim()
            local = local.chunk(mesh.size(dim), dim=ax)[
                mesh.get_local_rank(dim)]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def _from_local(local, mesh, like=None):
    """This rank's columns of a bond-sharded stack as a DTensor, in the
    placements of `like` (a DTensor of the caller) if given."""
    n = mesh.size(mesh.mesh_dim_names.index("bond"))
    shape = local.shape[:-1] + (local.shape[-1] * n,)
    local = local.contiguous()
    out = DTensor.from_local(
        local, mesh, [Replicate(), Shard(local.dim() - 1)], run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())
    if like is not None and tuple(like.placements) != tuple(out.placements):
        out = out.redistribute(mesh, like.placements)
    return out


def _local(x, mesh):
    """This rank's columns of a DTensor's last axis, whatever its
    placements."""
    placements = [Replicate(), Shard(x.dim() - 1)]
    return x.redistribute(mesh, placements).to_local()


# ----------------------------------------------------------------------------
# finite chains: environments, the DMRG sweep, the TDVP step
# ----------------------------------------------------------------------------

def right_envs(sp: BondSplit, ARs, Ws):
    """compute_right_envs on this rank's columns: ARs (L, D, d, D/b) ->
    GRs (L+1, w, D, D/b)."""
    L, D = ARs.shape[0], ARs.shape[1]
    w = Ws.shape[1]
    GR = sp.local(right_boundary(w, D, ARs.dtype, ARs.device))
    GRs = ARs.new_empty((L + 1,) + tuple(GR.shape))
    GRs[L] = GR
    for i in range(L - 1, -1, -1):
        GR = sp.push_right(GR, Ws[i], sp.gather(ARs[i], -1))
        GRs[i] = GR
    return GRs


def left_envs(sp: BondSplit, ALs, Ws):
    """compute_left_envs on this rank's columns: ALs (L, D, d, D/b) ->
    GLs (L+1, w, D, D/b)."""
    L, D = ALs.shape[0], ALs.shape[1]
    GL = left_boundary(Ws.shape[1], D, ALs.dtype, ALs.device)
    GLs = ALs.new_empty((L + 1,) + tuple(sp.local(GL).shape))
    GLs[0] = sp.local(GL)
    for i in range(L):
        GL = sp.push_left(GL, Ws[i], sp.gather(ALs[i], -1))
        GLs[i + 1] = sp.local(GL)
    return GLs


def _site_matvecs(sp: BondSplit, GL, W, GR):
    """The split site matvec and the first-restart probe that
    `ac_apply_fast` is in the unsharded sweep: kernel K1 for a float32
    tensor on the card, on GR gathered once per site when the probe runs;
    elsewhere the exact matvec."""
    def mv(x):
        return sp.ac_apply(GL, W, GR, x)

    if not (GL.is_cuda and GL.dtype == torch.float32):
        return mv, mv
    whole = []

    def fast(x):
        if not whole:
            whole.append(sp.gather(GR, -1).contiguous())
        return ac_apply_fast(GL, W, whole[0], x)

    return mv, fast


def dmrg_sweep(sp: BondSplit, ALs, ARs, AC, Ws, GRs, inner_tol: float,
               m: int, restarts: int, masks=None, bulk_flags=None,
               reorth: str = "local1", cheap_galerkin: bool = False):
    """`_dmrg_sweep_impl` with ALs, ARs (L, D, d, D/b) and GRs
    (L+1, w, D, D/b) this rank's columns, updated in place; AC is whole.
    Returns the same tuple."""
    L, D = ALs.shape[0], ALs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    if masks is None:
        maskf = torch.ones((L, 1, 1, 1), dtype=dtype, device=device)
    else:
        maskf = masks.to(dtype)
    if bulk_flags is None:
        bulkL = bulkR = np.zeros(L, bool)
    else:
        bulkL, bulkR = bulk_flags

    eps_dev = []
    lams, resids, convs = [], [], []

    def solve(GL, W, GR, AC, i):
        mv, fast = _site_matvecs(sp, GL, W, GR)
        res = eigsh_smallest(mv, AC, m, restarts, inner_tol, reorth=reorth,
                             matvec_fast=fast)
        lams.append(res.eigenvalue)
        resids.append(res.residual)
        convs.append(res.converged)
        ACp = res.eigenvector * maskf[i]
        return ACp / torch.clamp(torch.linalg.vector_norm(ACp), min=1e-30), mv

    # ---- left-to-right: solve sites 0..L-2 ----
    GLs = ALs.new_empty((L, w, D, sp.width))
    GL = left_boundary(w, D, dtype, device)
    for i in range(L - 1):
        GLs[i] = sp.local(GL)
        W = Ws[i]
        ACp, mv = solve(GL, W, GRs[i + 1], AC, i)
        AL, C = orth_in(leftorth_hybrid, ACp, None, bool(bulkL[i]))
        AL = AL * maskf[i]
        if not cheap_galerkin:
            eps_dev.append(_galerkin_left(AL, mv(ACp)))
        GL = sp.push_left(GL, W, AL)
        AC = sp.gather(torch.einsum("lm,mpr->lpr", C, ARs[i + 1]), -1)
        ALs[i] = sp.local(AL)
    GLs[L - 1] = sp.local(GL)

    # ---- right-to-left: solve sites L-1..1 ----
    GR = sp.local(right_boundary(w, D, dtype, device))
    for i in range(L - 1, 0, -1):
        GRs[i + 1] = GR
        W, GL = Ws[i], sp.gather(GLs[i], -1)
        ACp, mv = solve(GL, W, GR, AC, i)
        C, AR = orth_in(rightorth_hybrid, ACp, None, bool(bulkR[i]))
        AR = AR * maskf[i]
        if not cheap_galerkin:
            eps_dev.append(_galerkin_right(AR, mv(ACp)))
        GR = sp.push_right(GR, W, AR)
        AC = sp.all_reduce(torch.einsum("lpm,mr->lpr", ALs[i - 1],
                                        C[sp.sl]))
        ARs[i] = sp.local(AR)
    GRs[1] = GR
    GRs[0] = GR

    lam = lams[-1]
    eps = max(to_host(*eps_dev)) if eps_dev else max(resids)
    diag = (sum(not c for c in convs), max(resids))
    return ALs, ARs, AC, GRs, lam, eps, diag


def _finite_locals(psi: FiniteMPS, sp: BondSplit, mesh):
    """(ALs, ARs) as this rank's columns and AC whole, at center 0."""
    if psi.center != 0:
        whole = FiniteMPS(psi.ALs.full_tensor(), psi.ARs.full_tensor(),
                          psi.AC.full_tensor(), psi.center).move_center(0)
        return (sp.local(whole.ALs).clone(), sp.local(whole.ARs).clone(),
                whole.AC)
    return (_local(psi.ALs, mesh).clone(), _local(psi.ARs, mesh).clone(),
            psi.AC.full_tensor())


def _finite_out(psi: FiniteMPS, mesh, ALs, ARs, AC):
    """The state in the placements of the input `psi`."""
    return FiniteMPS(_from_local(ALs, mesh, psi.ALs),
                     _from_local(ARs, mesh, psi.ARs),
                     shard_like(AC, mesh, psi.AC.placements), 0)


def find_groundstate_dmrg_sharded(psi: FiniteMPS, H, alg: DMRG = DMRG()):
    """`find_groundstate_dmrg` on a bond-sharded FiniteMPS. Returns (psi,
    envs, epsilon): psi in the input's placements, the environment stacks
    as DTensors sharded over "bond" on their last axis."""
    mesh = psi.AC.device_mesh
    L, D, d = psi.length, psi.D, psi.physicaldim
    sp = BondSplit(mesh, D)
    ALs, ARs, AC = _finite_locals(psi, sp, mesh)
    dtype, device = AC.dtype, AC.device
    masks = torch.as_tensor(support_mask(L, d, D), device=device)
    bulk_flags = bulk_rank_flags(L, d, D) if alg.fast_qr else None
    log = IterLog("DMRG(mesh)", alg.verbosity)
    log.init()
    eps, lam, it = 1.0, 0.0, 0
    out = psi
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        GRs = right_envs(sp, ARs, Ws)
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            ALs, ARs, AC, GRs, lam, eps, diag = dmrg_sweep(
                sp, ALs, ARs, AC, Ws, GRs, inner_tol, alg.krylovdim,
                alg.eig_maxrestarts, masks=masks, bulk_flags=bulk_flags,
                reorth=alg.reorth, cheap_galerkin=alg.cheap_galerkin)
            out = _finite_out(psi, mesh, ALs, ARs, AC)
            if alg.finalize is not None:
                # copies, as in the unsharded driver: `out` shares the
                # working stacks, and the hook's caller may keep it
                new = alg.finalize(it, out, H)
                if new is None or new is out:
                    ALs, ARs, AC = ALs.clone(), ARs.clone(), AC.clone()
                else:
                    out = new
                    ALs, ARs, AC = _finite_locals(out, sp, mesh)
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(it, lam, eps)
        GLs = left_envs(sp, ALs, Ws)
    return out, FiniteEnv(_from_local(GLs, mesh), _from_local(GRs, mesh)), eps


def timestep_finite(sp: BondSplit, ALs, ARs, AC, Ws, GRs, m: int, dt,
                    masks=None):
    """`_timestep_finite` with ALs, ARs (L, D, d, D/b) and GRs
    (L+1, w, D, D/b) this rank's columns; AC is whole. Returns (ALs, ARs,
    AC, GRs, exp_err) in the same layout (the inputs are not written)."""
    L, D = ALs.shape[0], ALs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    tau = -1j * (dt / 2)
    mk = None if masks is None else masks.to(device=device, dtype=dtype)
    errs = []

    ALs_new = torch.empty_like(ALs)
    GL = left_boundary(w, D, dtype, device)
    GLs = ALs.new_empty((L, w, D, sp.width))
    for i in range(L):
        GLs[i] = sp.local(GL)
        W, GR = Ws[i], GRs[i + 1]
        AC, errA = expm_multiply_err(lambda x: sp.ac_apply(GL, W, GR, x),
                                     AC, tau, m)
        if mk is not None:
            AC = AC * mk[i]
        AL, C = orth_in(leftorth, AC, None)
        if mk is not None:
            AL = AL * mk[i]
        GL = sp.push_left(GL, W, AL)
        ALs_new[i] = sp.local(AL)
        if i == L - 1:
            AC = torch.einsum("lpm,mr->lpr", AL, C)
            errs.append(errA)
        else:
            C, errC = expm_multiply_err(lambda x: sp.c_apply(GL, GR, x), C,
                                        -tau, m)
            AC = sp.gather(torch.einsum("lm,mpr->lpr", C, ARs[i + 1]), -1)
            errs.append(max(errA, errC))

    ARs_new = ARs.clone()
    GRs_new = torch.empty_like(GRs)
    GR = sp.local(right_boundary(w, D, dtype, device))
    for i in range(L - 1, -1, -1):
        GRs_new[i + 1] = GR
        GLi, W = sp.gather(GLs[i], -1), Ws[i]
        AC, errA = expm_multiply_err(lambda x: sp.ac_apply(GLi, W, GR, x),
                                     AC, tau, m)
        if mk is not None:
            AC = AC * mk[i]
        C, AR = orth_in(rightorth, AC, None)
        if mk is not None:
            AR = AR * mk[i]
        GR = sp.push_right(GR, W, AR)
        if i == 0:
            AC = torch.einsum("lm,mpr->lpr", C, AR)
            errs.append(errA)
        else:
            ARs_new[i] = sp.local(AR)
            C, errC = expm_multiply_err(lambda x: sp.c_apply(GLi, GR, x), C,
                                        -tau, m)
            AC = sp.all_reduce(torch.einsum("lpm,mr->lpr", ALs_new[i - 1],
                                            C[sp.sl]))
            errs.append(max(errA, errC))
    GRs_new[0] = GRs_new[1]
    return ALs_new, ARs_new, AC, GRs_new, max(errs)


def timestep_finite_sharded(psi: FiniteMPS, H, dt, alg):
    """One TDVP step of a bond-sharded complex FiniteMPS under an
    MPOHamiltonian, with the support masks of the unsharded step. Returns
    (psi, exp_err), psi in the input's placements."""
    mesh = psi.AC.device_mesh
    L, D, d = psi.length, psi.D, psi.physicaldim
    sp = BondSplit(mesh, D)
    ALs, ARs, AC = _finite_locals(psi, sp, mesh)
    dtype, device = AC.dtype, AC.device
    smask = torch.as_tensor(support_mask(L, d, D), device=device)
    mk = smask.to(dtype)
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        ALs, ARs, AC = ALs * sp.local(mk), ARs * sp.local(mk), AC * mk[0]
        GRs = right_envs(sp, ARs, Ws)
        ALs, ARs, AC, _, exp_err = timestep_finite(
            sp, ALs, ARs, AC, Ws, GRs, alg.expalg_m, dt, masks=smask)
    return _finite_out(psi, mesh, ALs, ARs, AC), exp_err


# ----------------------------------------------------------------------------
# VUMPS
# ----------------------------------------------------------------------------

def _solve_sites(sites, make_mv, x0s, m, restarts, inner_tol):
    out, conv = [], []
    for i in sites:
        res = eigsh_smallest(make_mv(i), x0s[i], m, restarts, inner_tol,
                             reorth="local1")
        out.append(res.eigenvector)
        conv.append(res.converged)
    return torch.stack(out), conv


def vumps_iteration(sp: BondSplit, site, psi: InfiniteMPS, H, m: int,
                    restarts: int, env_tol: float, inner_tol=1e-6,
                    env_guess=None):
    """`_vumps_iteration_impl` with the products split over "bond" and, if
    `site` (a MeshAxis over "site") is given, each site rank solving its
    own sites of the unit cell. psi whole in and out; returns (psi', eps,
    envs, diag)."""
    L = psi.period
    envs = hamiltonian_environments(psi, H, tol=env_tol, env_init=env_guess,
                                    split=sp)
    Ws = stack_W(H, L, psi.dtype, psi.device)
    sites = range(L) if site is None else site.block(L, "sites")

    def ac_mv(i):
        GL, W, GR = envs.GLs[i], Ws[i], sp.local(envs.GRs[i])
        return lambda x: sp.ac_apply(GL, W, GR, x)

    def c_mv(i):
        GL, GR = envs.GLs[(i + 1) % L], sp.local(envs.GRs[i])
        return lambda x: sp.c_apply(GL, GR, x)

    ACs, conv_ac = _solve_sites(sites, ac_mv, psi.AC, m, restarts, inner_tol)
    Cs, conv_c = _solve_sites(sites, c_mv, psi.C, m, restarts, inner_tol)
    n_unconv = sum(not c for c in conv_ac + conv_c)
    if site is not None:
        ACs, Cs = site.gather(ACs, 0), site.gather(Cs, 0)
        n_unconv = int(to_host(site.all_reduce(torch.tensor(
            float(n_unconv), dtype=torch.float64, device=psi.device)))[0])
    psi_new, eps = _regauge(ACs, Cs)
    return psi_new, eps, envs, (n_unconv, envs.resid)


def _whole_infinite(psi):
    return InfiniteMPS(*(getattr(psi, f).full_tensor()
                         for f in ("AL", "AR", "AC", "C")))


def _infinite_out(psi_in, mesh, psi):
    return InfiniteMPS(*(shard_like(getattr(psi, f), mesh,
                                    getattr(psi_in, f).placements)
                         for f in ("AL", "AR", "AC", "C")))


def _infinite_envs_out(envs: InfiniteHamEnv, mesh):
    """The environment stacks as DTensors sharded over "bond" on their
    last axis."""
    placements = (Replicate(), Shard(envs.GLs.dim() - 1))
    return InfiniteHamEnv(shard_like(envs.GLs, mesh, placements),
                          shard_like(envs.GRs, mesh, placements),
                          envs.e_density, envs.resid)


def find_groundstate_vumps_sharded(psi: InfiniteMPS, H,
                                   alg: VUMPS = VUMPS()):
    """`find_groundstate_vumps` on a sharded InfiniteMPS (bond axes over
    "bond", the unit cell over "site" if its placements say so). Returns
    (psi, envs, eps), psi in the input's placements."""
    mesh = psi.AL.device_mesh
    site = (MeshAxis(mesh, "site") if psi.AL.placements[0].is_shard()
            else None)
    sp = BondSplit(mesh, psi.D)
    psi_in, psi = psi, _whole_infinite(psi)
    log = IterLog("VUMPS(mesh)", alg.verbosity)
    eps, it, env_guess = 1.0, 0, None
    with matmul_precision():
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            psi, eps_dev, env_guess, diag = vumps_iteration(
                sp, site, psi, H, alg.krylovdim, alg.eig_maxrestarts, 1e-12,
                inner_tol, env_guess=env_guess)
            if alg.finalize is not None:
                out = alg.finalize(it, _infinite_out(psi_in, mesh, psi), H)
                psi = psi if out is None else _whole_infinite(out)
            eps = to_host(eps_dev)[0]
            log.solver_warn(it, diag, inner_tol)
            if diag[1] > 1e-6 and alg.verbosity >= VERBOSE_WARN:
                logger.warning(
                    "VUMPS(mesh): iteration %d: environment GMRES residual "
                    "%.4e (geometric-series solve not converged)", it,
                    diag[1])
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(it, 0.0, eps)
        psi = InfiniteMPS.from_AL(psi.AL, psi.C[psi.period - 1],
                                  tol=alg.gauge_tol)
        envs = hamiltonian_environments(psi, H, env_init=env_guess, split=sp)
    return (_infinite_out(psi_in, mesh, psi), _infinite_envs_out(envs, mesh),
            eps)
