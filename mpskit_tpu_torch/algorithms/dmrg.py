"""One-site DMRG (counterpart of mpskit_tpu/algorithms/dmrg.py).

The JAX package runs a sweep as one jit-compiled function of two
`lax.scan`s. Here the scans are host loops over the sites, the site
eigensolves are `linalg.lanczos.eigsh_smallest` with its host-side exits,
and the tensor and environment stacks are updated in place where the JAX
package donates its buffers."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Defaults, VERBOSE_ITER, matmul_precision
from ..environments.finite import (
    FiniteEnv, compute_left_envs, compute_right_envs, left_boundary,
    right_boundary, stack_W,
)
from ..linalg.lanczos import eigsh_smallest
from ..parallel.replicated import is_sharded
from ..states.finitemps import FiniteMPS, physical_bond_dims, support_mask
from ..states.windowmps import WindowMPS
from ..tensors.ops import leftorth_hybrid, orth_in, rightorth_hybrid
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from ..utils.sync import to_host
from ..utils.trace import span
from .derivatives import ac_apply, ac_apply_fast
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class DMRG(Chainable):
    """One-site DMRG parameters (same fields and defaults as
    mpskit_tpu.algorithms.dmrg.DMRG).

    fast_qr: CholeskyQR2 for the gauge moves at full-rank bulk sites.
    reorth: Lanczos reorthogonalization, "local1", "local" or "full".
    cheap_galerkin: report the Lanczos Ritz-residual bound (>= the Galerkin
    residual) as the per-site residual, saving one exact matvec per site."""

    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 10
    verbosity: int = Defaults.verbosity
    finalize: Optional[Callable] = None
    fast_qr: Optional[bool] = None
    reorth: str = "local1"
    cheap_galerkin: bool = False


def bulk_rank_flags(L: int, d: int, D: int):
    """(bulkL, bulkR) host boolean arrays: site i's left/right
    orthogonalization panel has full rank D (safe for CholeskyQR2)."""
    dims = physical_bond_dims(L, d, D)
    bulkL = np.array([(dims[i] * d >= D) and (dims[i + 1] == D)
                      for i in range(L)])
    bulkR = np.array([(dims[i] == D) and (dims[i + 1] * d >= D)
                      for i in range(L)])
    return bulkL, bulkR


def _galerkin_left(AL, y):
    """||(1 - AL AL^dag) y|| after a left-orthogonal split."""
    z = torch.einsum("lpm,lpr->mr", AL.conj(), y)
    return torch.linalg.vector_norm(y - torch.einsum("lpm,mr->lpr", AL, z))


def _galerkin_right(AR, y):
    z = torch.einsum("mpr,lpr->lm", AR.conj(), y)
    return torch.linalg.vector_norm(y - torch.einsum("lm,mpr->lpr", z, AR))


def _solve_site(GL, W, GR, AC, m, restarts, inner_tol, reorth, mask=None,
                split=None):
    """The site eigensolve. With a charge mask the solve itself runs in the
    sector: the matvec is x -> m * H(m * x) (the fast probe too) and the
    start vector m * AC. Masking only the eigenvector lets the Krylov space
    pick up rounding outside the sector and converge to a lower foreign
    sector (ROADMAP.md, F6). Without a mask the path is unchanged. With a
    `parallel.split.BondSplit` (GR this rank's columns, no charge mask) the
    matvec and the probe are the split's."""
    if split is not None:
        mv, fast = split.site_matvecs(GL, W, GR)
        return eigsh_smallest(mv, AC, m, restarts, inner_tol, reorth=reorth,
                              matvec_fast=fast)
    if mask is None:
        return eigsh_smallest(
            lambda x: ac_apply(GL, W, GR, x), AC, m, restarts, inner_tol,
            reorth=reorth,
            matvec_fast=lambda x: ac_apply_fast(GL, W, GR, x))
    return eigsh_smallest(
        lambda x: mask * ac_apply(GL, W, GR, mask * x), mask * AC, m,
        restarts, inner_tol, reorth=reorth,
        matvec_fast=lambda x: mask * ac_apply_fast(GL, W, GR, mask * x))


def _dmrg_sweep_impl(ALs, ARs, AC, Ws, GRs, inner_tol: float, m: int,
                     restarts: int, GL0=None, GRL=None, masks=None,
                     bulk_flags=None, reorth: str = "local1",
                     cheap_galerkin: bool = False, split_dtype=None,
                     sector_solve: bool = False, split=None):
    """One full DMRG sweep (L2R over sites 0..L-2, R2L over L-1..1),
    starting and ending with center = 0.

    ALs, ARs and GRs are updated IN PLACE (where the JAX package donates
    them) and returned, with the new center tensor, the eigenvalue at site
    1 (the last solved), the largest per-site residual and the solver
    diagnostics (n_unconverged, worst_residual). GL0/GRL override the
    open-chain boundary environments; masks is the (L, D, d, D) support
    (or charge) mask, bulk_flags the host (bulkL, bulkR) of
    `bulk_rank_flags`. sector_solve (with charge masks) runs each site
    solve inside the mask (`_solve_site`); the support masks of the plain
    and RS-DMRG sweeps only mask the result.

    split_dtype: the dtype of the gauge moves' QR / LQ (default the
    state's). A charge mask leaves rank-deficient blocks in an arbitrary
    order, and a float32 Householder QR of them gives Q columns whose
    off-mask part carries up to 2e-2 of the tensor, which masking Q then
    drops (a float32 U(1) sweep of the XX chain at D=128 rose 0.1 in
    energy from sweep to sweep; 9e-3 above its sector's energy at D=512
    on the card); in float64 the loss is 1e-12.

    split: a `parallel.split.BondSplit` runs the sweep on a bond-sharded
    chain. ALs, ARs and GRs are then this rank's columns, AC, the masks
    and the boundaries (GL0, GRL) whole; the products are the split's, and
    the environment carried through each half sweep is whole (left) or
    this rank's columns (right)."""
    with span("sweep"):
        L, D = ALs.shape[0], ALs.shape[1]
        w = Ws.shape[1]
        dtype, device = AC.dtype, AC.device
        if GL0 is None:
            GL0 = left_boundary(w, D, dtype, device)
        if GRL is None:
            GRL = right_boundary(w, D, dtype, device)
        if split is not None:
            GRL = split.local(GRL)
        if masks is None:
            maskf = torch.ones((L, 1, 1, 1), dtype=dtype, device=device)
        else:
            maskf = masks.to(dtype)
        if bulk_flags is None:
            bulkL = bulkR = np.zeros(L, bool)
        else:
            bulkL, bulkR = bulk_flags

        eps_dev = []  # exact Galerkin residuals, read once at the end
        lams, resids, convs = [], [], []

        # ---- left-to-right: solve sites 0..L-2 ----
        # the left stack has the right one's shape (split: its columns)
        GLs = torch.empty((L,) + tuple(GRs.shape[1:]), dtype=dtype,
                          device=device)
        GL = GL0
        for i in range(L - 1):
            GLs[i] = GL if split is None else split.local(GL)
            W, GR = Ws[i], GRs[i + 1]
            res = _solve_site(GL, W, GR, AC, m, restarts, inner_tol, reorth,
                              maskf[i] if sector_solve else None, split)
            ACp = res.eigenvector * maskf[i]
            ACp = ACp / torch.clamp(torch.linalg.vector_norm(ACp), min=1e-30)
            AL, C = orth_in(leftorth_hybrid, ACp, split_dtype, bool(bulkL[i]))
            AL = AL * maskf[i]
            if split is None:
                if not cheap_galerkin:
                    eps_dev.append(_galerkin_left(
                        AL, ac_apply(GL, W, GR, ACp)))
                GL = transfer_left_mpo(GL, W, AL, AL)
                AC = torch.einsum("lm,mpr->lpr", C, ARs[i + 1])
                ALs[i] = AL
            else:
                if not cheap_galerkin:
                    eps_dev.append(_galerkin_left(
                        AL, split.ac_apply(GL, W, GR, ACp)))
                GL = split.push_left(GL, W, AL)
                AC = split.gather(
                    torch.einsum("lm,mpr->lpr", C, ARs[i + 1]), -1)
                ALs[i] = split.local(AL)
            lams.append(res.eigenvalue)
            resids.append(res.residual)
            convs.append(res.converged)
        GLs[L - 1] = GL if split is None else split.local(GL)

        # ---- right-to-left: solve sites L-1..1 ----
        GR = GRL
        for i in range(L - 1, 0, -1):
            GRs[i + 1] = GR
            W = Ws[i]
            GL = GLs[i] if split is None else split.gather(GLs[i], -1)
            res = _solve_site(GL, W, GR, AC, m, restarts, inner_tol, reorth,
                              maskf[i] if sector_solve else None, split)
            ACp = res.eigenvector * maskf[i]
            ACp = ACp / torch.clamp(torch.linalg.vector_norm(ACp), min=1e-30)
            C, AR = orth_in(rightorth_hybrid, ACp, split_dtype, bool(bulkR[i]))
            AR = AR * maskf[i]
            if split is None:
                if not cheap_galerkin:
                    eps_dev.append(_galerkin_right(
                        AR, ac_apply(GL, W, GR, ACp)))
                GR = transfer_right_mpo(GR, W, AR, AR)
                AC = torch.einsum("lpm,mr->lpr", ALs[i - 1], C)
                ARs[i] = AR
            else:
                if not cheap_galerkin:
                    eps_dev.append(_galerkin_right(
                        AR, split.ac_apply(GL, W, GR, ACp)))
                GR = split.push_right(GR, W, AR)
                AC = split.all_reduce(
                    torch.einsum("lpm,mr->lpr", ALs[i - 1], C[split.sl]))
                ARs[i] = split.local(AR)
            lams.append(res.eigenvalue)
            resids.append(res.residual)
            convs.append(res.converged)
        # fresh right envs for the next sweep: GRs[1] = final carry; GRs[0] is
        # unused and holds the same (as in the JAX package)
        GRs[1] = GR
        GRs[0] = GR

        lam = lams[-1]  # eigenvalue at site 1 (last solved)
        eps = max(to_host(*eps_dev)) if eps_dev else max(resids)
        diag = (sum(not c for c in convs), max(resids))
        return ALs, ARs, AC, GRs, lam, eps, diag


def find_groundstate_dmrg_window(psi, H, alg: DMRG = DMRG()):
    """One-site DMRG on the window of a WindowMPS, with the infinite sides'
    fixed points as boundary environments. Returns (psi, None, epsilon).
    The window's bond dimension holds the infinite states' at every bond,
    so the sweep runs without support masks. `finalize(it, psi, H)` is
    called with the WindowMPS after every sweep (the JAX package's window
    DMRG does not call it)."""
    win = psi.window.move_center(0)
    L = win.length
    log = IterLog("DMRG(window)", alg.verbosity)
    ALs, ARs, AC = win.ALs.clone(), win.ARs.clone(), win.AC.clone()
    eps = 1.0
    with matmul_precision():
        Ws = stack_W(H, L, win.dtype, win.device)
        GL0, GRL = psi.boundary_envs(H)
        GRs = compute_right_envs(ARs, Ws, GRL)
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            ALs, ARs, AC, GRs, lam, eps, diag = _dmrg_sweep_impl(
                ALs, ARs, AC, Ws, GRs, inner_tol, alg.krylovdim,
                alg.eig_maxrestarts, GL0=GL0, GRL=GRL, reorth=alg.reorth,
                cheap_galerkin=alg.cheap_galerkin)
            if alg.finalize is not None:
                out = WindowMPS(psi.left_gs, FiniteMPS(ALs, ARs, AC, 0),
                                psi.right_gs)
                out = alg.finalize(it, out, H) or out
                w = out.window.move_center(0)
                ALs, ARs, AC = w.ALs.clone(), w.ARs.clone(), w.AC.clone()
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            if eps < alg.tol:
                break
    return WindowMPS(psi.left_gs, FiniteMPS(ALs, ARs, AC, 0),
                     psi.right_gs), None, eps


def find_groundstate_dmrg(psi: FiniteMPS, H, alg: DMRG = DMRG()):
    """Run one-site DMRG. Returns (psi, envs, epsilon); a WindowMPS goes to
    `find_groundstate_dmrg_window`. A bond-sharded state (`parallel.mesh`)
    runs the same sweeps on this rank's columns of its stacks
    (`parallel.sharded.FiniteShards`) and comes back in its placements,
    the environments as DTensors sharded over "bond"."""
    if isinstance(psi, WindowMPS):
        return find_groundstate_dmrg_window(psi, H, alg)
    L, D, d = psi.length, psi.D, psi.physicaldim
    dtype, device = psi.dtype, psi.device
    shards = split = None
    if is_sharded(psi.AC):
        from ..parallel.sharded import FiniteShards
        shards = FiniteShards(psi)
        split = shards.split
    else:
        psi = psi.move_center(0)
    Ws = stack_W(H, L, dtype, device)
    w = Ws.shape[1]
    masks = torch.as_tensor(support_mask(L, d, D), device=device)
    bulk_flags = bulk_rank_flags(L, d, D) if alg.fast_qr else None

    log = IterLog("DMRG" if shards is None else "DMRG(mesh)", alg.verbosity)
    log.init()

    def copies(psi):
        # the sweep updates its tensor arguments in place; the caller's psi
        # (and any state a finalize hook returns) must stay valid
        if shards is None:
            return psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
        return shards.locals(psi)

    ALs, ARs, AC = copies(psi)
    eps = 1.0
    lam = 0.0
    it = 0
    with matmul_precision():
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device),
                                 split=split)
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            ALs, ARs, AC, GRs, lam, eps, diag = _dmrg_sweep_impl(
                ALs, ARs, AC, Ws, GRs, inner_tol, alg.krylovdim,
                alg.eig_maxrestarts, masks=masks, bulk_flags=bulk_flags,
                reorth=alg.reorth, cheap_galerkin=alg.cheap_galerkin,
                split=split)
            psi = (FiniteMPS(ALs, ARs, AC, 0) if shards is None
                   else shards.state(ALs, ARs, AC))
            if alg.finalize is not None:
                new = alg.finalize(it, psi, H)
                if new is None or new is psi:
                    # psi shares the working stacks
                    ALs, ARs, AC = ALs.clone(), ARs.clone(), AC.clone()
                else:
                    psi = new
                    ALs, ARs, AC = copies(psi)
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(it, lam, eps)
        GLs = compute_left_envs(ALs, Ws, left_boundary(w, D, dtype, device),
                                split=split)
    if shards is not None:
        return psi, shards.envs(GLs, GRs), eps
    return psi, FiniteEnv(GLs, GRs), eps
