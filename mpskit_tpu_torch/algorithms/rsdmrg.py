"""Real-space (segment-parallel) DMRG (counterpart of
mpskit_tpu/algorithms/rsdmrg.py).

The chain is split into `nseg` contiguous segments that run one-site DMRG
mini-sweeps with frozen outer environments (block-Jacobi in real space,
Stoudenmire & White, PRB 87, 155137 (2013)). One round:

1. capture: a left-to-right QR scan over the right-canonical state gives
   fresh left isometries and the bond matrix C(b) at every bond;
2. global environments: GL at every segment start (from the fresh
   isometries) and the GR stack (from the old ARs);
3. every segment k sweeps its sites with the boundary environments
   GL[a_k] and GR[b_k + 1] and the initial center C(a_k) AR(a_k);
4. stitch: the updated segments are spliced back, the stale interface
   bond matrix divided out of each later segment's center by a
   Tikhonov-regularized right-solve;
5. re-canonicalization back to center 0 (a masked reverse LQ scan).

The JAX package vmaps the segments (one core each on a mesh); here they
are a host loop over the port's `_dmrg_sweep_impl` / `_dmrg2_sweep_impl`,
which is the same computation in sequence. The segment sweeps keep the
first-restart probe (kernel K1 for a float32 state on the card): the JAX
package turns it off only because under vmap its `lax.cond` would run
both branches.

With `mesh=` (a DeviceMesh of `parallel.mesh.make_mesh`) the segment axis
is sharded over the mesh's "site" axis, as the JAX package shards its
vmapped axis: each rank sweeps its own nseg / site segments, the updated
segments and their solver figures are all-gathered over "site", and the
capture, stitch and re-canonicalization run replicated on every rank. The
ranks of one "site" coordinate (its "bond" axis) sweep the same segments.
The result is the unsharded round's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Defaults, VERBOSE_ITER, matmul_precision
from ..environments.finite import (
    compute_left_envs, compute_right_envs, finite_environments,
    left_boundary, right_boundary, stack_W,
)
from ..states.finitemps import FiniteMPS, physical_bond_dims, support_mask
from ..tensors.ops import TruncationScheme, leftorth, notrunc, rightorth
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from .dmrg import _dmrg_sweep_impl
from .dmrg2 import _dmrg2_sweep_impl, bond_support_vectors
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class RealSpaceParallelDMRG(Chainable):
    """Segment-parallel one-site DMRG (same fields and defaults as
    mpskit_tpu.algorithms.rsdmrg.RealSpaceParallelDMRG).

    nseg: number of chain segments (must divide L).
    warmup: serial sweeps before the parallel rounds.
    rcond: Tikhonov scale of the interface right-solve; None picks 1e-6
        for float64, and for float32 1e-5 with a float64 stitch, 3e-4
        without.
    two_site: two-site mini-sweeps inside every segment (RS-DMRG2, with
        `trscheme`); convergence is then energy stationarity.
    finalize: called as finalize(iter, psi, H) after every round; may
        return a replacement state.
    stitch_f64: run the capture, stitch and re-canonicalization passes in
        float64 (complex128) for a single-precision state. None (auto)
        turns it on for every float32 / complex64 state: the JAX package
        enables it on the CPU only, because its TPU emulates float64, and
        measured ~1e-2 energy drift over ~10 float32 rounds without it."""

    nseg: int = 4
    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 4
    warmup: int = 2
    verbosity: int = Defaults.verbosity
    reorth: str = "local1"
    rcond: Optional[float] = None
    two_site: bool = False
    trscheme: TruncationScheme = dataclasses.field(default_factory=notrunc)
    finalize: Optional[object] = None
    stitch_f64: Optional[bool] = None


def _bond_support_masks(L, d, D):
    """(L, D, D) boolean masks of the supported block of the bond matrix
    right of each site."""
    dims = physical_bond_dims(L, d, D)
    m = np.zeros((L, D, D), bool)
    for i in range(L):
        m[i, : dims[i + 1], : dims[i + 1]] = True
    return m


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _sanitize(x, rel=None):
    """Zero the entries below rel * max|x| (default: machine epsilon).

    The interface right-solve and the bond-matrix products leave entries
    across the whole exponent range (down to 1e-21 at D=512 float32, as
    the JAX package measured); Householder column norms of such columns
    underflow and the 'orthogonal' factor comes out far from orthogonal.
    Entries below eps * max are matmul rounding noise, so zeroing them
    before every QR / LQ of the capture and re-canonicalization loses
    nothing."""
    if rel is None:
        rel = torch.finfo(x.dtype).eps
    m = x.abs().max()
    return torch.where(x.abs() > rel * m, x, torch.zeros_like(x))


def _floored(A, bump, left: bool):
    """A's (D d, D) [left] or (D, d D) [right] matricization with its
    diagonal raised by bump * max|A|: eigensolver outputs carry ~eps * max
    noise in every direction, and the capture / re-canonicalization QRs
    need the same (after sanitizing, dead Schmidt directions are exactly
    zero columns, which the QR mishandles)."""
    B = A.reshape(-1, A.shape[-1]) if left else A.reshape(A.shape[0], -1)
    eta = bump * A.abs().max()
    B = B + eta * torch.eye(B.shape[0], B.shape[1], dtype=A.dtype,
                            device=A.device)
    return B.reshape(A.shape)


def _solve_left(C, A, lam):
    """X ~ C^-1 . A over the left index of a site tensor A (D, d, D), from
    the Tikhonov-regularized normal equations X = (C^dag C + lam)^-1
    C^dag A by a Cholesky solve.

    The stale interface bond matrix is divided out of the right segment's
    center, whose content in weak Schmidt directions is itself
    sigma-weighted (the quotient stays O(1)), not out of the left segment's
    edge isometry, whose O(1) rows in dead directions 1/sigma would blow
    up."""
    D = C.shape[0]
    G = C.mH @ C + lam * torch.eye(D, dtype=C.dtype, device=C.device)
    Y = torch.einsum("ml,mpr->lpr", C.conj(), A)
    X = torch.cholesky_solve(Y.reshape(D, -1), torch.linalg.cholesky(G))
    return X.reshape(A.shape)


def _rs_round(ARs, AC, Ws, maskf, bond_masks, nseg: int, m: int,
              restarts: int, inner_tol: float, lam_reg: float,
              reorth: str = "local1", stitch_f64: bool = False,
              two_site: bool = False, trscheme=None, sup=None,
              site=None):
    """One round: capture, segment sweeps, stitch, re-canonicalization.
    The state is at center 0 in and out (AC and ARs[1:]). Returns (ARs,
    AC, the eigenvalue of segment 0's last solve (a host float), the
    largest segment epsilon (host), (# unconverged solves, worst
    residual)). `site` (a `parallel.split.MeshAxis`) shares the segment
    sweeps out over the ranks of a mesh axis."""
    L, D = ARs.shape[0], ARs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    Lseg = L // nseg
    # the capture / stitch / re-canonicalization may run at a higher
    # precision than the sweeps: the interface division injects O(rcond)
    # error per round in the stitch's own arithmetic, which erodes a
    # converged float32 state; in float64 these O(L D^3) passes are exact
    # to ~1e-12
    hi = ((torch.complex128 if dtype.is_complex else torch.float64)
          if stitch_f64 else dtype)
    maskh = maskf.to(hi)
    bmaskh = bond_masks.to(hi)
    bump = 4.0 * torch.finfo(_real_dtype(hi)).eps

    # ---- 1. capture: fresh ALs and the bond matrix at every bond ----
    ALf = torch.empty_like(ARs)
    Cs = torch.empty((L, D, D), dtype=hi, device=device)
    C = torch.eye(D, dtype=hi, device=device)
    for i in range(L):
        A = (AC if i == 0 else ARs[i]).to(hi)
        AL, C = leftorth(_floored(
            _sanitize(torch.einsum("lm,mpr->lpr", C, A)), bump, True))
        ALf[i] = (AL * maskh[i]).to(dtype)
        C = C * bmaskh[i]
        C = C / torch.clamp(torch.linalg.vector_norm(C), min=1e-30)
        Cs[i] = C

    # ---- 2. global environments ----
    GLs = compute_left_envs(ALf, Ws, left_boundary(w, D, dtype, device))
    GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))

    # ---- 3. segment sweeps (segment k owns sites a_k .. a_k + Lseg - 1) ----
    heads, tails, stats = [], [], []
    for k in (range(nseg) if site is None else site.block(nseg, "segments")):
        a = k * Lseg
        AC0 = AC if k == 0 else torch.einsum(
            "lm,mpr->lpr", Cs[a - 1], ARs[a].to(hi)).to(dtype)
        seg = (torch.zeros_like(ARs[a: a + Lseg]), ARs[a: a + Lseg].clone(),
               AC0, Ws[a: a + Lseg], GRs[a: a + Lseg + 1].clone())
        if two_site:
            out = _dmrg2_sweep_impl(*seg, inner_tol, m, restarts, trscheme,
                                    GL0=GLs[a], GRL=GRs[a + Lseg],
                                    sup=sup[a: a + Lseg + 1])
        else:
            out = _dmrg_sweep_impl(*seg, inner_tol, m, restarts, GL0=GLs[a],
                                   GRL=GRs[a + Lseg],
                                   masks=maskf[a: a + Lseg], reorth=reorth)
        _, ARs_k, AC_k, _, lam, eps, diag = out
        heads.append(AC_k.to(hi))
        tails.append(ARs_k.to(hi))
        stats.append((lam, eps) + tuple(diag))
    if site is not None:
        # every rank's segments, in segment order, and their figures
        heads = list(site.gather(torch.stack(heads), 0))
        tails = list(site.gather(torch.stack(tails), 0))
        stats = site.gather(torch.tensor(stats, dtype=torch.float64,
                                         device=device), 0).tolist()
    lams, epss, n_unconv, worst = zip(*stats)

    # ---- 4. stitch: centers back in, stale interface bond matrices out.
    # Segment k > 0's center was seeded as C(a_k) AR(a_k) while segment
    # k-1's tail keeps the state's full right-canonical weight, so the
    # spliced chain would count C(a_k) twice: divide it out of the center.
    for k in range(1, nseg):
        heads[k] = _sanitize(_solve_left(Cs[k * Lseg - 1], heads[k],
                                         lam_reg))
    for k in range(nseg):
        tails[k][0] = heads[k]
    raw = torch.cat(tails) * maskh

    # ---- 5. re-canonicalize to center 0 (masked reverse LQ scan) ----
    ARs_out = torch.empty_like(ARs)
    C = torch.eye(D, dtype=hi, device=device)
    for i in range(L - 1, -1, -1):
        C, AR = rightorth(_floored(
            _sanitize(torch.einsum("lpm,mr->lpr", raw[i], C)), bump, False))
        AR = AR * maskh[i]
        ARs_out[i] = AR.to(dtype)
        C = C / torch.clamp(torch.linalg.vector_norm(C), min=1e-30)
    AC_out = torch.einsum("lm,mpr->lpr", C, AR) * maskh[0]
    AC_out = AC_out / torch.clamp(torch.linalg.vector_norm(AC_out),
                                  min=1e-30)
    return (ARs_out, AC_out.to(dtype), lams[0], max(epss),
            (int(sum(n_unconv)), max(worst)))


def find_groundstate_rsdmrg(psi: FiniteMPS, H,
                            alg: RealSpaceParallelDMRG =
                            RealSpaceParallelDMRG(), mesh=None):
    """Run segment-parallel DMRG. Returns (psi, envs, epsilon).

    The rounds are block-Jacobi and at finite precision can drift after
    converging, so the lowest-energy iterate is kept (each round's site
    eigenvalue is a Rayleigh quotient of the global H), and the run stops
    after 3 rounds without improvement, returning the best. `mesh`: a
    DeviceMesh whose "site" axis shares out the segments (its size must
    divide nseg); the state and the result are whole on every rank."""
    L, D, d = psi.length, psi.D, psi.physicaldim
    if alg.nseg < 2:
        raise ValueError("nseg must be >= 2 (use DMRG for a single segment)")
    if L % alg.nseg != 0:
        raise ValueError(f"nseg={alg.nseg} must divide L={L}")
    if L // alg.nseg < 2:
        raise ValueError("segments need at least 2 sites")
    site = None
    if mesh is not None:
        nsite = mesh.size(mesh.mesh_dim_names.index("site"))
        if alg.nseg % nsite:
            raise ValueError(f"the mesh's site size {nsite} must divide "
                             f"nseg={alg.nseg}")
        from ..parallel.split import MeshAxis
        site = MeshAxis(mesh, "site")
    dtype, device = psi.dtype, psi.device
    rdt = _real_dtype(dtype)
    psi = psi.move_center(0)
    masks = torch.as_tensor(support_mask(L, d, D), device=device)
    maskf = masks.to(dtype)
    bond_masks = torch.as_tensor(_bond_support_masks(L, d, D), device=device)
    sup = (torch.as_tensor(bond_support_vectors(L, d, D), device=device)
           if alg.two_site else None)
    is_f64 = rdt == torch.float64
    stitch_f64 = (not is_f64) if alg.stitch_f64 is None else alg.stitch_f64
    if alg.rcond is not None:
        rcond = alg.rcond
    elif is_f64:
        rcond = 1e-6
    else:
        # with a float64 stitch rcond need only clear the float32 data
        # noise; float32 stitch arithmetic needs the wider margin
        rcond = 1e-5 if stitch_f64 else 3e-4
    lam_reg = rcond ** 2

    # copies: the sweeps update their tensor arguments in place
    ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
    log = IterLog("RS-DMRG", alg.verbosity)
    log.init()
    eps = 1.0
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        w = Ws.shape[1]
        # serial warmup sweeps seed the interfaces
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))
        for it in range(alg.warmup):
            ALs, ARs, AC, GRs, _, eps, _ = _dmrg_sweep_impl(
                ALs, ARs, AC, Ws, GRs, updatetol(eps, it + 1),
                alg.krylovdim, alg.eig_maxrestarts, masks=masks,
                reorth=alg.reorth)

        lam = 0.0
        best = (ARs, AC, float("inf"), 1.0)
        stall, patience = 0, 3
        it = 0
        lam_prev = None
        tiny_eps = 10 * torch.finfo(rdt).eps
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            ARs, AC, lam, eps, diag = _rs_round(
                ARs, AC, Ws, maskf, bond_masks, alg.nseg, alg.krylovdim,
                alg.eig_maxrestarts, inner_tol, lam_reg, reorth=alg.reorth,
                stitch_f64=stitch_f64, two_site=alg.two_site,
                trscheme=alg.trscheme, sup=sup, site=site)
            if alg.two_site:
                # two-site rounds report the discarded weight; convergence
                # is energy stationarity (as in DMRG2)
                eps = abs(lam - lam_prev) if lam_prev is not None else 1.0
                lam_prev = lam
            if alg.finalize is not None:
                cur = FiniteMPS(torch.zeros_like(ARs), ARs, AC, 0)
                new = alg.finalize(it, cur, H) or cur
                ARs, AC = new.ARs.clone(), new.AC.clone()
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            gain = best[2] - lam
            if lam < best[2]:
                best = (ARs, AC, lam, eps)
            if eps < alg.tol:
                break
            tiny = tiny_eps * max(abs(lam), 1.0)
            stall = 0 if gain > max(alg.tol, tiny) else stall + 1
            if stall >= patience:
                break
        else:
            log.cancel(it, lam, eps)
        if eps >= alg.tol and best[2] < float("inf"):
            ARs, AC, _, eps = best

    out = FiniteMPS(torch.zeros_like(ARs), ARs, AC, 0)
    return out, finite_environments(out, H), eps
