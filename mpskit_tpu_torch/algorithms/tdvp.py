"""TDVP time evolution (counterpart of mpskit_tpu/algorithms/tdvp.py).

Infinite: per-site Krylov exponentiation of AC and C, then a regauge.
Finite: the second-order symmetric sweep, left to right then right to
left, every site evolved forward by dt/2 with a backward bond evolution in
between; TDVP2 does the same on two-site blocks with a truncated SVD.

The JAX package runs a half sweep as one `lax.scan` that re-seats its
outputs with `jnp.roll` and `.at[].set`, and skips the edge bond with a
`lax.cond`. Here the half sweeps are host loops that write each output
straight to its seat in a fresh stack, and the edge tests are host `if`s:
the caller's tensors are never written. Every exponential is one Lanczos
factorization with one host read (`linalg/expm.py`); the Krylov error
estimates are host floats, so a step makes one sync per exponential. The
finite step hands its exponentials `Bound` matvecs, so that on the card
each factorization is one CUDA graph replay (`linalg/graphs.py`): its
shapes are the padded static D, five graphs (operand layouts) a step.

The evolution runs in the state's complex dtype (complex64 or complex128);
a real state raises TypeError. The integrator is Krylov exp(-i dt H_eff).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import Defaults, matmul_precision
from ..environments.finite import (
    compute_right_envs, left_boundary, right_boundary, stack_W,
)
from ..environments.infinite_ham import hamiltonian_environments
from ..linalg.expm import expm_multiply_err
from ..linalg.graphs import Bound
from ..operators.lazysum import LazySum, MultipliedOperator
from ..operators.mpo import MPOHamiltonian
from ..operators.window import Window
from ..parallel.replicated import has_sharded, is_sharded, run_replicated
from ..states.finitemps import FiniteMPS, support_mask
from ..states.gauging import regauge_ACC, regauge_CAC
from ..states.infinitemps import InfiniteMPS
from ..states.windowmps import WindowMPS
from ..symmetry.charges import (
    SymmetricFiniteMPS, SymmetricInfiniteMPS, masked_split_dtype,
)
from ..symmetry.su2_finite import (
    SU2FiniteMPS, SU2TDVP, timestep_su2_finite_tdvp,
)
from ..tensors.ops import (
    leftorth, notrunc, orth_in, rightorth, svd_truncated,
)
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.logging import logger
from ..utils.trace import span
from .derivatives import ac2_apply, ac_apply, c_apply

@dataclasses.dataclass(frozen=True)
class TDVP:
    """One-site TDVP parameters (same fields and defaults as
    mpskit_tpu.algorithms.tdvp.TDVP). exp_tol: warn when the worst Krylov
    truncation estimate of a step exceeds it."""

    expalg_m: int = 30
    gauge_tol: float = Defaults.tolgauge
    env_tol: float = 1e-12
    verbosity: int = Defaults.verbosity
    finalize: Optional[Callable] = None
    exp_tol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class TDVP2:
    expalg_m: int = 30
    trscheme: object = None
    verbosity: int = Defaults.verbosity
    finalize: Optional[Callable] = None
    exp_tol: float = 1e-6


def _warn_exp(alg, exp_err: float, env_resid=None, name="TDVP"):
    """Solver-quality warnings on the host: the Krylov exponential's
    truncation estimate and, for infinite states, the environment GMRES
    residual."""
    if getattr(alg, "verbosity", 0) < 1:
        return
    if exp_err > getattr(alg, "exp_tol", 1e-6):
        logger.warning(
            "%s: Krylov exponential truncation estimate %.4e exceeds exp_tol "
            "%.0e: increase expalg_m or reduce dt", name, exp_err,
            alg.exp_tol)
    if env_resid is not None and env_resid > 1e-6:
        logger.warning("%s: environment geometric-series GMRES residual "
                       "%.4e (not converged)", name, env_resid)


def _require_complex(dtype):
    if not dtype.is_complex:
        raise TypeError(
            f"time evolution needs a complex state, got {dtype}: cast the "
            "tensors to complex64 or complex128 first")


# ----------------------------------------------------------------------------
# infinite TDVP
# ----------------------------------------------------------------------------

def _timestep_infinite(psi: InfiniteMPS, H, dt, m: int, gauge_tol: float,
                       env_tol: float, env_guess=None, A_mask=None,
                       C_mask=None):
    """One step: returns (psi', envs, exp_err). A_mask/C_mask: optional
    abelian charge-conservation masks applied after the exponentials and
    the regauge (the exponential of a charge-conserving H_eff commutes
    with them, so they only remove rounding leakage)."""
    L = psi.period
    envs = hamiltonian_environments(psi, H, tol=env_tol, env_init=env_guess)
    Ws = stack_W(H, L, psi.dtype, psi.device)
    tau = -1j * dt
    ACs, Cs, errs = [], [], []
    for i in range(L):
        GL, W, GR = envs.GLs[i], Ws[i], envs.GRs[i]
        AC, err = expm_multiply_err(lambda x: ac_apply(GL, W, GR, x),
                                    psi.AC[i], tau, m)
        ACs.append(AC)
        errs.append(err)
    for i in range(L):
        # bond i (right of site i) pairs GLs[i+1] with GRs[i]
        GL, GR = envs.GLs[(i + 1) % L], envs.GRs[i]
        C, err = expm_multiply_err(lambda x: c_apply(GL, GR, x), psi.C[i],
                                   tau, m)
        Cs.append(C)
        errs.append(err)
    ACs, Cs = torch.stack(ACs), torch.stack(Cs)
    if A_mask is not None:
        ACs = ACs * A_mask.to(ACs.dtype)
        Cs = Cs * C_mask.to(Cs.dtype)
    ACs = ACs / torch.linalg.vector_norm(ACs.reshape(L, -1),
                                         dim=1)[:, None, None, None]
    Cs = Cs / torch.linalg.vector_norm(Cs.reshape(L, -1), dim=1)[:, None, None]

    ALs = regauge_ACC(ACs, Cs)
    if A_mask is not None:
        # a local regauge keeps the sector structure (the QR completions
        # of from_AL's uniform gauging would refill the masked blocks)
        Am = A_mask.to(ACs.dtype)
        ARs = regauge_CAC(torch.roll(Cs, 1, dims=0), ACs) * Am
        return InfiniteMPS(ALs * Am, ARs, ACs, Cs), envs, max(errs)
    return (InfiniteMPS.from_AL(ALs, psi.C[L - 1], tol=gauge_tol), envs,
            max(errs))


# ----------------------------------------------------------------------------
# finite TDVP
# ----------------------------------------------------------------------------

def _site_op(split, GL, W, GR):
    """The site matvec of an exponential: a `Bound`, which the card replays
    as a CUDA graph, or with a BondSplit the split's eager closure (a graph
    does not hold the collectives)."""
    if split is None:
        return Bound(ac_apply, GL, W, GR)
    return lambda x: split.ac_apply(GL, W, GR, x)


def _bond_op(split, GL, GR):
    if split is None:
        return Bound(c_apply, GL, GR)
    return lambda x: split.c_apply(GL, GR, x)


def _timestep_finite(ALs, ARs, AC, Ws, GRs, m: int, dt=0.01, GL0=None,
                     GRL=None, masks=None, split_dtype=None, split=None):
    """One symmetric second-order step, starting and ending with center 0.
    Returns (ALs, ARs, AC, GRs, exp_err): new stacks (the inputs are not
    written) and the worst Krylov estimate, a host float. GL0/GRL override
    the open-chain boundary environments (a WindowMPS's infinite sides).

    masks: optional (L, D, d, D) masks (rank support and/or abelian charge
    conservation) re-applied after every decomposition: in float32 the QR
    completions at rank-deficient padded sites otherwise leak out of the
    supported block (the JAX package measured ~1e-2 norm drift over 3 steps
    at L=32 D=256 f32 without them). PRECONDITION: ALs/ARs and GRs must be
    masked / built from masked gauges already: environments walked through
    unmasked ARs carry junk blocks that make H_eff move genuine weight off
    the support, which the in-sweep masking then deletes. split_dtype: the
    dtype of the QR / LQ, for charge masks in single precision (see
    `dmrg._dmrg_sweep_impl`). split: a `parallel.split.BondSplit`, with
    the layout of `dmrg._dmrg_sweep_impl`'s."""
    with span("step"):
        L, D = ALs.shape[0], ALs.shape[1]
        w = Ws.shape[1]
        dtype, device = AC.dtype, AC.device
        tau = -1j * (dt / 2)
        mk = None if masks is None else masks.to(device=device, dtype=dtype)
        errs = []

        # ---- left to right: site i forward, then its right bond backward ----
        ALs_new = torch.empty_like(ALs)
        GL = left_boundary(w, D, dtype, device) if GL0 is None else GL0
        # the left stack has the right one's shape (split: its columns)
        GLs = torch.empty((L,) + tuple(GRs.shape[1:]), dtype=dtype,
                          device=device)
        for i in range(L):
            GLs[i] = GL if split is None else split.local(GL)
            W, GR = Ws[i], GRs[i + 1]
            AC, errA = expm_multiply_err(_site_op(split, GL, W, GR), AC,
                                         tau, m)
            if mk is not None:
                AC = AC * mk[i]
            AL, C = orth_in(leftorth, AC, split_dtype)
            if mk is not None:
                AL = AL * mk[i]
            if split is None:
                GL = transfer_left_mpo(GL, W, AL, AL)
                ALs_new[i] = AL
            else:
                GL = split.push_left(GL, W, AL)
                ALs_new[i] = split.local(AL)
            if i == L - 1:
                # the last site keeps AC = AL C: the final center tensor
                AC = torch.einsum("lpm,mr->lpr", AL, C)
                errs.append(errA)
            else:
                C, errC = expm_multiply_err(_bond_op(split, GL, GR), C,
                                            -tau, m)
                AC = torch.einsum("lm,mpr->lpr", C, ARs[i + 1])
                if split is not None:
                    AC = split.gather(AC, -1)
                errs.append(max(errA, errC))

        # ---- right to left: site i forward, then its left bond backward ----
        # ARs[0] keeps its old value (the center ends at 0); GRs_new[i+1] is
        # the environment right of site i and GRs_new[0] repeats GRs_new[1]
        ARs_new = ARs.clone()
        GRs_new = torch.empty_like(GRs)
        GR = right_boundary(w, D, dtype, device) if GRL is None else GRL
        if split is not None:
            GR = split.local(GR)
        for i in range(L - 1, -1, -1):
            GRs_new[i + 1] = GR
            W = Ws[i]
            GLi = GLs[i] if split is None else split.gather(GLs[i], -1)
            AC, errA = expm_multiply_err(_site_op(split, GLi, W, GR), AC,
                                         tau, m)
            if mk is not None:
                AC = AC * mk[i]
            C, AR = orth_in(rightorth, AC, split_dtype)
            if mk is not None:
                AR = AR * mk[i]
            if split is None:
                GR = transfer_right_mpo(GR, W, AR, AR)
            else:
                GR = split.push_right(GR, W, AR)
            if i == 0:
                AC = torch.einsum("lm,mpr->lpr", C, AR)
                errs.append(errA)
            else:
                ARs_new[i] = AR if split is None else split.local(AR)
                C, errC = expm_multiply_err(_bond_op(split, GLi, GR), C,
                                            -tau, m)
                if split is None:
                    AC = torch.einsum("lpm,mr->lpr", ALs_new[i - 1], C)
                else:
                    AC = split.all_reduce(torch.einsum(
                        "lpm,mr->lpr", ALs_new[i - 1], C[split.sl]))
                errs.append(max(errA, errC))
        GRs_new[0] = GRs_new[1]
        return ALs_new, ARs_new, AC, GRs_new, max(errs)


def _materialize(H, t):
    """A time-dependent operator as the plain MPOHamiltonian at time t."""
    if isinstance(H, MultipliedOperator):
        return H.eval_at(t)
    if isinstance(H, LazySum):
        return H(t).sum_materialized()
    return H


def _require_mpo(H):
    if not isinstance(H, MPOHamiltonian):
        raise TypeError(f"timestep takes an MPOHamiltonian, got "
                        f"{type(H).__name__}")


def timestep(psi, H, t, dt, alg=None, envs=None):
    """Evolve psi by one time step dt. Returns (psi, envs).

    A LazySum or MultipliedOperator (and each slot of a Window) is
    evaluated at the midpoint t + dt/2. An InfiniteMPS returns the
    environments of the step, which warm-start the next one when passed
    back as `envs`; a FiniteMPS returns None. A WindowMPS under a Window
    operator co-evolves its boundaries: the infinite sides take an infinite
    TDVP step under Window.left / Window.right, then the window evolves
    under Window.middle against the updated fixed points, and the returned
    envs are the pair (left, right) of infinite environments to pass back.
    Under a plain operator the boundaries stay frozen and envs is None.
    An SU2FiniteMPS (complex) under a ReducedMPO takes one reduced
    one-site TDVP step (SU2TDVP, or TDVP's Krylov dimension capped at 24)
    and returns envs None. A bond-sharded FiniteMPS (`parallel.mesh`)
    takes the same TDVP step on its shards (`parallel.sharded.FiniteShards`);
    every other sharded call is gathered once and runs replicated."""
    if has_sharded(psi, envs) and (type(psi) is not FiniteMPS
                                   or isinstance(alg, TDVP2)):
        return run_replicated("timestep", timestep, psi, H, t, dt, alg, envs)
    if isinstance(psi, SU2FiniteMPS):
        # SU(2)-reduced finite TDVP, as in the JAX package
        alg = TDVP() if alg is None else alg
        a = (dataclasses.replace(alg, dt=dt) if isinstance(alg, SU2TDVP)
             else SU2TDVP(dt=dt, krylovdim=min(alg.expalg_m, 24)))
        psi, exp_err = timestep_su2_finite_tdvp(psi, H, a)
        if not isinstance(alg, SU2TDVP):
            _warn_exp(alg, exp_err, name="TDVP(SU2-reduced finite)")
        return psi, None
    if isinstance(H, Window):
        H = H.map(lambda O: _materialize(O, t + dt / 2))
        for O in (H.left, H.middle, H.right):
            _require_mpo(O)
    else:
        H = _materialize(H, t + dt / 2)
        _require_mpo(H)
    if alg is None:
        alg = TDVP()
    if isinstance(psi, WindowMPS):
        _require_complex(psi.dtype)
        if isinstance(alg, TDVP2):
            raise TypeError("TDVP2 evolves a FiniteMPS; a WindowMPS takes "
                            "TDVP")
        return _timestep_window(psi, H, dt, alg, envs)
    if isinstance(H, Window):
        raise TypeError("a Window operator evolves a WindowMPS, got "
                        f"{type(psi).__name__}")

    if isinstance(psi, (InfiniteMPS, SymmetricInfiniteMPS)):
        inner = psi.state if isinstance(psi, SymmetricInfiniteMPS) else psi
        _require_complex(inner.dtype)
        if isinstance(alg, TDVP2):
            raise TypeError("TDVP2 evolves a FiniteMPS; an InfiniteMPS "
                            "takes TDVP")
        A_mask = C_mask = None
        if isinstance(psi, SymmetricInfiniteMPS):
            A_mask, C_mask = psi.device_masks()
        with matmul_precision():
            inner, envs, exp_err = _timestep_infinite(
                inner, H, dt, alg.expalg_m, alg.gauge_tol, alg.env_tol,
                env_guess=envs, A_mask=A_mask, C_mask=C_mask)
        _warn_exp(alg, exp_err, env_resid=envs.resid, name="TDVP(infinite)")
        if isinstance(psi, SymmetricInfiniteMPS):
            return dataclasses.replace(psi, state=inner), envs
        return inner, envs

    if isinstance(psi, (FiniteMPS, SymmetricFiniteMPS)):
        inner = psi.state if isinstance(psi, SymmetricFiniteMPS) else psi
        _require_complex(inner.dtype)
        if isinstance(alg, TDVP2):
            if isinstance(psi, SymmetricFiniteMPS):
                raise TypeError("TDVP2 re-splits bonds without their "
                                "charges; a SymmetricFiniteMPS takes TDVP")
            return _timestep_finite2_entry(psi, H, dt, alg)
        shards = split = None
        if is_sharded(inner.AC):
            from ..parallel.sharded import FiniteShards
            shards = FiniteShards(inner)
            split = shards.split
            ALs, ARs, AC = shards.locals(inner)
        else:
            inner = inner.move_center(0)
            ALs, ARs, AC = inner.ALs, inner.ARs, inner.AC
        L, D = inner.length, inner.D
        dtype, device = inner.dtype, inner.device
        smask = torch.as_tensor(support_mask(L, inner.physicaldim, D),
                                device=device)
        if isinstance(psi, SymmetricFiniteMPS):
            smask = smask & torch.as_tensor(psi.masks, device=device)
        # the gauges are masked BEFORE the environments are built
        # (state-neutral), so that H_eff is exactly block-preserving (see
        # _timestep_finite)
        mk = smask.to(dtype)
        with matmul_precision():
            Ws = stack_W(H, L, dtype, device)
            mk_cols = mk if split is None else split.local(mk)
            ALs0, ARs0, AC0 = ALs * mk_cols, ARs * mk_cols, AC * mk[0]
            GRs = compute_right_envs(
                ARs0, Ws, right_boundary(Ws.shape[1], D, dtype, device),
                split=split)
            ALs, ARs, AC, _, exp_err = _timestep_finite(
                ALs0, ARs0, AC0, Ws, GRs, alg.expalg_m, dt=dt, masks=smask,
                split_dtype=(masked_split_dtype(dtype)
                             if isinstance(psi, SymmetricFiniteMPS)
                             else None), split=split)
        if shards is not None:
            _warn_exp(alg, exp_err, name="TDVP(finite, mesh)")
            return shards.state(ALs, ARs, AC), None
        _warn_exp(alg, exp_err, name="TDVP(finite)")
        out = FiniteMPS(ALs, ARs, AC, 0)
        if isinstance(psi, SymmetricFiniteMPS):
            return dataclasses.replace(psi, state=out), None
        return out, None

    raise TypeError(type(psi))


def _timestep_window(psi: WindowMPS, H, dt, alg, envs):
    """One TDVP step of a WindowMPS: co-evolving boundaries under a Window
    (envs threads the (left, right) infinite environments between steps),
    frozen boundaries under a plain MPOHamiltonian. The window runs without
    support masks: its bonds hold the infinite D everywhere."""
    left_gs, right_gs, out_envs = psi.left_gs, psi.right_gs, None
    with matmul_precision():
        if isinstance(H, Window):
            lenvs, renvs = envs if envs is not None else (None, None)
            left_gs, lenvs, errL = _timestep_infinite(
                left_gs, H.left, dt, alg.expalg_m, alg.gauge_tol,
                alg.env_tol, env_guess=lenvs)
            right_gs, renvs, errR = _timestep_infinite(
                right_gs, H.right, dt, alg.expalg_m, alg.gauge_tol,
                alg.env_tol, env_guess=renvs)
            _warn_exp(alg, max(errL, errR),
                      env_resid=max(lenvs.resid, renvs.resid),
                      name="TDVP(window boundaries)")
            psi = WindowMPS(left_gs, psi.window, right_gs)
            GL0, GRL, lenvs, renvs = psi.boundary_envs(
                H.left, H_right=H.right, env_init=(lenvs, renvs),
                return_envs=True)
            H_mid, name, out_envs = H.middle, "TDVP(window)", (lenvs, renvs)
        else:
            GL0, GRL = psi.boundary_envs(H)
            H_mid, name = H, "TDVP(window, frozen)"
        win = psi.window.move_center(0)
        Ws = stack_W(H_mid, win.length, win.dtype, win.device)
        GRs = compute_right_envs(win.ARs, Ws, GRL)
        ALs, ARs, AC, _, exp_err = _timestep_finite(
            win.ALs, win.ARs, win.AC, Ws, GRs, alg.expalg_m, dt=dt, GL0=GL0,
            GRL=GRL)
    _warn_exp(alg, exp_err, name=name)
    return WindowMPS(left_gs, FiniteMPS(ALs, ARs, AC, 0), right_gs), out_envs


# ----------------------------------------------------------------------------
# finite TDVP2
# ----------------------------------------------------------------------------

def _timestep_finite2_entry(psi: FiniteMPS, H, dt, alg: TDVP2):
    trscheme = alg.trscheme or notrunc()
    psi = psi.move_center(0)
    L, D = psi.length, psi.D
    dtype, device = psi.dtype, psi.device
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        GRs = compute_right_envs(
            psi.ARs, Ws, right_boundary(Ws.shape[1], D, dtype, device))
        ALs, ARs, AC, _, exp_err = _timestep_finite2(
            psi.ALs, psi.ARs, psi.AC, Ws, GRs, alg.expalg_m, trscheme, dt=dt)
    _warn_exp(alg, exp_err, name="TDVP2")
    return FiniteMPS(ALs, ARs, AC, 0), None


def _split2(theta, trscheme):
    """(D, d, d, D) -> AL (D, d, D), normalized Schmidt values S (D,) and
    AR (D, d, D) by the truncated SVD."""
    D, d = theta.shape[0], theta.shape[1]
    U, S, Vh, _ = svd_truncated(theta.reshape(D * d, d * D), D, trscheme)
    S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
    return U.reshape(D, d, D), S, Vh.reshape(D, d, D)


def _timestep_finite2(ALs, ARs, AC, Ws, GRs, m: int, trscheme, dt=0.01):
    """Two-site TDVP: forward-evolve each two-site block by dt/2, split it
    with the truncated SVD, backward-evolve the one-site remainder (not at
    the last bond of a half sweep). Same return convention as
    `_timestep_finite`."""
    L, D = ALs.shape[0], ALs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    GL = left_boundary(w, D, dtype, device)
    GRL = right_boundary(w, D, dtype, device)
    tau = -1j * (dt / 2)
    errs = []

    # ---- left to right over bonds (i, i+1), i = 0..L-2 ----
    # ALs[L-1] keeps its old value; GLs[i] is the environment left of site i
    ALs_new = ALs.clone()
    GLs = torch.empty((L - 1,) + tuple(GL.shape), dtype=dtype, device=device)
    for i in range(L - 1):
        GLs[i] = GL
        W1, W2, GR = Ws[i], Ws[i + 1], GRs[i + 2]
        theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[i + 1])
        theta, errT = expm_multiply_err(
            lambda x: ac2_apply(GL, W1, W2, GR, x), theta, tau, m)
        AL, S, AR = _split2(theta, trscheme)
        GL = transfer_left_mpo(GL, W1, AL, AL)
        ALs_new[i] = AL
        AC = S[:, None, None] * AR
        if i == L - 2:
            errs.append(errT)
        else:
            AC, errB = expm_multiply_err(
                lambda x: ac_apply(GL, W2, GR, x), AC, -tau, m)
            errs.append(max(errT, errB))

    # ---- right to left over bonds (i, i+1), i = L-2..0 ----
    # ARs[0] keeps its old value; GRs_new[i+2] is the environment right of
    # site i+1, and GRs_new[0] = GRs_new[1] repeat it for bond 0
    ARs_new = ARs.clone()
    GRs_new = torch.empty_like(GRs)
    GR = GRL
    for i in range(L - 2, -1, -1):
        GRs_new[i + 2] = GR
        GLi, W1, W2 = GLs[i], Ws[i], Ws[i + 1]
        theta = torch.einsum("lpm,mqr->lpqr", ALs_new[i], AC)
        theta, errT = expm_multiply_err(
            lambda x: ac2_apply(GLi, W1, W2, GR, x), theta, tau, m)
        AL, S, AR = _split2(theta, trscheme)
        GR = transfer_right_mpo(GR, W2, AR, AR)
        ARs_new[i + 1] = AR
        AC = AL * S[None, None, :]
        if i == 0:
            errs.append(errT)
        else:
            AC, errB = expm_multiply_err(
                lambda x: ac_apply(GLi, W1, GR, x), AC, -tau, m)
            errs.append(max(errT, errB))
    GRs_new[0] = GRs_new[1] = GRs_new[2]
    return ALs_new, ARs_new, AC, GRs_new, max(errs)
