"""Per-summand environments of LazySum operators (counterpart of
mpskit_tpu/environments/lazysum_env.py, MPSKit's `MultipleEnvironments`).

The product paths materialize a LazySum into one merged FSM. A
time-dependent sum whose coefficients change every step can instead keep
one environment per summand and recombine the effective-Hamiltonian
applications termwise:

    H_eff(t) x = sum_k c_k(t) * H_eff^{(k)} x

The coefficients are evaluated at application time, so one set of
environments serves every t; each summand's infinite environments
warm-start from the previous set (`prev`)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..operators.lazysum import LazySum, MultipliedOperator
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from .finite import finite_environments, stack_W
from .infinite_ham import hamiltonian_environments


def _term_and_coeff(op, t):
    if isinstance(op, MultipliedOperator):
        return op.op, op.coeff(t)
    return op, 1.0


@dataclasses.dataclass(frozen=True)
class MultipleEnvironments:
    """One environment object per LazySum summand, with the summands'
    operators; the coefficients are not baked in."""

    terms: Tuple[object, ...]
    envs: Tuple[object, ...]

    def coeffs(self, H: LazySum, t=0.0):
        return tuple(_term_and_coeff(op, t)[1] for op in H)


def lazysum_environments(psi, H: LazySum, t=0.0,
                         prev: MultipleEnvironments = None
                         ) -> MultipleEnvironments:
    """Per-summand environments of <psi| H_k |psi> for a FiniteMPS or an
    InfiniteMPS; an InfiniteMPS's solves warm-start from `prev`."""
    terms = tuple(_term_and_coeff(op, t)[0] for op in H)
    envs = []
    for k, Hk in enumerate(terms):
        if isinstance(psi, InfiniteMPS):
            guess = None if prev is None else prev.envs[k]
            envs.append(hamiltonian_environments(psi, Hk, env_init=guess))
        elif isinstance(psi, FiniteMPS):
            envs.append(finite_environments(psi, Hk))
        else:
            raise TypeError(type(psi))
    return MultipleEnvironments(terms, tuple(envs))


def lazysum_ac_apply(menvs: MultipleEnvironments, H: LazySum, t, i, x):
    """H_eff^{AC}(t) x = sum_k c_k(t) GL_k W_k GR_k x at site i: the
    termwise derivative, equal to the materialized sum's."""
    from ..algorithms.derivatives import ac_apply

    out = None
    for op, Hk, env in zip(H, menvs.terms, menvs.envs):
        c = _term_and_coeff(op, t)[1]
        W = stack_W(Hk, Hk.period, x.dtype, x.device)[i % Hk.period]
        y = c * ac_apply(env.leftenv(i), W, env.rightenv(i), x)
        out = y if out is None else out + y
    return out


def lazysum_c_apply(menvs: MultipleEnvironments, H: LazySum, t, i, x):
    """The termwise zero-site derivative at bond i (right of site i)."""
    from ..algorithms.derivatives import c_apply

    out = None
    for op, env in zip(H, menvs.envs):
        c = _term_and_coeff(op, t)[1]
        # bond i pairs GLs[i+1] (cyclic in an infinite cell) with GRs[i]
        GL = env.GLs[(i + 1) % env.GLs.shape[0]]
        y = c * c_apply(GL, env.rightenv(i), x)
        out = y if out is None else out + y
    return out
