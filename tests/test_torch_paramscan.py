"""Parameter scans of the PyTorch port against the JAX package on the CPU:
the lockstep VUMPS scan member by member from the same seeded states
(carried across as numpy arrays), the stacking helpers, and the
ValueErrors for mixed FSM structure, shape and batch size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import paramscan as jscan
from mpskit_tpu.algorithms.vumps import VUMPS as JVUMPS
from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu_torch import (
    VUMPS, ScanResult, heisenberg_XXZ, scan_groundstate_vumps,
    stack_hamiltonians, transverse_field_ising,
)
from mpskit_tpu_torch.algorithms.paramscan import (
    stack_states, unstack_states,
)
from mpskit_tpu_torch.interop import infinite_mps_from_numpy

torch.set_num_threads(1)

GS = (1.2, 2.0)


def _states(D):
    """One seeded JAX float64 state per scan point and its port copy."""
    js = [JInfiniteMPS.random(jax.random.PRNGKey(10 + i), 1, 2, D,
                              dtype=jnp.float64) for i in range(len(GS))]
    ts = [infinite_mps_from_numpy(*(np.asarray(x) for x in
                                    (p.AL, p.AR, p.AC, p.C)), device="cpu")
          for p in js]
    return js, ts


def test_scan_matches_jax_member_by_member():
    """TFIM at g = 1.2 and 2.0, D=6 float64, VUMPS(tol=1e-9, maxiter=40):
    the same lockstep iteration count, each member's energy density within
    1e-10 of the JAX scan's and 1e-6 of the exact one, eps below tol."""
    js, ts = _states(6)
    jres = jscan.scan_groundstate_vumps(
        js, [jham.transverse_field_ising(g=g, dtype=np.float64) for g in GS],
        JVUMPS(tol=1e-9, maxiter=40, verbosity=0))
    tres = scan_groundstate_vumps(
        ts, [transverse_field_ising(g=g) for g in GS],
        VUMPS(tol=1e-9, maxiter=40, verbosity=0))
    assert isinstance(tres, ScanResult)
    assert tres.iterations == jres.iterations
    ej = np.asarray(jres.energies).real
    et = tres.energies.numpy().real
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-10)
    for g, e in zip(GS, et):
        k, wk = np.polynomial.legendre.leggauss(200)
        exact = -np.sum(wk * np.sqrt(1 + g * g - 2 * g * np.cos(
            np.pi * (k + 1) / 2))) / 2
        assert abs(e - exact) < 1e-6
    assert tres.eps.shape == (len(GS),) and float(tres.eps.max()) < 1e-9
    assert tres.psis.AL.shape == (len(GS), 1, 6, 2, 6)
    # the closing from_AL gives exact isometries
    for p in unstack_states(tres.psis):
        eye = torch.einsum("lpm,lpn->mn", p.AL[0], p.AL[0])
        assert float((eye - torch.eye(6, dtype=eye.dtype)).abs().max()) < 1e-12


def test_stack_helpers_and_errors():
    """stack_states / unstack_states round-trip; stacking mixed models or
    shapes and a batch mismatch raise ValueError, as in the JAX package."""
    _, ts = _states(4)
    back = unstack_states(stack_states(ts))
    for a, b in zip(back, ts):
        for f in ("AL", "AR", "AC", "C"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    Hs = stack_hamiltonians([transverse_field_ising(g=g) for g in GS])
    assert Hs.W.shape[0] == len(GS)
    with pytest.raises(ValueError):
        stack_hamiltonians([transverse_field_ising(g=1.0),
                            heisenberg_XXZ(delta=0.5)])
    with pytest.raises(ValueError, match="structure"):
        stack_hamiltonians([transverse_field_ising(g=1.0),
                            transverse_field_ising(g=0.0)])
    with pytest.raises(ValueError):
        jscan.stack_hamiltonians([jham.transverse_field_ising(g=1.0),
                                  jham.heisenberg_XXZ(delta=0.5)])
    with pytest.raises(ValueError, match="shapes"):
        stack_hamiltonians([transverse_field_ising(g=1.0),
                            transverse_field_ising(g=1.0, period=2)])
    with pytest.raises(ValueError, match="batch mismatch"):
        scan_groundstate_vumps(ts, [transverse_field_ising(g=1.0)])
