"""CPU probe of the dominant Ritz solve in boundary VUMPS: the JAX package
(its fixed 300-step power iteration on the Hessenberg matrix, and the same
run with 5000 steps) against the PyTorch port (LAPACK `eig`), from one
random state per bond dimension, on the critical classical Ising MPO in
complex128.

    python scripts/probe_boundary_ritz.py [D ...] [--iters N]

For each D it prints, per run, the iterations, the last eps, the leading
eigenvalue's relative error against Onsager's and the seconds. The JAX
runs are the package's own `leading_boundary` loop; only the step count
of `linalg.arnoldi.small_eig_dominant` differs between them. Runs on the
CPU; expect minutes at D=32.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpskit_tpu.algorithms import statmech as jsm  # noqa: E402
from mpskit_tpu.algorithms.expval import expectation_value as jexpval  # noqa: E402,E501
from mpskit_tpu.linalg import arnoldi as jarn  # noqa: E402
from mpskit_tpu.models import statmech as jmod  # noqa: E402
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS  # noqa: E402,E501
import mpskit_tpu_torch as mt  # noqa: E402
from mpskit_tpu_torch.interop import infinite_mps_from_numpy  # noqa: E402

ONSAGER = float(np.sqrt(2) * np.exp(2 * 0.915965594177219015 / np.pi))


def _jax_run(psi, iters, steps):
    """JAX leading_boundary with `steps` power steps per Ritz solve."""
    small = jarn.small_eig_dominant
    jarn.small_eig_dominant = functools.partial(small, iters=steps)
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        O = jmod.classical_ising()
        out, envs, eps = jsm.leading_boundary(
            psi, O, jsm.VUMPS_Boundary(tol=1e-12, maxiter=iters, verbosity=0))
        lam = complex(jexpval(out, O, envs=envs))
        return eps, lam, time.perf_counter() - t0
    finally:
        jarn.small_eig_dominant = small
        jax.clear_caches()


def _port_run(psi, iters):
    t0 = time.perf_counter()
    p = infinite_mps_from_numpy(*(np.asarray(x) for x in (
        psi.AL, psi.AR, psi.AC, psi.C)), "cpu")
    O = mt.classical_ising()
    out, envs, eps = mt.leading_boundary(
        p, O, mt.VUMPS_Boundary(tol=1e-12, maxiter=iters, verbosity=0))
    lam = complex(mt.expectation_value(out, O, envs=envs))
    return eps, lam, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("D", nargs="*", type=int, default=[8, 16, 32])
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args()
    torch.set_num_threads(4)
    for D in args.D:
        psi = JInfiniteMPS.random(jax.random.PRNGKey(0), 1, 2, D)
        runs = (("JAX, 300 power steps", lambda: _jax_run(psi, args.iters,
                                                          300)),
                ("JAX, 5000 power steps", lambda: _jax_run(psi, args.iters,
                                                           5000)),
                ("port, LAPACK eig", lambda: _port_run(psi, args.iters)))
        for name, run in runs:
            eps, lam, dt = run()
            print(f"D={D} {name}: {args.iters} iterations, eps {eps:.3e}, "
                  f"lambda {lam.real:.15f}, rel err "
                  f"{abs(lam - ONSAGER) / ONSAGER:.3e}, {dt:.1f} s",
                  flush=True)


if __name__ == "__main__":
    main()
