"""CPU probe of VUMPS on the half-filled Hubbard chain (U=4, mu=2, the
`hubbard` model of either package) from seeded random states, float64:
the cell-mean energy against Lieb-Wu's, the largest deviation of <n> from
1 and VUMPS's eps, every `--every` iterations (the PyTorch port) or at the
end (the JAX package).

    python scripts/probe_hubbard_vumps.py torch --cell 2 --D 24 --iters 160
    python scripts/probe_hubbard_vumps.py jax --cell 1 --D 24 --iters 80 \
        --seeds 0 3 5

The port's start state comes from `torch.Generator().manual_seed(seed)`,
the JAX package's from `PRNGKey(seed)`. Expect about a minute per run at
D=24.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

# -4 int_0^inf J0(w) J1(w) / (w (1 + exp(w U / 2))) dw at U=4, minus mu
E_LIEB_WU = -2.5737293678984039


def _n_tot():
    c = np.array([[0.0, 1.0], [0.0, 0.0]])
    n = c.T @ c
    return np.kron(n, np.eye(2)) + np.kron(np.eye(2), n)


def _torch_run(cell, D, iters, seed, every):
    import torch

    import mpskit_tpu_torch as mt
    from mpskit_tpu_torch.algorithms import vumps

    H = mt.hubbard(t=1.0, U=4.0, mu=2.0, period=cell)
    n = _n_tot()
    psi = mt.InfiniteMPS.random(cell, 4, D, torch.float64, "cpu",
                                torch.Generator().manual_seed(seed))
    step, last = vumps._vumps_iteration_impl, {}

    def recorded(*args, **kwargs):
        out = step(*args, **kwargs)
        last["eps"] = float(out[1])
        return out

    def report(it, p, H):
        if it % every == 0:
            e = float(mt.expectation_value(p, H).mean())
            dn = max(abs(complex(mt.expectation_value(p, (i, n))) - 1)
                     for i in range(cell))
            print(f"  iteration {it}: e - e_LW {e - E_LIEB_WU:+.4e}, "
                  f"max |<n> - 1| {dn:.2e}, eps {last['eps']:.2e}",
                  flush=True)

    vumps._vumps_iteration_impl = recorded
    try:
        _, _, eps = mt.find_groundstate(psi, H, mt.VUMPS(
            tol=1e-8, maxiter=iters, finalize=report, verbosity=0))
    finally:
        vumps._vumps_iteration_impl = step
    return eps


def _jax_run(cell, D, iters, seed):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpskit_tpu.algorithms.expval import expectation_value
    from mpskit_tpu.algorithms.find_groundstate import find_groundstate
    from mpskit_tpu.algorithms.vumps import VUMPS
    from mpskit_tpu.models.fermions import hubbard
    from mpskit_tpu.states.infinitemps import InfiniteMPS

    H = hubbard(t=1.0, U=4.0, mu=2.0, period=cell)
    psi = InfiniteMPS.random(jax.random.PRNGKey(seed), cell, 4, D,
                             dtype=jnp.float64)
    psi, _, eps = find_groundstate(psi, H, VUMPS(tol=1e-8, maxiter=iters))
    e = float(np.mean(np.asarray(expectation_value(psi, H))))
    dn = max(abs(complex(expectation_value(psi, (i, _n_tot()))) - 1)
             for i in range(cell))
    print(f"  after {iters} iterations: e {e:.6f}, e - e_LW "
          f"{e - E_LIEB_WU:+.4e}, max |<n> - 1| {dn:.2e}, eps "
          f"{float(eps):.2e}", flush=True)
    return eps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("torch", "jax"))
    ap.add_argument("--cell", type=int, default=2)
    ap.add_argument("--D", type=int, default=24)
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--every", type=int, default=20)
    a = ap.parse_args()
    for seed in a.seeds:
        print(f"{a.package}: Hubbard U=4 mu=2, {a.cell}-site cell, D={a.D}, "
              f"seed {seed}", flush=True)
        t0 = time.perf_counter()
        if a.package == "torch":
            _torch_run(a.cell, a.D, a.iters, seed, a.every)
        else:
            _jax_run(a.cell, a.D, a.iters, seed)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
