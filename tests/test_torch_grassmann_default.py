"""The default refinement of an infinite `find_groundstate` in the
PyTorch port against the JAX package (queue-3 fault F2): VUMPS at 1e-9,
then 300 GradientGrassmann iterations in each package, about 75 s on one
CPU thread, so it has a file of its own."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpskit_tpu.models import hamiltonians as jham
from mpskit_tpu.states import infinitemps as jimps
from mpskit_tpu_torch import find_groundstate
from mpskit_tpu_torch.algorithms import grassmann as tgr
from mpskit_tpu_torch.interop import infinite_mps_from_numpy, mpo_from_numpy

jfg = importlib.import_module("mpskit_tpu.algorithms.find_groundstate")

torch.set_num_threads(1)


def test_default_infinite_find_groundstate_refines_like_jax(monkeypatch):
    """F2: find_groundstate(InfiniteMPS, H) with its default tol 1e-10
    runs VUMPS at 1e-9, then GradientGrassmann, and returns. TFIM g=1.5,
    D=8, a JAX start carried across: the energy density within 1e-10 of
    the JAX package's, eps finite and within 10x of JAX's. eps stays above
    tol in both: the preconditioned gradient norm does not decay (ROADMAP,
    known reference-side defects)."""
    steps, beta = [], tgr._cg_beta
    monkeypatch.setattr(tgr, "_cg_beta",
                        lambda *a: steps.append(1) or beta(*a))
    Hj = jham.transverse_field_ising_lattice(g=1.5)
    Ht = mpo_from_numpy(np.asarray(Hj.W))
    pj = jimps.InfiniteMPS.random(jax.random.PRNGKey(3), 1, 2, 8,
                                  dtype=jnp.float64)
    pt = infinite_mps_from_numpy(*(np.asarray(x) for x in (
        pj.AL, pj.AR, pj.AC, pj.C)), device="cpu")
    _, envs_t, eps_t = find_groundstate(pt, Ht, verbosity=0)
    _, envs_j, eps_j = jfg.find_groundstate(pj, Hj, verbosity=0)
    assert abs(float(envs_t.e_density) - float(envs_j.e_density)) <= 1e-10
    assert np.isfinite(eps_t)
    assert float(eps_j) / 10 <= eps_t <= 10 * float(eps_j)
    assert len(steps) > 0
