"""Segment-parallel DMRG of the PyTorch port against the JAX package on the
CPU: RealSpaceParallelDMRG one-site and two-site with 2 and 4 segments
from the same seeded state (carried across as numpy arrays), both against
exact diagonalization; the JAX package's float32 regression case through
the float64 stitch (the auto default) against ED, with the finalize hook;
and the validation errors, a mesh's site size included (the mesh runs
are in test_torch_mesh.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.sparse.linalg import eigsh

from mpskit_tpu.algorithms import expectation_value as jexpval
from mpskit_tpu.algorithms import find_groundstate as jfind
from mpskit_tpu.algorithms.rsdmrg import RealSpaceParallelDMRG as JRS
from mpskit_tpu.models import transverse_field_ising as jtfim
from mpskit_tpu.states import FiniteMPS as JFiniteMPS
from mpskit_tpu.tensors.ops import truncdim as jtruncdim
from mpskit_tpu_torch import (
    FiniteMPS, RealSpaceParallelDMRG, expectation_value, find_groundstate,
    transverse_field_ising, truncdim,
)
from mpskit_tpu_torch.algorithms.rsdmrg import find_groundstate_rsdmrg
from mpskit_tpu_torch.interop import finite_mps_from_numpy

torch.set_num_threads(1)

L, D, G = 8, 8, 1.4


def _start(dtype=jnp.float64, seed=0, D=D):
    pj = JFiniteMPS.random(jax.random.PRNGKey(seed), L, 2, D, dtype=dtype)
    pt = finite_mps_from_numpy(*(np.asarray(x) for x in
                                 (pj.ALs, pj.ARs, pj.AC)), pj.center,
                               device="cpu")
    return pj, pt


def _ed(g=G):
    return float(np.linalg.eigvalsh(
        transverse_field_ising(g=g).to_matrix(L))[0])


def _ed_sparse(H, n):
    """The lowest eigenvalue of H on n sites: the FSM's levels as sparse
    operators on the growing chain (level 0 in, level w-1 out), Lanczos
    through scipy. At n=12 the dense 4096 x 4096 `eigvalsh` takes minutes
    on a loaded CPU; this takes a fraction of a second."""
    W = np.asarray(H.W)
    w = W.shape[1]
    M = [sps.identity(1, format="csr")] + [None] * (w - 1)
    for i in range(n):
        Wi = W[i % W.shape[0]]
        new = [None] * w
        for a in range(w):
            for b in range(w):
                if M[a] is not None and np.any(Wi[a, b]):
                    t = sps.kron(M[a], sps.csr_matrix(Wi[a, b]),
                                 format="csr")
                    new[b] = t if new[b] is None else new[b] + t
        M = new
    return float(eigsh(M[w - 1], k=1, which="SA", tol=1e-14)[0][0])


def test_sparse_ed_matches_dense():
    """The sparse ED of the float32 pin equals the dense one at L=8."""
    H = transverse_field_ising(g=1.5)
    assert abs(_ed_sparse(H, L) - _ed(1.5)) < 1e-10


@pytest.mark.parametrize("two_site,nseg", [(False, 2), (False, 4),
                                           (True, 2), (True, 4)])
def test_rsdmrg_matches_jax(two_site, nseg):
    """TFIM g=1.4 at L=8 D=8 float64, tol 1e-10: the port's energy within
    1e-10 of the JAX package's and 1e-8 of ED, eps below 1e-9."""
    pj, pt = _start()
    kw = dict(nseg=nseg, tol=1e-10, maxiter=40, verbosity=0,
              two_site=two_site)
    Hj, Ht = jtfim(g=G, dtype=np.float64), transverse_field_ising(g=G)
    algj = JRS(**kw, trscheme=jtruncdim(D)) if two_site else JRS(**kw)
    algt = (RealSpaceParallelDMRG(**kw, trscheme=truncdim(D)) if two_site
            else RealSpaceParallelDMRG(**kw))
    psij, envsj, _ = jfind(pj, Hj, algj)
    psit, envst, eps = find_groundstate(pt, Ht, algt)
    Ej = float(jexpval(psij, Hj, envs=envsj))
    Et = float(expectation_value(psit, Ht, envs=envst))
    assert abs(Et - Ej) < 1e-10
    assert abs(Et - _ed()) < 1e-8
    assert eps < 1e-9
    assert psit.center == 0 and psit.AC.shape == (D, 2, D)


def test_rsdmrg_float32_stitch_and_finalize():
    """The JAX package's float32 regression case (TFIM g=1.5, L=12, D=32,
    PRNGKey(3), 4 segments, 12 rounds after 2 warmup sweeps; the JAX
    package holds 1e-8 there): the state runs its stitch in float64 by
    default (the JAX package's CPU default) and the energy stays within
    1e-5 relative of ED; the finalize hook sees every round's state at
    center 0. (Without the single-precision breakdown threshold of
    `eigsh_smallest` the port drifted to 8.5e-2 here: Lanczos ran past the
    numerical breakdown of a converged site solve at krylovdim 30 and
    combined a Ritz value's ghost copies.)"""
    Lg, g = 12, 1.5
    pj = JFiniteMPS.random(jax.random.PRNGKey(3), Lg, 2, 32,
                           dtype=jnp.float32)
    pt = finite_mps_from_numpy(*(np.asarray(x) for x in
                                 (pj.ALs, pj.ARs, pj.AC)), pj.center,
                               device="cpu")
    seen = []

    def hook(it, psi, H):
        seen.append((it, psi.center, psi.AC.dtype))

    H = transverse_field_ising(g=g)
    psit, envst, _ = find_groundstate(pt, H, RealSpaceParallelDMRG(
        nseg=4, tol=1e-12, maxiter=12, warmup=2, verbosity=0,
        finalize=hook))
    Et = float(expectation_value(psit, H, envs=envst))
    e0 = _ed_sparse(H, Lg)
    assert abs(Et - e0) / abs(e0) < 1e-5
    assert psit.AC.dtype == torch.float32
    assert seen and [s[0] for s in seen] == list(range(1, len(seen) + 1))
    assert all(c == 0 and dt == torch.float32 for _, c, dt in seen)


def test_rsdmrg_validates_segmentation():
    """nseg < 2, nseg not dividing L and one-site segments raise
    ValueError (as in the JAX package); so does a mesh whose site size
    does not divide nseg."""
    _, pt = _start()
    H = transverse_field_ising(g=G)
    for nseg in (1, 3, 8):
        with pytest.raises(ValueError):
            find_groundstate_rsdmrg(pt, H, RealSpaceParallelDMRG(nseg=nseg))

    class ThreeSites:
        """A stand-in for a DeviceMesh with 3 ranks on its "site" axis."""
        mesh_dim_names = ("site", "bond")

        def size(self, dim):
            return (3, 1)[dim]

    with pytest.raises(ValueError, match="site"):
        find_groundstate_rsdmrg(pt, H, RealSpaceParallelDMRG(nseg=2),
                                mesh=ThreeSites())
    small = FiniteMPS.random(4, 2, 4, torch.float64, "cpu",
                             torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="2 sites"):
        find_groundstate_rsdmrg(small, H, RealSpaceParallelDMRG(nseg=4))

