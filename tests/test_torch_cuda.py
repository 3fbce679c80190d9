"""Checks of the PyTorch port that need a CUDA card (marker `cuda`; each
skips without one). This file imports no jax, so it also runs where jax is
not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from mpskit_tpu_torch import (
    DMRG, FiniteMPS, expectation_value, find_groundstate,
    transverse_field_ising_lattice,
)
from mpskit_tpu_torch.algorithms import derivatives
from mpskit_tpu_torch.config import matmul_precision
from mpskit_tpu_torch.kernels import ac_apply as k1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ and has no CPU mode")


def _k1_inputs(D, d, w, seed):
    rng = np.random.default_rng(seed)
    GL = rng.standard_normal((w, D, D)) / D
    GR = rng.standard_normal((w, D, D)) / D
    W = rng.standard_normal((w, w, d, d))
    x = rng.standard_normal((D, d, D))
    return [torch.from_numpy(a).float().cuda() for a in (GL, W, GR, x)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,d,w", [(512, 2, 3), (200, 2, 3), (96, 3, 5)])
def test_k1_matches_plain_on_card(D, d, w):
    """K1 against its plain version (same rounding points: 1e-3 bounds the
    f32 summation-order differences) at the main path's width, at a D that
    is not a multiple of the kernel's tiles, and at another (w, d)."""
    _need_card()
    GL, W, GR, x = _k1_inputs(D, d, w, seed=D)
    before = k1.launches
    with matmul_precision():
        y = derivatives.ac_apply_fast(GL, W, GR, x)
        y_plain = k1.ac_apply_bf16_reference(GL, W, GR, x)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert float((y - y_plain).norm() / y_plain.norm()) <= 1e-3


@pytest.mark.cuda
def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    GL, W, GR, x = _k1_inputs(64, 2, 3, seed=0)
    with pytest.raises(TypeError):
        k1.ac_apply_bf16(GL.double(), W, GR, x)
    with pytest.raises(ValueError):
        k1.ac_apply_bf16(GL, W, GR, x.transpose(0, 2))
    with pytest.raises(ValueError):
        k1.ac_apply_bf16(GL.cpu(), W, GR, x)


@pytest.mark.cuda
def test_float32_dmrg_on_card_goes_through_k1():
    """A small float32 DMRG on the card launches K1 in its first restarts
    and still converges to the closed-form TFIM energy."""
    _need_card()
    L, g = 16, 1.5
    A = g * np.eye(L) + np.diag(np.ones(L - 1), 1)
    e0 = -np.linalg.svd(A, compute_uv=False).sum()
    H = transverse_field_ising_lattice(g=g)
    gen = torch.Generator(device="cuda").manual_seed(3)
    psi = FiniteMPS.random(L, 2, 64, torch.float32, "cuda", gen)
    before = k1.launches
    psi, envs, _ = find_groundstate(
        psi, H, DMRG(krylovdim=10, eig_maxrestarts=2, cheap_galerkin=True,
                     maxiter=6, verbosity=0))
    assert k1.launches > before
    E = float(expectation_value(psi, H, envs))
    assert abs(E - e0) <= 1e-5 * abs(e0)
