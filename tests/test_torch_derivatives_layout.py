"""The exact one- and zero-site products (mpskit_tpu_torch/algorithms/
derivatives.py `ac_apply`, `c_apply`) as GEMMs on operands laid out by
`ac_operands` / `c_operands`: with and without `prepared`, against the
einsum formula, for environments given as non-contiguous permuted views;
and the `matvec_prepared` count and the one `matvec` span per call. The
file imports no jax:

    python -m pytest tests/test_torch_derivatives_layout.py --noconftest -o addopts="" -q
"""

import pytest
import torch

from mpskit_tpu_torch.algorithms import derivatives
from mpskit_tpu_torch.utils import trace

# (Dx, Dy, Dr, Dn, w, v, s, t): GL (w, Dx, Dy), W (w, v, s, t),
# GR (v, Dr, Dn), x (Dy, t, Dn); the last case has every leg its own size
SHAPES = [(12, 12, 12, 12, 3, 3, 2, 2), (10, 10, 10, 10, 5, 5, 3, 3),
          (8, 8, 8, 8, 26, 26, 4, 4), (7, 5, 6, 4, 3, 4, 2, 3)]
DTYPES = [torch.float64, torch.complex128]


def _rand(gen, dtype, *shape):
    t = torch.randn(shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        t = torch.complex(t, torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return t


def _operands(shape, dtype, seed=0):
    """GL and GR as permuted views of tensors stored in other orders."""
    Dx, Dy, Dr, Dn, w, v, s, t = shape
    gen = torch.Generator().manual_seed(seed)
    GL = _rand(gen, dtype, Dy, w, Dx).permute(1, 2, 0)
    GR = _rand(gen, dtype, Dn, Dr, v).permute(2, 1, 0)
    W = _rand(gen, dtype, w, v, s, t)
    return GL, W, GR, _rand(gen, dtype, Dy, t, Dn)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_ac_apply_matches_the_einsum_formula(shape, dtype):
    GL, W, GR, x = _operands(shape, dtype)
    assert not GL.is_contiguous() and not GR.is_contiguous()
    ref = torch.einsum("axy,abst,ytn,brn->xsr", GL, W, x, GR)
    ops = derivatives.ac_operands(GL, W, GR)
    assert all(o.is_contiguous() for o in ops)
    y = derivatives.ac_apply(GL, W, GR, x)
    y_prep = derivatives.ac_apply(GL, W, GR, x, prepared=ops)
    assert y.shape == ref.shape
    assert _rel(y, ref) <= 1e-13
    assert torch.equal(y_prep, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_c_apply_matches_the_einsum_formula(shape, dtype):
    GL, _, GR, x = _operands(shape, dtype)
    GR = GR[:GL.shape[0]]  # one MPO leg shared by both environments
    x = x[:, 0]
    ref = torch.einsum("axy,yn,arn->xr", GL, x, GR)
    ops = derivatives.c_operands(GL, GR)
    assert all(o.is_contiguous() for o in ops)
    y = derivatives.c_apply(GL, GR, x)
    y_prep = derivatives.c_apply(GL, GR, x, prepared=ops)
    assert y.shape == ref.shape
    assert _rel(y, ref) <= 1e-13
    assert torch.equal(y_prep, y)


@pytest.mark.parametrize("product", ["ac", "c"])
def test_prepared_calls_are_counted_and_each_call_is_one_span(product):
    GL, W, GR, x = _operands(SHAPES[0], torch.float64)
    if product == "ac":
        ops, kind = derivatives.ac_operands(GL, W, GR), "exact"

        def call(prepared=None):
            derivatives.ac_apply(GL, W, GR, x, prepared=prepared)
    else:
        ops, kind = derivatives.c_operands(GL, GR), "zero-site"

        def call(prepared=None):
            derivatives.c_apply(GL, GR, x[:, 0], prepared=prepared)

    with trace.recording() as rec:
        call()
        assert rec.counts["matvec_prepared"] == 0
        call(ops)
        call(ops)
        call()
        call(ops)
    assert rec.counts["matvec_prepared"] == 3
    assert rec.counts["matvec"] == 5
    assert [(s.name, s.kind) for s in rec.spans] == [("matvec", kind)] * 5
