"""Two-point and string correlators (counterpart of
mpskit_tpu/algorithms/correlators.py): <O1_i O2_j> and
<O1_i (prod_{i<k<j} Omid_k) O2_j> for j in js, walking the right-gauged
tensors from the center tensor at i with plain transfer pushes. The values
stay on the device and come back stacked, without a read."""

from __future__ import annotations

import numpy as np
import torch

from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..transfermatrix.transfer import transfer_left


def _op(O, psi):
    return torch.as_tensor(np.asarray(O), device=psi.device).to(psi.dtype)


def _walk(psi, O1, O2, i: int, js, step):
    """The shared walk: v after O1 on the center tensor at i, then for each
    site j up to max(js) the closing value with O2 (kept where j is in
    js) and the push `step(v, A)`. Returns one value for a scalar js, a
    stacked 1-dim tensor otherwise."""
    scalar = np.isscalar(js)
    js = [js] if scalar else list(js)
    if not all(j > i for j in js):
        raise ValueError(f"correlators require every j > i = {i}")
    if isinstance(psi, FiniteMPS):
        p = psi.move_center(i)
        AC = p.AC

        def site(j):
            return p.ARs[j]
    elif isinstance(psi, InfiniteMPS):
        AC = psi.AC[i % psi.period]

        def site(j):
            return psi.AR[j % psi.period]
    else:
        raise TypeError(type(psi))
    O1, O2 = _op(O1, psi), _op(O2, psi)
    den = torch.vdot(AC.reshape(-1), AC.reshape(-1))
    v = torch.einsum("lsr,st,ltm->rm", AC.conj(), O1, AC)
    vals = {}
    wanted = set(js)
    for j in range(i + 1, max(js) + 1):
        A = site(j)
        if j in wanted:
            vals[j] = torch.einsum("xy,xsr,st,ytr->", v, A.conj(), O2, A)
        v = step(v, A)
    out = torch.stack([vals[j] for j in js]) / den
    return out[0] if scalar else out


def correlator(psi, O1, O2, i: int, js):
    """<O1_i O2_j> for j in js (every j > i); O1, O2 are (d, d)."""
    return _walk(psi, O1, O2, i, js, lambda v, A: transfer_left(v, A, A))


def string_correlator(psi, O1, Omid, O2, i: int, js):
    """<O1_i (prod_{i<k<j} Omid_k) O2_j> for j in js (every j > i): the
    string order of the Haldane phase with O1 = O2 = S^z and Omid =
    exp(i pi S^z), or a fermion bilinear <c_i^dag c_j> under Jordan-Wigner
    with O1 = c^dag Z, Omid = Z, O2 = c (`models/fermions.py`)."""
    Om = _op(Omid, psi)

    def step(v, A):
        t = torch.einsum("xy,ytn->xtn", v, A)
        t = torch.einsum("xtn,st->xsn", t, Om)
        return torch.einsum("xsm,xsn->mn", A.conj(), t)

    return _walk(psi, O1, O2, i, js, step)
