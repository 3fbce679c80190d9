"""The Hubbard model on a square cylinder (`hubbard_model`) against its
lattice, on the CPU in float64: the MPO of the program and the
benchmark's plain reference (benchmark/reference/fermion_lattice.py,
which builds its own per-site MPO) against an exact diagonalization built
from creation operators in the Jordan-Wigner order and the bond list,
one-site DMRG against that diagonalization's ground energy, the
reference's energy and variance against the program's, the shape of the
width-6 MPO, and `j1_j2_model`, which shares its channel builder, against
a frozen copy of that builder as it was before. The bond list is written
here from the lattice: site (x, y) is site W x + y, y periodic."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

from mpskit_tpu_torch import (
    DMRG, FiniteMPS, expectation_value, find_groundstate, hubbard_model,
    j1_j2_model, variance,
)
from mpskit_tpu_torch.models.lattices import (
    SQUARE_J1, SQUARE_J2, _cylinder_spans,
)
from mpskit_tpu_torch.models.spins import spinmatrices
from mpskit_tpu_torch.operators.mpo import DIAG_IDENTITY, MPOHamiltonian

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

T, U, MU = 1.0, 8.0, 4.0
WIDTH, LX = 3, 2


def _bonds(width, Lx):
    """(i, j) with i < j: (x, y)-(x, y+1 mod width) and (x, y)-(x+1, y)."""
    out = []
    for x in range(Lx):
        for y in range(width):
            for dx, dy in ((0, 1), (1, 0)):
                if x + dx < Lx:
                    i = width * x + y
                    j = width * (x + dx) + (y + dy) % width
                    out.append((min(i, j), max(i, j)))
    return out


def _exact_hamiltonian(width, Lx):
    """The sparse H on the Fock space of 2 L modes, mode 2 i + s for spin
    s (0 up, 1 down) of site i: c_m = Z x ... x Z x a x 1 x ... x 1 with m
    parity factors Z = diag(1, -1) before the mode's annihilator a."""
    L = width * Lx
    a = sp.csr_matrix([[0.0, 1.0], [0.0, 0.0]])
    Z = sp.csr_matrix(np.diag([1.0, -1.0]))

    def c(m):
        out = sp.identity(1, format="csr")
        for k in range(2 * L):
            f = Z if k < m else a if k == m else sp.identity(2)
            out = sp.kron(out, f, format="csr")
        return out

    cs = [c(m) for m in range(2 * L)]
    n = [m.T @ m for m in cs]
    H = sp.csr_matrix((4 ** L, 4 ** L))
    for i, j in _bonds(width, Lx):
        for s in (0, 1):
            hop = cs[2 * i + s].T @ cs[2 * j + s]
            H = H - T * (hop + hop.T)
    for i in range(L):
        H = H + U * n[2 * i] @ n[2 * i + 1] - MU * (n[2 * i] + n[2 * i + 1])
    return H


def _dense(Ws):
    """The d^L x d^L matrix of per-site MPO tensors, level 0 to w - 1."""
    w, d = Ws[0].shape[0], Ws[0].shape[2]
    E = np.zeros((w, 1, 1))
    E[0, 0, 0] = 1.0
    for W in Ws[:-1]:
        m = E.shape[1]
        E = np.einsum("aST,abst->bSsTt", E, W).reshape(w, m * d, m * d)
    m = E.shape[1]
    return np.einsum("aST,ast->SsTt", E, Ws[-1][:, w - 1]).reshape(m * d,
                                                                   m * d)


def _config():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "hubbard_yc6.json").read_text())
    cfg["lattice"]["width"] = WIDTH
    return cfg


def _program_Ws(width, L):
    H = hubbard_model(T, U, MU, width=width)
    return [H.W[i % H.period] for i in range(L)]


def _reference_Ws(width, L):
    from benchmark.reference import fermion_lattice

    return list(fermion_lattice.mpo(_config(), L))


@pytest.mark.parametrize("build", [_program_Ws, _reference_Ws],
                         ids=["program", "reference"])
def test_mpo_is_the_jordan_wigner_hamiltonian(build):
    """Width 3, Lx 2: 4096 states, the two MPOs as matrices."""
    L = WIDTH * LX
    exact = _exact_hamiltonian(WIDTH, LX).toarray()
    assert np.abs(_dense(build(WIDTH, L)) - exact).max() <= 1e-12


@pytest.mark.parametrize("seed", [3, 4])
def test_dmrg_reaches_exact_diagonalization(seed):
    """D = 64 = 4^3 is the full rank of the chain's middle bond, so the
    MPS can hold the ground state exactly."""
    e0 = sla.eigsh(_exact_hamiltonian(WIDTH, LX), k=1, which="SA")[0][0]
    gen = torch.Generator().manual_seed(seed)
    psi = FiniteMPS.random(WIDTH * LX, 4, 64, torch.float64, "cpu", gen)
    H = hubbard_model(T, U, MU, width=WIDTH)
    psi, envs, _ = find_groundstate(psi, H, DMRG(maxiter=20, tol=1e-12,
                                                 verbosity=0))
    E = float(expectation_value(psi, H, envs=envs))
    assert abs(E - e0) <= 1e-10


def test_reference_energy_and_variance_match_the_program():
    from benchmark.reference import fermion_lattice
    from benchmark.reference import mps as ref

    L, D = WIDTH * LX, 16
    gen = torch.Generator().manual_seed(11)
    psi = FiniteMPS.random(L, 4, D, torch.float64, "cpu", gen)
    H = hubbard_model(T, U, MU, width=WIDTH)
    c = psi.center
    As = ref.trimmed([psi.ALs[i] for i in range(c)] + [psi.AC]
                     + [psi.ARs[i] for i in range(c + 1, L)], D)
    Ws = torch.as_tensor(fermion_lattice.mpo(_config(), L))
    e = fermion_lattice.energy(As, Ws)
    var = fermion_lattice.variance(As, Ws)
    assert abs(e) > 1e-3 and var > 1e-3
    E = float(expectation_value(psi, H))
    assert abs(E - e) <= 1e-10 * max(1, abs(e))
    assert abs(float(variance(psi, H)) - var) <= 1e-10 * max(1, var)


def test_width_six_mpo():
    """(6, 26, 26, 4, 4), real, upper-triangular, identity on levels 0 and
    w - 1; the hopping's channels never sit on the diagonal."""
    H = hubbard_model()
    assert H.W.shape == (6, 26, 26, 4, 4) and H.W.dtype == np.float64
    below = np.tril(np.ones((26, 26), bool), -1)
    assert not np.abs(H.W).max(axis=(3, 4))[:, below].any()
    for a in (0, 25):
        assert H.diag_class[a] == DIAG_IDENTITY
        assert all(np.array_equal(W[a, a], np.eye(4)) for W in H.W)
    assert not any(np.abs(H.W[:, a, a]).any() for a in range(1, 25))


def test_width_below_three_is_refused():
    with pytest.raises(ValueError):
        hubbard_model(width=2)


def _j1_j2_frozen(J1, J2, spin, width, dtype):
    """`j1_j2_model` as it was built before it shared its channel builder
    with `hubbard_model`."""
    Sx, Sy, Sz, I = spinmatrices(spin)
    Sp = np.real(Sx + 1j * Sy)
    ops = [(np.real(Sz), np.real(Sz), 1.0), (Sp, Sp.T, 0.5),
           (Sp.T, Sp, 0.5)]
    coef = {}
    for bonds, J in ((SQUARE_J1, J1), (SQUARE_J2, J2)):
        for key, n in _cylinder_spans(width, bonds).items():
            coef[key] = coef.get(key, 0.0) + n * J
    reach = [0] * width
    for y, r in coef:
        reach[(y - r) % width] = max(reach[(y - r) % width], r)
    spans = [[r for r in range(1, max(reach) + 1)
              if reach[(y - r + 1) % width] >= r] for y in range(width)]
    n = max(map(len, spans))
    d, w = I.shape[0], 2 + len(ops) * n

    def channel(k, y, r):
        return 1 + k * n + spans[y].index(r)

    entries = {}
    for y in range(width):
        p = (y - 1) % width
        entries[(y, 0, 0)] = 1.0
        entries[(y, w - 1, w - 1)] = 1.0
        for k, (A, B, f) in enumerate(ops):
            entries[(y, 0, channel(k, y, 1))] = A
            for r in spans[p]:
                if r + 1 in spans[y]:
                    entries[(y, channel(k, p, r), channel(k, y, r + 1))] = 1.0
                c = coef.get((y, r), 0.0)
                if c != 0.0:
                    entries[(y, channel(k, p, r), w - 1)] = c * f * B
    return MPOHamiltonian.from_fsm(entries, w, d, period=width, dtype=dtype)


@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("args", [(1.0, 0.5, 0.5, np.float64),
                                  (0.7, 0.3, 1, np.complex128)],
                         ids=["default", "spin1-complex"])
def test_j1_j2_model_is_unchanged_to_the_bit(width, args):
    J1, J2, spin, dtype = args
    new = j1_j2_model(J1, J2, spin=spin, width=width, dtype=dtype)
    old = _j1_j2_frozen(J1, J2, spin, width, dtype)
    assert new.W.dtype == old.W.dtype and new.W.shape == old.W.shape
    assert new.W.tobytes() == old.W.tobytes()
    assert (new.nonzero_mask, new.diag_class, new.diag_scalar) == (
        old.nonzero_mask, old.diag_class, old.diag_scalar)
