"""The J1-J2 Heisenberg model on a square cylinder (`j1_j2_model`) against
its lattice, on the CPU in float64: the MPO against the dense sum over the
bond list, its FSM's coefficients against the bonds each (row, span)
closes, the finite energy against the benchmark's plain lattice reference
(benchmark/reference/lattice.py, which builds its own per-site MPO from
the bonds), and one-site DMRG against sparse exact diagonalization. The
bond list is written here from the lattice: site (x, y) is site W x + y,
y periodic."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

from mpskit_tpu_torch import (
    DMRG, FiniteMPS, expectation_value, find_groundstate, j1_j2_model,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

J1, J2 = 1.0, 0.5


def _bonds(width, Lx):
    """(i, j, J) with i < j: (x, y)-(x, y+1), (x, y)-(x+1, y) at J1 and
    (x, y)-(x+1, y+1), (x, y)-(x+1, y-1) at J2, y mod width."""
    out = []
    for x in range(Lx):
        for y in range(width):
            for (dx, dy), J in (((0, 1), J1), ((1, 0), J1), ((1, 1), J2),
                                ((1, -1), J2)):
                if x + dx < Lx:
                    i = width * x + y
                    j = width * (x + dx) + (y + dy) % width
                    out.append((min(i, j), max(i, j), J))
    return out


def _dense_hamiltonian(width, Lx, sparse=False):
    L = width * Lx
    kron = sp.kron if sparse else np.kron
    eye = sp.identity if sparse else np.eye
    Sz = np.diag([0.5, -0.5])
    Sp = np.array([[0.0, 1.0], [0.0, 0.0]])

    def at(o, i):
        return kron(kron(eye(2 ** i), o), eye(2 ** (L - i - 1)))

    H = 0
    for i, j, J in _bonds(width, Lx):
        H = H + J * (at(Sz, i) @ at(Sz, j)
                     + 0.5 * (at(Sp, i) @ at(Sp.T, j)
                              + at(Sp.T, i) @ at(Sp, j)))
    return H


def test_mpo_is_the_dense_bond_sum():
    H = j1_j2_model(J1, J2, width=4)
    assert H.odim == 2 + 3 * 7 and H.period == 4
    assert np.abs(H.to_matrix(8) - _dense_hamiltonian(4, 2)).max() <= 1e-12


def test_fsm_closes_each_span_with_its_bonds():
    """w = 35 at width 6; at every row y and span r the Sz level closes
    with J(y, r) Sz and the S+ level with J(y, r)/2 S-, J(y, r) the summed
    coupling of the bonds of a bulk column that end on row y and span r."""
    width, R = 6, 11
    H = j1_j2_model(J1, J2, width=width)
    w = H.odim
    assert w == 35 and H.period == width
    table = {}
    for i, j, J in _bonds(width, 4):
        if j // width == 2:
            table[(j % width, j - i)] = table.get((j % width, j - i), 0) + J
    assert {r for _, r in table} == {1, 5, 6, 7, 11}
    Sz = np.diag([0.5, -0.5])
    Sm = np.array([[0.0, 0.0], [1.0, 0.0]])
    for y in range(width):
        for r in range(1, R + 1):
            J = table.get((y, r), 0.0)
            np.testing.assert_allclose(H.W[y, r, w - 1], J * Sz, atol=1e-15)
            np.testing.assert_allclose(H.W[y, 1 + R + r - 1, w - 1],
                                       0.5 * J * Sm, atol=1e-15)


def test_energy_matches_the_lattice_reference():
    import json

    from benchmark.reference import lattice
    from benchmark.reference import mps as ref

    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "j1j2_yc6.json").read_text())
    width, Lx, D = 6, 2, 8
    H = j1_j2_model(J1, J2, width=width)
    gen = torch.Generator().manual_seed(11)
    psi = FiniteMPS.random(width * Lx, 2, D, torch.float64, "cpu", gen)
    E = float(expectation_value(psi, H))
    c = psi.center
    As = ([psi.ALs[i] for i in range(c)] + [psi.AC]
          + [psi.ARs[i] for i in range(c + 1, width * Lx)])
    Ws = lattice.mpo(cfg, width * Lx, ref.site_operators(cfg["site"]))
    As, Ws = ref.as_reference(ref.trimmed(As, D), Ws, "cpu")
    e = lattice.energy(As, Ws)
    assert abs(e) > 1e-3
    assert abs(E - e) <= 1e-10 * max(1.0, abs(e))


@pytest.mark.parametrize("seed", [3, 4])
def test_dmrg_reaches_exact_diagonalization(seed):
    """Width 4, Lx 3: 4096 states. D = 64 is the full rank of the chain's
    middle bond, so the MPS can hold the ground state exactly (D = 32
    stops 1.6e-4 above it)."""
    width, Lx, D = 4, 3, 64
    e0 = sla.eigsh(_dense_hamiltonian(width, Lx, sparse=True).tocsr(), k=1,
                   which="SA")[0][0]
    gen = torch.Generator().manual_seed(seed)
    psi = FiniteMPS.random(width * Lx, 2, D, torch.float64, "cpu", gen)
    H = j1_j2_model(J1, J2, width=width)
    psi, envs, _ = find_groundstate(psi, H, DMRG(maxiter=20, tol=1e-12,
                                                 verbosity=0))
    E = float(expectation_value(psi, H, envs=envs))
    assert abs(E - e0) <= 1e-8


def test_width_below_three_is_refused():
    with pytest.raises(ValueError):
        j1_j2_model(width=2)
