"""The J1-J2 Heisenberg model on a square cylinder (`j1_j2_model`) against
its lattice, on the CPU in float64: the MPO against the dense sum over the
bond list, its FSM's channels followed from every source to the bonds it
closes, its energies against an MPO that carries every operator through
all 2 W - 1 spans (`distance_level_model`, also the card's reference in
test_torch_cuda.py), the finite energy against the benchmark's plain
lattice reference (benchmark/reference/lattice.py, which builds its own
per-site MPO from the bonds), and one-site DMRG against sparse exact
diagonalization. The bond list is written here from the lattice: site
(x, y) is site W x + y, y periodic."""

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
from mpskit_tpu_torch.operators.mpo import (
    DIAG_IDENTITY, DIAG_ZERO, MPOHamiltonian,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

J1, J2 = 1.0, 0.5
SZ = np.diag([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
# the pair terms of S.S: (first operator, second operator, factor)
TERMS = ((SZ, SZ, 1.0), (SP, SP.T, 0.5), (SP.T, SP, 0.5))


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


def distance_level_model(width):
    """The J1-J2 cylinder's MPO (spin 1/2, float64) with each of Sz, S+,
    S- carried through every span 1 .. 2 width - 1 on every bond, whether
    or not its source has a bond left to close: w = 2 + 3 (2 width - 1)."""
    R = 2 * width - 1
    w = 2 + 3 * R
    table = {}  # (y, r): the coupling of a bulk column's bonds that end
    for i, j, J in _bonds(width, 4):  # on row y and span r sites
        if j // width == 2:
            table[(j % width, j - i)] = table.get((j % width, j - i), 0) + J
    entries = {}
    for y in range(width):
        entries[(y, 0, 0)] = entries[(y, w - 1, w - 1)] = 1.0
        for k, (A, B, f) in enumerate(TERMS):
            entries[(y, 0, 1 + k * R)] = A
            for r in range(1, R):
                entries[(y, k * R + r, k * R + r + 1)] = 1.0
            for r in range(1, R + 1):
                if table.get((y, r), 0.0) != 0.0:
                    entries[(y, k * R + r, w - 1)] = table[(y, r)] * f * B
    return MPOHamiltonian.from_fsm(entries, w, 2, period=width,
                                   dtype=np.float64)


def _dense_hamiltonian(width, Lx, sparse=False):
    L = width * Lx
    kron = sp.kron if sparse else np.kron
    eye = sp.identity if sparse else np.eye

    def at(o, i):
        return kron(kron(eye(2 ** i), o), eye(2 ** (L - i - 1)))

    H = 0
    for i, j, J in _bonds(width, Lx):
        for A, B, f in TERMS:
            H = H + J * f * (at(A, i) @ at(B, j))
    return H


def test_mpo_is_the_dense_bond_sum():
    H = j1_j2_model(J1, J2, width=4)
    assert H.odim == 20 and H.period == 4
    assert np.abs(H.to_matrix(8) - _dense_hamiltonian(4, 2)).max() <= 1e-12


@pytest.mark.parametrize("width", [3, 5])
def test_mpo_is_the_dense_bond_sum_at_other_widths(width):
    """Two columns, as test_mpo_is_the_dense_bond_sum at width 4."""
    H = j1_j2_model(J1, J2, width=width)
    assert H.odim == 2 + 3 * (width + 2) and H.period == width
    err = np.abs(H.to_matrix(2 * width) - _dense_hamiltonian(width, 2)).max()
    assert err <= 1e-12


def test_fsm_closes_each_span_with_its_bonds():
    """w = 2 + 3 (W + 2) at widths 4, 6 and 8. Each source site and each
    pair term (Sz Sz, S+ S- / 2, S- S+ / 2) opens one channel from level
    0, which steps through the identity to one channel a bond and closes
    at every later site t with the coupling of the bond (s, t) times the
    second operator, and ends at the source's last bond: no channel is
    carried dead. The channels of a bond are distinct, a bulk column's
    bonds after rows 0 .. W-1 carry 3 (W+1), 3 (W+2) ... 3 (W+2), 3 W of
    them, and every middle channel is used."""
    for width in (4, 6, 8):
        H = j1_j2_model(J1, J2, width=width)
        w = H.odim
        assert w == 2 + 3 * (width + 2) and H.period == width
        Lx = 5
        L = width * Lx
        Ws = np.tile(H.W, (Lx, 1, 1, 1, 1))
        J = {}
        for i, j, c in _bonds(width, Lx):
            J[(i, j)] = J.get((i, j), 0.0) + c
        on_bond = [set() for _ in range(L)]
        for s in range(width * (Lx - 1)):   # every partner in the chain
            last = max(j for i, j in J if i == s)
            for A, B, f in TERMS:
                (c,) = [b for b in range(1, w - 1)
                        if np.array_equal(Ws[s, 0, b], A)]
                t = s + 1
                while True:
                    assert c not in on_bond[t - 1]
                    on_bond[t - 1].add(c)
                    np.testing.assert_allclose(
                        Ws[t, c, w - 1], J.get((s, t), 0.0) * f * B,
                        atol=1e-15)
                    nxt = [b for b in range(1, w - 1)
                           if np.abs(Ws[t, c, b]).max() > 0]
                    if not nxt:
                        break
                    (b,) = nxt
                    np.testing.assert_array_equal(Ws[t, c, b], np.eye(2))
                    c, t = b, t + 1
                assert t == last
        bulk = [len(on_bond[2 * width + y]) for y in range(width)]
        assert bulk == [3 * (width + 1)] + [3 * (width + 2)] * (width - 2) \
            + [3 * width]
        assert set().union(*on_bond) == set(range(1, w - 1))


@pytest.mark.parametrize("Lx", [2, 3])
def test_energy_equals_the_distance_level_mpo(Lx):
    """Width 6: the channels left out carried only zeros to the end, so a
    seeded random MPS has the same energy under both MPOs."""
    width, D = 6, 16
    gen = torch.Generator().manual_seed(20 + Lx)
    psi = FiniteMPS.random(width * Lx, 2, D, torch.float64, "cpu", gen)
    H = j1_j2_model(J1, J2, width=width)
    Hd = distance_level_model(width)
    assert (H.odim, Hd.odim) == (26, 35)
    E, Ed = (float(expectation_value(psi, h)) for h in (H, Hd))
    assert abs(Ed) > 1e-3
    assert abs(E - Ed) <= 1e-12 * max(1.0, abs(Ed))


@pytest.mark.parametrize("width", [3, 4, 5, 6, 7, 8])
def test_middle_channels_vanish_over_the_period(width):
    """Level 0 and level w-1 are the identity at every site; every middle
    channel's diagonal product over the period is zero, so a period-width
    infinite cell is a valid Jordan form, and W is upper-triangular."""
    H = j1_j2_model(J1, J2, width=width)
    w = H.odim
    assert H.diag_class[0] == H.diag_class[w - 1] == DIAG_IDENTITY
    assert set(H.diag_class[1:w - 1]) == {DIAG_ZERO}
    below = np.tril(np.ones((w, w), bool), -1)
    assert not np.abs(H.W).max(axis=(3, 4))[:, below].any()


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
