"""Lattice Hamiltonians on cylinders, as periodic MPOs of the chain that
numbers the lattice's sites column by column (MPSKitModels.jl builds
these from a lattice and its bonds; the JAX package has no counterpart).
Each builds a host-numpy MPOHamiltonian; `environments.finite.stack_W`
tiles its period over a FiniteMPS of any number of whole columns.

Both models here come from one channel builder, `_cylinder_mpo`: pair
terms A_i B_j carried down the chain from i to j, with the same
operator (the identity for spins, the site parity for the Jordan-Wigner
string of fermions) on every site in between."""

from __future__ import annotations

import numpy as np

from ..operators.mpo import MPOHamiltonian
from .fermions import _spinful_ops
from .spins import spinmatrices

# the square lattice's bonds as (dx, dy) offsets: nearest neighbours
# (J1) and next-nearest, the diagonals (J2)
SQUARE_J1 = ((0, 1), (1, 0))
SQUARE_J2 = ((1, 1), (1, -1))


def _cylinder_spans(width: int, bonds) -> dict:
    """{(y, r): n}: how many of the `bonds` offsets end on a site of row y
    (the later of its two sites in the chain) and span r sites of the
    chain i = width * x + y, on a cylinder periodic in y. Every column
    past the first has the same bonds, so the table holds for all sites."""
    table = {}
    x = 2  # a bulk column: every bond that ends in it starts in it or in x-1
    for x0 in (x - 1, x):
        for y0 in range(width):
            for dx, dy in bonds:
                i = width * x0 + y0
                j = width * (x0 + dx) + (y0 + dy) % width
                lo, hi = min(i, j), max(i, j)
                if hi // width == x:
                    key = (hi % width, hi - lo)
                    table[key] = table.get(key, 0) + 1
    return table


def _cylinder_coefs(width: int, couplings) -> dict:
    """{(y, r): c}: the summed coefficient of the bonds that end on a site
    of row y and span r sites of the chain, over `couplings`, pairs
    (bond offsets, coefficient of each bond)."""
    coef = {}
    for bonds, J in couplings:
        for key, n in _cylinder_spans(width, bonds).items():
            coef[key] = coef.get(key, 0.0) + n * J
    return coef


def _cylinder_mpo(width: int, coef: dict, ops, through, onsite,
                  dtype) -> MPOHamiltonian:
    """The period-`width` MPO of sum over bonds (i, j), i < j, of
    coef[(row of j, j - i)] sum_k f_k A_k(i) T(i+1) ... T(j-1) B_k(j),
    plus `onsite` (None: nothing) on every site, for `ops` the pair terms
    (A_k, B_k, f_k) and T = `through` (a matrix, or a scalar times the
    identity).

    Each A_k placed on a site is carried to the right one site at a time
    through T, and at a site of row y the operator placed r sites to the
    left closes with coef[(y, r)] f_k B_k, the same in every column. It is
    carried only while its source still has a bond to close (`reach`, the
    longest span of a bond from each row). Each bond numbers its channels
    by the spans it carries, in increasing order, at most n of them an
    operator, so w = 2 + len(ops) n, and a bond that carries fewer leaves
    its top channels zero. The open ends need nothing more: no channel is
    filled before site 0, and channels still open at the last site are
    not read."""
    if width < 3:
        raise ValueError(f"a cylinder of width {width} < 3 joins some pair "
                         "of sites by two bonds")
    reach = [0] * width  # the longest span of a bond from each row
    for y, r in coef:
        reach[(y - r) % width] = max(reach[(y - r) % width], r)
    # spans[y]: the spans carried on the bond after a site of row y, each
    # by the operator placed r - 1 sites to the left, while it has a bond
    spans = [[r for r in range(1, max(reach) + 1)
              if reach[(y - r + 1) % width] >= r] for y in range(width)]
    n = max(map(len, spans))
    d, w = ops[0][0].shape[0], 2 + len(ops) * n

    def channel(k, y, r):
        return 1 + k * n + spans[y].index(r)

    entries = {}
    for y in range(width):
        p = (y - 1) % width
        entries[(y, 0, 0)] = 1.0
        entries[(y, w - 1, w - 1)] = 1.0
        if onsite is not None:
            entries[(y, 0, w - 1)] = onsite
        for k, (A, B, f) in enumerate(ops):
            entries[(y, 0, channel(k, y, 1))] = A
            for r in spans[p]:
                if r + 1 in spans[y]:
                    entries[(y, channel(k, p, r), channel(k, y, r + 1))] = \
                        through
                c = coef.get((y, r), 0.0)
                if c != 0.0:
                    entries[(y, channel(k, p, r), w - 1)] = c * f * B
    return MPOHamiltonian.from_fsm(entries, w, d, period=width, dtype=dtype)


def j1_j2_model(J1: float = 1.0, J2: float = 0.5, spin: float = 0.5,
                width: int = 6, dtype=np.float64) -> MPOHamiltonian:
    """H = J1 sum_<ij> S_i . S_j + J2 sum_<<ij>> S_i . S_j, the spin-`spin`
    J1-J2 Heisenberg model on the square lattice wrapped into a cylinder
    of circumference `width` (periodic in y, open in x): MPSKitModels.jl's
    `j1_j2_model` on a cylinder. Site (x, y) is site i = width * x + y of
    the chain, so a FiniteMPS of width * Lx sites holds Lx columns.

    Bonds: <ij> joins (x, y) to (x, y + 1 mod width) and to (x + 1, y);
    <<ij>> joins (x, y) to (x + 1, y + 1 mod width) and (x + 1, y - 1 mod
    width). In the chain they span 1 site (width - 1 across the wrap),
    width sites, and width + 1 or width - 1 sites (1 and 2 width - 1
    across the wrap).

    The MPO has period `width` (`_cylinder_mpo`, the identity between a
    bond's sites). S.S = Sz Sz + (S+ S- + S- S+) / 2 is real, so the MPO
    is. Each of Sz, S+ and S- is carried while its source has a bond to
    close: the longest bond from a site of row 0 spans 2 width - 1 sites,
    from rows 1 to width - 2 width + 1 sites, from row width - 1 width
    sites. So an operator has at most width + 2 channels a bond (spans
    1 .. width + 1 and the one row-0 source carried past them), and
    w = 2 + 3 (width + 2), 26 at width 6. The row-0 source stays on its
    operator's top channel through the sites of rows 2 .. width - 2, and
    those of rows 0 and 1 do not repeat a channel, so every middle
    channel's diagonal product over the period is zero."""
    Sx, Sy, Sz, _ = spinmatrices(spin)
    Sp = np.real(Sx + 1j * Sy)
    ops = [(np.real(Sz), np.real(Sz), 1.0), (Sp, Sp.T, 0.5),
           (Sp.T, Sp, 0.5)]
    coef = _cylinder_coefs(width, ((SQUARE_J1, J1), (SQUARE_J2, J2)))
    return _cylinder_mpo(width, coef, ops, 1.0, None, dtype)


def hubbard_model(t: float = 1.0, U: float = 8.0, mu: float = 4.0,
                  width: int = 6, dtype=np.float64) -> MPOHamiltonian:
    """H = -t sum_<ij>,s (c_is^dag c_js + h.c.) + U sum_i n_i,up n_i,dn
    - mu sum_i (n_i,up + n_i,dn), the spin-1/2 Hubbard model on the square
    lattice wrapped into a cylinder of circumference `width` (periodic in
    y, open in x): MPSKitModels.jl's `hubbard_model` on a
    `FiniteCylinder(width)`. Site (x, y) is site i = width * x + y of the
    chain; the site basis and the mode order are `fermions.hubbard`'s
    (|0>, |up>, |dn>, |updn>, up before down inside a site), so d = 4.
    mu = U / 2 is the particle-hole symmetric point of the bipartite
    lattice, where the ground state is half filled.

    Bonds: <ij> joins (x, y) to (x, y + 1 mod width), spanning 1 site of
    the chain (width - 1 across the wrap), and to (x + 1, y), spanning
    width sites. By Jordan-Wigner over the chain's order, for i < j

        c_is^dag c_js = (c_s^dag P)_i P_(i+1) ... P_(j-1) (c_s)_j,
        c_js^dag c_is = (P c_s)_i P_(i+1) ... P_(j-1) (c_s^dag)_j,

    P the site parity. So `_cylinder_mpo` carries each of c_up^dag P,
    P c_up, c_dn^dag P and P c_dn through P, and closes it with -t times
    its partner c_up, c_up^dag, c_dn, c_dn^dag. Every row has a bond that
    spans width sites, so each operator has width channels a bond,
    w = 2 + 4 width (26 at width 6), none of them on the diagonal. The
    on-site U n_up n_dn - mu n sits on the (0, w - 1) block. Every entry
    is real, so the MPO is."""
    c_up, c_dn, n_up, n_dn, P = _spinful_ops()
    ops = [(c_up.T @ P, c_up, 1.0), (P @ c_up, c_up.T, 1.0),
           (c_dn.T @ P, c_dn, 1.0), (P @ c_dn, c_dn.T, 1.0)]
    coef = _cylinder_coefs(width, ((SQUARE_J1, -t),))
    onsite = U * (n_up @ n_dn) - mu * (n_up + n_dn)
    return _cylinder_mpo(width, coef, ops, P, onsite, dtype)
