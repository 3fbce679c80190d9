"""2D classical statistical-mechanics transfer MPOs (counterpart of
mpskit_tpu/models/statmech.py), built on the host in numpy as the port's
`DenseMPO`; the boundary drivers move them to the state's device.

Leg order: the reference's MPO tensors are (left, out, in, right); the
DenseMPO convention is O[a, b, s, t] = [left, right, out, in].
"""

from __future__ import annotations

import numpy as np

from ..operators.mpo import DenseMPO


def _critical_beta() -> float:
    return float(np.log(1 + np.sqrt(2)) / 2)


def ising_bond_tensor(beta: float) -> np.ndarray:
    """Symmetric square root of the bond Boltzmann matrix."""
    t = np.array([[np.exp(beta), np.exp(-beta)],
                  [np.exp(-beta), np.exp(beta)]])
    evals, evecs = np.linalg.eigh(t)
    return evecs @ np.diag(np.sqrt(evals)) @ evecs.T


def _delta(shape) -> np.ndarray:
    """The all-equal-index tensor of a two-state spin (1 at 0...0, 1...1)."""
    O = np.zeros(shape)
    O[(0,) * len(shape)] = 1
    O[tuple(min(1, n - 1) for n in shape)] = 1
    return O


def classical_ising(beta: float = None, dtype=np.complex128) -> DenseMPO:
    """Bulk transfer MPO of the 2D classical Ising model, at the critical
    temperature by default."""
    nt = ising_bond_tensor(_critical_beta() if beta is None else beta)
    o = np.einsum("ijkl,ai,bj,sk,tl->abst", _delta((2, 2, 2, 2)), nt, nt, nt,
                  nt)
    return DenseMPO.from_array(o.transpose(0, 3, 1, 2).astype(dtype))


def finite_classical_ising(N: int, beta: float = None,
                           dtype=np.complex128) -> DenseMPO:
    """Finite-row transfer MPO of N sites with size-1 boundary virtual
    legs."""
    nt = ising_bond_tensor(_critical_beta() if beta is None else beta)
    obulk = np.einsum("ijkl,ai,bj,sk,tl->abst", _delta((2, 2, 2, 2)), nt, nt,
                      nt, nt)
    # (left=1, out, in, right) and (left, out, in, right=1): only the
    # non-boundary legs carry nt factors
    oleft = np.einsum("ixyz,bx,sy,tz->ibst", _delta((1, 2, 2, 2)), nt, nt, nt)
    oright = np.einsum("xyzr,ax,by,cz->abcr", _delta((2, 2, 2, 1)), nt, nt,
                       nt)
    tensors = [oleft] + [obulk] * (N - 2) + [oright]
    return DenseMPO(tuple(
        np.ascontiguousarray(t.transpose(0, 3, 1, 2)).astype(dtype)
        for t in tensors))


def sixvertex(a: float = 1.0, b: float = 1.0, c: float = 1.0,
              dtype=np.complex128) -> DenseMPO:
    """Six-vertex model R-matrix transfer MPO: raw legs (1, 2, 3, 4) are
    left=1, out=2, in=4, right=3, a (0, 2, 1, 3) transpose into
    [left, right, out, in]."""
    d = np.array([[a, 0, 0, 0],
                  [0, c, b, 0],
                  [0, b, c, 0],
                  [0, 0, 0, a]], dtype).reshape(2, 2, 2, 2)
    return DenseMPO.from_array(d.transpose(0, 2, 1, 3).astype(dtype))


def hard_hexagon(z: float = None, dtype=np.float64) -> DenseMPO:
    """Row transfer MPO of the hard-hexagon lattice gas in the dense
    occupation basis: no two adjacent particles on the triangular lattice,
    activity z per particle, critical at z_c = (11 + 5 sqrt 5)/2 (the
    default). The MPO bond carries the previous column's (new-row,
    old-row) occupancies, so every adjacency (vertical s_i t_i, horizontal
    s_i s_{i-1}, diagonal s_i t_{i-1}) is excluded locally."""
    if z is None:
        z = (11 + 5 * np.sqrt(5)) / 2
    O = np.zeros((4, 4, 2, 2), dtype)
    for sp in (0, 1):
        for tp in (0, 1):
            for s in (0, 1):
                for t in (0, 1):
                    if s * t or s * sp or s * tp:
                        continue
                    O[2 * sp + tp, 2 * s + t, s, t] = z ** s
    return DenseMPO.from_array(O)


def hard_hexagon_fibonacci(dtype=np.float64) -> DenseMPO:
    """The critical hard-hexagon transfer MPO of the reference's
    Fibonacci-anyon example (MPSKitModels `hard_hexagon()`: the all-ones
    morphism on tau (x) tau with the vacuum fusion channel zeroed, i.e. the
    projector P^tau onto the tau channel; used by reference
    examples/classic2d/1.hard-hexagon/main.jl), expressed exactly in the
    orthonormal fusion-path (height) basis of symmetry/fibonacci.py.

    Derivation. P^tau = 1 - e/phi where e is the Temperley-Lieb element on
    tau (x) tau with loop weight phi; in the path basis between contextual
    heights a_l, a_r the TL matrix elements are
    e^{(a_l=a_r)}_{x,x'} = sqrt(d_x d_x')/d_{a_l}. Composing one projector
    per column along the row threads the horizontal tau line between the
    already-produced upper heights and the pending lower heights, so the
    MPO bond state at a cut is the height PAIR (y, x) = (upper path, path
    after the horizontal tau), constrained to x in y (x) tau — three
    states: (1,tau), (tau,1), (tau,tau). With physical indices p_in = x'
    (lower height after the site) and p_out = y' (upper height after the
    site), the site tensor is

        W[(y,x) -> (y',x')] = delta_{x,y'}
                              - delta_{y,x'} sqrt(d_x d_{y'}) / (phi d_y)

    on fusion-allowed configurations. Validation: the flat ring trace of
    this MPO reproduces the lattice-gas `hard_hexagon(z_c)` transfer
    spectrum ratios exactly on small rings (tests/test_fibonacci.py) — the
    two are the same Baxter partition function at criticality."""
    phi = (1 + np.sqrt(5)) / 2
    d = np.array([1.0, phi])

    def ok(a, b):  # b in a (x) tau
        return not (a == 0 and b == 0)

    pairs = [(y, x) for y in (0, 1) for x in (0, 1) if ok(y, x)]
    P = len(pairs)
    W = np.zeros((P, P, 2, 2), dtype)
    for i, (y, x) in enumerate(pairs):
        for j, (y2, x2) in enumerate(pairs):
            if not ok(x, x2) or not ok(y, y2):
                continue
            val = 0.0
            if x == y2:
                val += 1.0
            if y == x2:
                val -= np.sqrt(d[x] * d[y2]) / (phi * d[y])
            W[i, j, y2, x2] = val
    return DenseMPO.from_array(W)
