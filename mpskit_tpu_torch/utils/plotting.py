"""Plotting helpers (counterpart of mpskit_tpu/utils/plotting.py).

The `*_data` functions return host numpy arrays, so they work without a
display and without matplotlib; the plot functions import matplotlib
when they are called."""

from __future__ import annotations

import numpy as np


def entanglement_plot_data(psi, bond=None):
    """Schmidt spectrum at a bond, sorted descending, zeros dropped."""
    from ..algorithms.toolbox import entanglement_spectrum

    S = entanglement_spectrum(psi, bond).cpu().numpy()
    S = S[S > 1e-30]
    return np.sort(S)[::-1]


def transfer_plot_data(psi, num: int = 10):
    """(theta, r) polar coordinates of the leading transfer eigenvalues."""
    from ..algorithms.toolbox import transfer_spectrum

    lams = transfer_spectrum(psi, num=num).cpu().numpy()
    return np.angle(lams), np.abs(lams)


def entanglement_plot(psi, bond=None, ax=None):
    import matplotlib.pyplot as plt

    S = entanglement_plot_data(psi, bond)
    if ax is None:
        _, ax = plt.subplots()
    ax.semilogy(np.arange(1, len(S) + 1), S, "o")
    ax.set_xlabel("index")
    ax.set_ylabel("Schmidt value")
    return ax


def transfer_plot(psi, num: int = 10, ax=None):
    import matplotlib.pyplot as plt

    theta, r = transfer_plot_data(psi, num)
    if ax is None:
        _, ax = plt.subplots(subplot_kw={"projection": "polar"})
    ax.plot(theta, r, "x")
    return ax


def entanglement_plot_data_sectors(psi, bond=None):
    """{sector label: Schmidt values} of an abelian-symmetric state (a
    SymmetricFiniteMPS at `bond`, the middle one by default, or a
    SymmetricInfiniteMPS at a unit-cell bond, the last by default); a
    plain state gives {None: its spectrum}. The SU(2)-reduced states come
    with queue-1 item 11 (ROADMAP.md)."""
    from ..symmetry.charges import (
        SymmetricFiniteMPS, SymmetricInfiniteMPS,
        sector_entanglement_spectrum, sector_entanglement_spectrum_infinite,
    )

    if isinstance(psi, SymmetricFiniteMPS):
        if bond is None:
            bond = psi.state.length // 2
        return sector_entanglement_spectrum(psi, bond)
    if isinstance(psi, SymmetricInfiniteMPS):
        return sector_entanglement_spectrum_infinite(
            psi, -1 if bond is None else bond)
    if type(psi).__name__ == "SU2ReducedState":
        raise NotImplementedError(
            "the sector spectrum of an SU2ReducedState comes with queue-1 "
            "item 11 (ROADMAP.md)")
    return {None: entanglement_plot_data(psi, bond)}


def entanglement_plot_sectors(psi, bond=None, ax=None):
    """Render the sector-resolved Schmidt spectrum, one labelled series per
    charge sector."""
    import matplotlib.pyplot as plt

    data = entanglement_plot_data_sectors(psi, bond)
    if ax is None:
        _, ax = plt.subplots()
    for q, vals in sorted(data.items(), key=lambda kv: str(kv[0])):
        vals = np.asarray(vals)
        vals = np.sort(vals[vals > 1e-30])[::-1]
        ax.semilogy(np.arange(1, len(vals) + 1), vals, "o",
                    label=f"sector {q}")
    ax.set_xlabel("index")
    ax.set_ylabel("Schmidt value")
    ax.legend()
    return ax
