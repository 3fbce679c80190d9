"""What the kinds share: the solver a mix names, the site tensors of a
returned state as the program laid them out, and the closed forms a
configuration names."""

from __future__ import annotations

import importlib

import mpskit_tpu_torch as mt


def solver(settings: dict, on_unit, maxiter=None):
    """The program's algorithm object of a mix's "solver" settings ("alg"
    names the class; "truncdim" becomes a trscheme), with a finalize hook
    that ends a unit; `maxiter` overrides the solve's length."""
    kw = dict(settings)
    cls = getattr(mt, kw.pop("alg"))
    if "truncdim" in kw:
        kw["trscheme"] = mt.truncdim(kw.pop("truncdim"))
    if maxiter is not None:
        kw["maxiter"] = maxiter
    if on_unit is not None:
        kw["finalize"] = lambda it, psi, H: on_unit()
    return cls(verbosity=0, **kw)


def site_tensors(psi) -> list:
    """A finite state's tensors as returned: left-gauged left of the
    centre, the centre tensor, right-gauged right of it. The reference
    reads them as a plain product of tensors and trusts no gauge."""
    c, L = psi.center, psi.ALs.shape[0]
    return ([psi.ALs[i] for i in range(c)] + [psi.AC]
            + [psi.ARs[i] for i in range(c + 1, L)])


def exact(cfg: dict):
    """The module reference/exact_<name>.py of the configuration's closed
    forms."""
    if not cfg.get("exact"):
        raise ValueError(f"configuration {cfg['name']!r} has no closed form")
    return importlib.import_module(f"benchmark.reference.exact_{cfg['exact']}")
