"""The PyTorch port's top-level names against the JAX package's: every
name that `mpskit_tpu/__init__.py` binds is an attribute of
`mpskit_tpu_torch`, except those still waiting for their slice, and every
reference export of tests/test_export_parity.py is importable from the
port. The JAX package's names are read from its source with `ast`, so
that the check does not depend on which submodules other tests imported
first."""

import ast
from pathlib import Path

import pytest

import mpskit_tpu_torch
from test_export_parity import REFERENCE_EXPORTS

# names of the JAX package that the port does not have yet (ROADMAP.md,
# queue 1: MeshConfig comes with the device mesh, the last item)
WAITING = {"MeshConfig"}


def _jax_init_names():
    src = (Path(__file__).resolve().parents[1] / "mpskit_tpu"
           / "__init__.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")} | {"__version__"}


def test_every_jax_export_is_in_the_port():
    names = _jax_init_names()
    assert len(names) > 100 and WAITING <= names
    missing = sorted(n for n in names - WAITING
                     if not hasattr(mpskit_tpu_torch, n))
    assert not missing, missing
    # the waiting list holds only what is really missing
    assert not any(hasattr(mpskit_tpu_torch, n) for n in WAITING)


def test_reference_exports_in_the_port():
    missing = [n for n in REFERENCE_EXPORTS
               if not hasattr(mpskit_tpu_torch, n)]
    assert not missing, missing
    for n in ("l_LL", "l_RR", "l_RL", "l_LR",
              "r_LL", "r_RR", "r_RL", "r_LR"):
        assert hasattr(mpskit_tpu_torch.InfiniteMPS, n), n


@pytest.mark.parametrize("name", ["environments", "excitations",
                                  "time_evolve"])
def test_function_names_shadow_their_modules(name):
    """As in the JAX package, `environments` at the top level is the
    dispatching function (the subpackage stays importable by path), and the
    algorithm names are the functions."""
    import importlib

    assert callable(getattr(mpskit_tpu_torch, name))
    if name == "environments":
        mod = importlib.import_module("mpskit_tpu_torch.environments.finite")
        assert hasattr(mod, "finite_environments")
