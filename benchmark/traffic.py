"""The one generator of the benchmark's traffic. A cell of BENCHMARK.json
names a configuration (`configs/<config>.json`: the Hamiltonian's terms,
its parameters and the program's builder of it) and a traffic mix
(`mixes/<traffic>.json`: the kind of work, its sizes, the solver's
settings and the limits of the check). The mix's "kind" names the module
`kinds/<kind>.py` whose `Workload` runs that work through the program's
public entry points; everything else in the mix is parameters of it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry `name` of BENCHMARK.json."""
    spec = load_json(root / "BENCHMARK.json")
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "configs" / f"{name}.json")


def mix(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "mixes" / f"{name}.json")


def dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def program_hamiltonian(cfg: dict, params: dict | None = None):
    """The program's MPOHamiltonian of a configuration, from the builder
    that the configuration names, at its parameters updated by `params`."""
    import mpskit_tpu_torch

    values = {**cfg["params"], **(params or {})}
    prog = cfg["program"]
    kwargs = dict(prog.get("kwargs", {}))
    kwargs.update({p: values[p] for p in prog.get("params", [])})
    return getattr(mpskit_tpu_torch, prog["builder"])(**kwargs)


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of the index-th random start of a run with `seed`:
    the same pair gives the same start, on any device of one type."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    return g


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def workload(cfg: dict, traffic: dict, seed: int, device, root: Path = ROOT):
    """Set up the mix's work: the Workload of benchmark/kinds/<kind>.py,
    built from the seed."""
    name = traffic["kind"]
    kind = load_module(root / "benchmark" / "kinds" / f"{name}.py",
                       f"_kind_{name}")
    return kind.Workload(cfg, traffic, seed, device)
