"""Ground states of a lattice on an infinite cylinder (a configuration
whose "lattice" is infinite along its length, with one column for a unit
cell), refined stage by stage as a user's script runs VUMPS: set-up draws
a random uniform state of one column from the seed and runs the mix's
`warm_iterations`; then each solve is find_groundstate(psi, H, VUMPS(...))
of `iterations_per_solve` iterations from the state the previous solve
returned, and its energy per site is the returned environments'
e_density. The check reads the reference's energy of set-up's cell and of
each returned cell, so solves that hand back their start, or climb, are
caught as well as a reported energy that is not the returned state's.
A unit is one VUMPS iteration, which updates every AC and C of
the cell once (the infinite counterpart of a sweep), counted by the
solver's finalize hook."""

from __future__ import annotations

import mpskit_tpu_torch as mt

from benchmark import traffic
from benchmark.kinds import shared
from benchmark.reference import infinite_lattice, lattice
from benchmark.reference import mps as ref


class Workload:
    unit = "sweep"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.H = traffic.program_hamiltonian(cfg)
        psi = mt.InfiniteMPS.random(
            cfg["lattice"]["width"], cfg["d"], mix["D"],
            traffic.dtype(mix["dtype"]), device,
            traffic.generator(seed, 0, device))
        warm = shared.solver(mix["solver"], None, mix["warm_iterations"])
        self.psi, _, _ = mt.find_groundstate(psi, self.H, warm)
        self.warmed = self.psi.AL
        self.outputs = []

    def work(self, on_unit, keep: bool = True) -> None:
        alg = shared.solver(self.mix["solver"], on_unit,
                            self.mix["iterations_per_solve"])
        self.psi, envs, _ = mt.find_groundstate(self.psi, self.H, alg)
        if keep:
            self.outputs.append((self.psi.AL, float(envs.e_density)))

    def warm(self) -> None:
        """Nothing: set-up's warm iterations ran every shape the solves
        run, the first environment solve from no guess among them."""

    def check(self) -> list:
        """Per solve: e_report, the gap between the energy per site the
        program reported and the reference's energy per site of the AL
        cell it returned, over the reference's; where the mix sets their
        limits, e_rise, the change of the reference's energy per site from
        set-up's cell to the returned cell, over the returned (negative once
        the solves have lowered it: each VUMPS iteration replaces every AC
        and C by the lowest eigenvector of its effective Hamiltonian, and
        solves that hand back their start read 0 however consistent their
        environments are; measured from set-up and not from the solve's
        start, since a converging VUMPS may climb a little in one solve),
        and iso_err, how far the returned cell is from left isometries
        (the program's environments take it to be one)."""
        limits = self.mix["limits"]
        ops = ref.site_operators(self.cfg["site"])
        bonds = lattice.bonds(self.cfg, 2 * self.cfg["lattice"]["width"])

        def e_ref(AL):
            return infinite_lattice.energy(list(AL), bonds, self.cfg["pair"],
                                           ops)

        e_warm = e_ref(self.warmed) if "e_rise" in limits else None
        out = []
        for AL, e in self.outputs:
            e_end = e_ref(AL)
            nums = {"e_report": abs(e - e_end) / abs(e_end)}
            if "e_rise" in limits:
                nums["e_rise"] = (e_end - e_warm) / abs(e_end)
            if "iso_err" in limits:
                nums["iso_err"] = infinite_lattice.isometry_error(AL)
            out.append(nums)
        return out
