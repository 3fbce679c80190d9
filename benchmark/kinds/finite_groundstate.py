"""Ground states of an open chain, one solve after another, as a user's
script runs them: find_groundstate(FiniteMPS.random(...), H, alg) with
the mix's DMRG or DMRG2 from a fresh random start drawn from the seed and
the solve's index, then the energy by expectation_value. A unit is a
sweep, counted by the solver's finalize hook."""

from __future__ import annotations

import mpskit_tpu_torch as mt

from benchmark import traffic
from benchmark.kinds import shared
from benchmark.reference import mps as ref


class Workload:
    unit = "sweep"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.L, self.D, self.d = mix["L"], mix["D"], cfg["d"]
        self.dtype = traffic.dtype(mix["dtype"])
        self.H = traffic.program_hamiltonian(cfg)
        self.solves = 0
        self.outputs = []

    def work(self, on_unit, keep: bool = True, maxiter=None) -> None:
        gen = traffic.generator(self.seed, self.solves, self.device)
        self.solves += 1
        psi = mt.FiniteMPS.random(self.L, self.d, self.D, self.dtype,
                                  self.device, gen)
        alg = shared.solver(self.mix["solver"], on_unit, maxiter)
        psi, envs, _ = mt.find_groundstate(psi, self.H, alg)
        E = float(mt.expectation_value(psi, self.H, envs=envs))
        if keep:
            self.outputs.append((psi, E))

    def warm(self) -> None:
        self.work(lambda: None, keep=False, maxiter=1)

    def check(self) -> list:
        """Per solve: e_report, the gap between the energy the program
        reported and the reference's energy of the state it returned;
        e_exact, the reference's energy against the configuration's closed
        form; rel_var, the reference's variance over the energy squared.
        Each only where the mix sets its limit."""
        limits = self.mix["limits"]
        W = ref.mpo(self.cfg)
        e0 = None
        if "e_exact" in limits:
            e0 = shared.exact(self.cfg).open_chain_e0(self.L, self.cfg["params"])
        out = []
        for psi, E in self.outputs:
            As, Wt = ref.as_reference(
                ref.trimmed(shared.site_tensors(psi), self.D), W, self.device)
            e = ref.energy(As, Wt)
            nums = {"e_report": abs(E - e) / abs(e)}
            if e0 is not None:
                nums["e_exact"] = abs(e - e0) / abs(e0)
            if "rel_var" in limits:
                nums["rel_var"] = ref.variance(As, Wt) / e ** 2
            out.append(nums)
        return out
