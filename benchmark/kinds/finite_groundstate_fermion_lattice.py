"""Ground states of a lattice of spin-1/2 fermions wrapped into an open
chain (a configuration whose "site" is {"kind": "spinful_fermion"}, with a
"lattice", its "bonds" and its "onsite" terms), one solve after another
exactly as `finite_groundstate` runs them: the same seeded random starts,
solves, warm-up and units. Only the check differs: the reference's MPO,
Jordan-Wigner strings and all, is built per site from the configuration
(reference/fermion_lattice.py)."""

from __future__ import annotations

from benchmark.kinds import finite_groundstate, shared
from benchmark.reference import fermion_lattice
from benchmark.reference import mps as ref


class Workload(finite_groundstate.Workload):
    def check(self) -> list:
        """Per solve: e_report, the gap between the energy the program
        reported and the reference's energy of the state it returned;
        rel_var, the reference's variance over the energy squared, where
        the mix sets its limit."""
        limits = self.mix["limits"]
        Ws = fermion_lattice.mpo(self.cfg, self.L)
        out = []
        for psi, E in self.outputs:
            As, Wt = ref.as_reference(
                ref.trimmed(shared.site_tensors(psi), self.D), Ws, self.device)
            e = fermion_lattice.energy(As, Wt)
            nums = {"e_report": abs(E - e) / abs(e)}
            if "rel_var" in limits:
                nums["rel_var"] = fermion_lattice.variance(As, Wt) / e ** 2
            out.append(nums)
        return out
