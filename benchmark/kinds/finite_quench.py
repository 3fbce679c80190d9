"""A quench of an open chain, steps run back to back as a user's script
runs them: set-up finds the ground state of the configuration (the mix's
"start" solver and dtype, from a random start drawn from the seed) and
casts it to the evolution's dtype; each unit is one
timestep(psi, H', t, dt, TDVP(...)) under the Hamiltonian at the mix's
"evolve" parameters."""

from __future__ import annotations

import random

import mpskit_tpu_torch as mt

from benchmark import traffic
from benchmark.kinds import shared
from benchmark.reference import mps as ref


class Workload:
    unit = "step"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.L, self.D, self.d = mix["L"], mix["D"], cfg["d"]
        start, ev = mix["start"], mix["evolve"]
        self.H0 = traffic.program_hamiltonian(cfg)
        self.H1 = traffic.program_hamiltonian(cfg, ev["params"])
        alg = shared.solver(start["solver"], None)
        psi = mt.FiniteMPS.random(self.L, self.d, self.D,
                                  traffic.dtype(start["dtype"]), device,
                                  traffic.generator(seed, 0, device))
        psi, _, _ = mt.find_groundstate(psi, self.H0, alg)
        c = traffic.dtype(ev["dtype"])
        self.start = mt.FiniteMPS(psi.ALs.to(c), psi.ARs.to(c), psi.AC.to(c),
                                  psi.center)
        self.dt = ev["dt"]
        self.alg = shared.solver(ev["solver"], None)
        self.psi, self.t = self.start, 0.0
        self.states = [self.start]

    def work(self, on_unit, keep: bool = True) -> None:
        self.psi, _ = mt.timestep(self.psi, self.H1, self.t, self.dt,
                                  self.alg)
        self.t += self.dt
        if keep:
            self.states.append(self.psi)
        on_unit()

    def warm(self) -> None:
        mt.timestep(self.start, self.H1, 0.0, self.dt, self.alg)

    def check(self) -> list:
        """The start: gs_exact, the reference's energy of the ground state
        against the closed form. Every step k: e_drift, the reference's
        energy under H' against the start's (one-site TDVP conserves it),
        and norm_err, the norm against the start's. On the last step and
        on steps drawn from the seed: step_gap, 1 - |<psi_k|phi>| of the
        unit vectors, phi the reference's own step from psi_{k-1}."""
        limits = self.mix["limits"]
        W0 = ref.mpo(self.cfg)
        W1 = ref.mpo(self.cfg, self.mix["evolve"]["params"])
        states = [ref.as_reference(ref.trimmed(shared.site_tensors(p),
                                               self.D), W1, self.device)[0]
                  for p in self.states]
        W0t = ref.as_reference(states[0], W0, self.device)[1]
        W1t = ref.as_reference(states[0], W1, self.device)[1]
        out = []
        if "gs_exact" in limits:
            e0 = shared.exact(self.cfg).open_chain_e0(self.L, self.cfg["params"])
            out.append({"gs_exact": abs(ref.energy(states[0], W0t) - e0)
                        / abs(e0)})
        last = len(states) - 1
        drawn = random.Random(self.seed).sample(
            range(1, last), min(self.mix["reference_steps"] - 1, last - 1))
        e_start, n_start = ref.energy(states[0], W1t), ref.norm2(states[0])
        for k in range(1, last + 1):
            nums = {"e_drift": abs(ref.energy(states[k], W1t) - e_start)
                    / abs(e_start),
                    "norm_err": abs((ref.norm2(states[k]) / n_start) ** 0.5
                                    - 1)}
            if k == last or k in drawn:
                phi = ref.tdvp_step(states[k - 1], W1t, self.dt)
                nums["step_gap"] = 1 - ref.fidelity(states[k], phi)
            out.append(nums)
        return out
