"""Iteration logging (counterpart of mpskit_tpu/utils/logging.py): INIT /
ITER / CONV / CANCEL lines gated by a verbosity level, as host `logging`
calls."""

from __future__ import annotations

import logging

from ..config import VERBOSE_CONV, VERBOSE_ITER, VERBOSE_WARN

logger = logging.getLogger("mpskit_tpu_torch")


class IterLog:
    def __init__(self, name: str, verbosity: int):
        self.name = name
        self.verbosity = verbosity

    def init(self, msg: str = ""):
        if self.verbosity >= VERBOSE_ITER:
            logger.info("%s: init %s", self.name, msg)

    def conv(self, it, objective, error):
        if self.verbosity >= VERBOSE_CONV:
            logger.info("%s: converged after %d iterations: obj = %s, "
                        "err = %s", self.name, it, objective, error)

    def solver_warn(self, it, diag, tol):
        """Warn about unconverged inner solves: diag is the sweep's
        (n_unconverged, worst_residual), reported once per outer
        iteration."""
        if self.verbosity < VERBOSE_WARN:
            return
        n, resid = diag
        if n > 0:
            logger.warning("%s: iteration %d: %d inner solve(s) not "
                           "converged to tol %.2e (worst residual %.4e)",
                           self.name, it, n, tol, resid)

    def cancel(self, it, objective, error):
        if self.verbosity >= VERBOSE_WARN:
            logger.warning("%s: not converged after %d iterations: "
                           "obj = %s, err = %s", self.name, it, objective,
                           error)
