"""Percent of the wall time of sweeps in the site (DMRG) or bond (DMRG2)
eigensolves, linalg/lanczos.py eigsh_smallest (K1 inside the one-site
ones): a split by synchronizations over a few sweeps after the window."""

from benchmark.profiling import split_share

SPLIT = [
    'mpskit_tpu_torch.algorithms.dmrg:eigsh_smallest',
    'mpskit_tpu_torch.algorithms.dmrg2:eigsh_smallest',
]


def read(rec):
    return split_share(rec, "sweep", SPLIT)
