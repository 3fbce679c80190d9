"""The device mesh of the PyTorch port on the CPU: gloo process groups of
world 2 (make_mesh(bond=2)) and world 4 (make_mesh(site=2, bond=2)), each
rank a process of tests/torch_mesh_worker.py, against the port's
unsharded runs and the JAX package's sharded runs (its own make_mesh on
the 8 virtual CPU devices of conftest.py), at the sizes of the JAX
package's tests/test_sharding.py (TFIM L=8, D=16, float64 / complex128).

The groups run while this process computes the references. Each rank
starts with one thread, gives its process group a 60 s timeout and is
killed after 120 s, so a deadlock fails the tests instead of hanging
them. Tolerances (JAX's own where it has them): the DMRG sweep's
eigenvalue 1e-10 relative, fidelity |<ref|sharded>| 1e-9, eps 1e-5; the
VUMPS iteration's energy density 1e-10; the TDVP step's 1 - |overlap|
1e-10; full sharded DMRG 1e-8 of ED; RS-DMRG / RS-DMRG2 1e-10 of the JAX
mesh run. A one-rank mesh gives the unsharded sweep, step and iteration
bit for bit."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.algorithms import TDVP as JTDVP
from mpskit_tpu.algorithms import expectation_value as jexpval
from mpskit_tpu.algorithms import find_groundstate_rsdmrg as jrsdmrg
from mpskit_tpu.algorithms import timestep as jtimestep
from mpskit_tpu.algorithms.dmrg import _dmrg_sweep
from mpskit_tpu.algorithms.rsdmrg import RealSpaceParallelDMRG as JRS
from mpskit_tpu.algorithms.vumps import _vumps_iteration
from mpskit_tpu.environments.finite import (
    compute_right_envs as jright_envs, right_boundary as jright_boundary,
    stack_W as jstack_W,
)
from mpskit_tpu.models import transverse_field_ising as jtfim
from mpskit_tpu.parallel.mesh import (
    make_mesh as jmake_mesh, replicate as jreplicate, shard_env as jshard_env,
    shard_finite_mps as jshard_finite, shard_infinite_mps as jshard_infinite,
)
from mpskit_tpu.states import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.tensors.ops import truncdim as jtruncdim
from mpskit_tpu_torch import (
    VUMPS, RealSpaceParallelDMRG, TDVP, config, expectation_value,
    find_groundstate_vumps, timestep, transverse_field_ising, truncdim,
)
from mpskit_tpu_torch.algorithms.dmrg import _dmrg_sweep_impl
from mpskit_tpu_torch.algorithms.rsdmrg import find_groundstate_rsdmrg
from mpskit_tpu_torch.algorithms.vumps import _vumps_iteration_impl
from mpskit_tpu_torch.environments.finite import (
    compute_right_envs, right_boundary, stack_W,
)
from mpskit_tpu_torch.environments.infinite_ham import \
    hamiltonian_environments
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy,
)

torch.set_num_threads(1)

L, D = 8, 16
G_DMRG, G_VUMPS, G_RS = 1.3, 1.4, 1.1
RS_D = 8
WORKER = Path(__file__).with_name("torch_mesh_worker.py")


def _np(x):
    return np.asarray(x)


def _jax_inputs():
    f64, c128 = jnp.float64, jnp.complex128
    states = {
        "dmrg": JFiniteMPS.random(jax.random.PRNGKey(0), L, 2, D, dtype=f64),
        "tdvp": JFiniteMPS.random(jax.random.PRNGKey(3), L, 2, D,
                                  dtype=c128),
        "full": JFiniteMPS.random(jax.random.PRNGKey(0), L, 2, D,
                                  dtype=c128),
        "rs": JFiniteMPS.random(jax.random.PRNGKey(5), L, 2, RS_D,
                                dtype=f64),
    }
    inp = {}
    for k, p in states.items():
        assert p.center == 0
        inp.update({f"{k}_ALs": _np(p.ALs), f"{k}_ARs": _np(p.ARs),
                    f"{k}_AC": _np(p.AC)})
    q = JInfiniteMPS.random(jax.random.PRNGKey(1), 2, 2, 8, dtype=f64)
    inp.update({f"vumps_{f}": _np(getattr(q, f))
                for f in ("AL", "AR", "AC", "C")})
    return states, q, inp


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_groups(tmp, inputs):
    root = str(WORKER.parents[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for world in (1, 2, 4):
        port = _free_port()
        for rank in range(world):
            out = tmp / f"out_{world}_{rank}.npz"
            log = open(tmp / f"log_{world}_{rank}.txt", "w")
            procs.append((world, rank, out, log, subprocess.Popen(
                [sys.executable, str(WORKER), str(world), str(rank),
                 str(port), str(inputs), str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=root)))
    return procs


def _join(procs, tmp, timeout=120):
    import time

    deadline = time.monotonic() + timeout
    failed = []
    for world, rank, out, log, p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            for *_, q in procs:
                q.wait()
        log.close()
        if p.returncode != 0:
            failed.append((world, rank, p.returncode,
                           (tmp / f"log_{world}_{rank}.txt").read_text()
                           [-3000:]))
    assert not failed, failed
    res = {}
    for world, rank, out, _, p in procs:
        res[(world, rank)] = dict(np.load(out))
    return res


def _jax_references(states, q):
    """The JAX package's sharded runs and the port's unsharded ones."""
    ref = {}
    Hj = jtfim(g=G_DMRG, dtype=np.float64)
    p = states["dmrg"]
    Ws = jstack_W(Hj, L).astype(jnp.float64)
    GRs = jright_envs(p.ARs, Ws, jright_boundary(Ws.shape[1], D,
                                                jnp.float64))
    sweep = jax.jit(lambda a, b, c, d, e, f: _dmrg_sweep(a, b, c, d, e, f,
                                                         10, 2))
    for tag, mesh in (("b2", jmake_mesh(bond=2)),
                      ("s2b2", jmake_mesh(site=2, bond=2))):
        ps = jshard_finite(p, mesh)
        out = sweep(ps.ALs, ps.ARs, ps.AC, jreplicate(Ws, mesh),
                    jshard_env(GRs, mesh), jnp.asarray(1e-8))
        ref[f"jax_{tag}"] = (float(out[4]), float(out[5]), _np(out[2]),
                             _np(out[1]))

    # the port, unsharded, on the same inputs
    pt = finite_mps_from_numpy(_np(p.ALs), _np(p.ARs), _np(p.AC), 0, "cpu")
    Ht = transverse_field_ising(g=G_DMRG)
    Wst = stack_W(Ht, L, torch.float64, "cpu")
    GRst = compute_right_envs(pt.ARs, Wst, right_boundary(
        Wst.shape[1], D, torch.float64, "cpu"))
    _, ARs, AC, _, lam, eps, _ = _dmrg_sweep_impl(
        pt.ALs.clone(), pt.ARs.clone(), pt.AC.clone(), Wst, GRst, 1e-8, 10,
        2)
    ref["port_sweep"] = (lam, eps, AC.numpy(), ARs.numpy())

    Hv = jtfim(g=G_VUMPS, period=2, dtype=np.float64)
    for tag, mesh, sites in (("vb2", jmake_mesh(bond=2), False),
                             ("vs2b2", jmake_mesh(site=2, bond=2), True)):
        qo, eps, _, _ = _vumps_iteration(jshard_infinite(q, mesh, sites),
                                         Hv, 10, 2, 1e-10, 1e-10,
                                         jnp.asarray(1e-8))
        ref[f"jax_{tag}"] = (float(eps), [_np(getattr(qo, f)) for f in
                                          ("AL", "AR", "AC", "C")])
    qt = infinite_mps_from_numpy(*(_np(getattr(q, f)) for f in
                                   ("AL", "AR", "AC", "C")), device="cpu")
    with config.matmul_precision():
        qo, eps, envs, _ = _vumps_iteration_impl(
            qt, transverse_field_ising(g=G_VUMPS, period=2), 10, 2, 1e-10,
            1e-10, 1e-8)
    ref["port_vumps"] = (float(eps), float(envs.e_density), qo)

    with config.matmul_precision():
        _, envs, eps = find_groundstate_vumps(qt, transverse_field_ising(
            g=G_VUMPS, period=2), VUMPS(tol=1e-8, maxiter=100, verbosity=0))
    ref["port_vumps_full"] = (float(envs.e_density), eps)

    pt = states["tdvp"]
    out, _ = jtimestep(jshard_finite(pt, jmake_mesh(bond=2)),
                       jtfim(g=G_DMRG), 0.0, 0.05, JTDVP(expalg_m=20))
    ref["jax_tdvp"] = tuple(_np(x) for x in (out.ALs, out.ARs, out.AC))
    ptt = finite_mps_from_numpy(_np(pt.ALs), _np(pt.ARs), _np(pt.AC), 0,
                                "cpu")
    out, _ = timestep(ptt, transverse_field_ising(g=G_DMRG), 0.0, 0.05,
                      TDVP(expalg_m=20))
    ref["port_tdvp"] = (out.ALs.numpy(), out.ARs.numpy(), out.AC.numpy())

    p = states["rs"]
    Hr = jtfim(g=G_RS, dtype=np.float64)
    prt = finite_mps_from_numpy(_np(p.ALs), _np(p.ARs), _np(p.AC), 0, "cpu")
    Hrt = transverse_field_ising(g=G_RS)
    for two_site in (False, True):
        kw = dict(nseg=4, tol=1e-10, maxiter=40, verbosity=0,
                  two_site=two_site)
        psi, envs, _ = jrsdmrg(
            p, Hr, JRS(**kw, trscheme=jtruncdim(RS_D)) if two_site
            else JRS(**kw), mesh=jmake_mesh(site=2, bond=1))
        ref[f"jax_rs{int(two_site) + 1}"] = float(jexpval(psi, Hr,
                                                          envs=envs))
        psi, envs, _ = find_groundstate_rsdmrg(
            prt, Hrt, RealSpaceParallelDMRG(**kw, trscheme=truncdim(RS_D))
            if two_site else RealSpaceParallelDMRG(**kw))
        ref[f"port_rs{int(two_site) + 1}"] = float(expectation_value(
            psi, Hrt, envs=envs))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    states, q, inp = _jax_inputs()
    np.savez(tmp / "inputs.npz", **inp)
    procs = _start_groups(tmp, tmp / "inputs.npz")
    try:
        ref = _jax_references(states, q)
    finally:
        res = _join(procs, tmp)
    return res, ref, inp


def _overlap(a, b):
    """|<a|b>| / (|a| |b|) of two center-0 states as (AC, ARs) pairs."""
    def dot(x, y):
        v = np.einsum("xsm,xsn->mn", x[0].conj(), y[0])
        for i in range(1, x[1].shape[0]):
            v = np.einsum("xy,xsm,ysn->mn", v, x[1][i].conj(), y[1][i])
        return v[0, 0]

    return abs(dot(a, b)) / np.sqrt(abs(dot(a, a)) * abs(dot(b, b)))


def _ranks(res, world):
    return [res[(world, r)] for r in range(world)]


@pytest.mark.parametrize("world,tag", [(2, "b2"), (4, "s2b2")])
def test_dmrg_sweep(runs, world, tag):
    """One sharded sweep against the port's unsharded sweep and the JAX
    package's sweep on its mesh of the same shape: eigenvalue, residual
    and fidelity at the JAX test's bounds; every rank alike, the outputs
    in the input placements, collectives issued."""
    res, ref, _ = runs
    ranks = _ranks(res, world)
    out = ranks[0]
    lam, eps = float(out[f"{tag}_lam"]), float(out[f"{tag}_eps"])
    for other in ranks[1:]:
        assert float(other[f"{tag}_lam"]) == lam
        assert float(other[f"{tag}_eps"]) == eps
        np.testing.assert_array_equal(other[f"{tag}_AC"], out[f"{tag}_AC"])
    mine = (out[f"{tag}_AC"], out[f"{tag}_ARs"])
    for lam_r, eps_r, AC_r, ARs_r in (ref["port_sweep"], ref[f"jax_{tag}"]):
        np.testing.assert_allclose(lam, lam_r, rtol=1e-10)
        np.testing.assert_allclose(eps, eps_r, atol=1e-5)
        np.testing.assert_allclose(_overlap((AC_r, ARs_r), mine), 1.0,
                                   atol=1e-9)
    assert all(bool(r[f"{tag}_placed"]) for r in ranks)
    assert int(out[f"{tag}_collectives"]) > 0


@pytest.mark.parametrize("world", [2, 4])
def test_matvec_operands_have_split_width(runs, world):
    """The matvec's local ket and GR operands are D/bond wide, as are the
    stacks a rank holds."""
    res, _, _ = runs
    tag = "b2" if world == 2 else "s2b2"
    for out in _ranks(res, world):
        assert out[f"{tag}_widths"].tolist() == [[D // 2, D // 2]]
        assert int(out[f"{tag}_local_ARs"]) == D // 2


@pytest.mark.parametrize("world,tag", [(2, "vb2"), (4, "vs2b2")])
def test_vumps_iteration(runs, world, tag):
    """One VUMPS iteration, bonds over "bond" (world 2) and also the unit
    cell over "site" (world 4): eps, the input's energy density and the
    output state's energy density against the unsharded port and the JAX
    mesh run."""
    res, ref, _ = runs
    out = _ranks(res, world)[0]
    eps_u, e_u, q_u = ref["port_vumps"]
    eps_j, tensors_j = ref[f"jax_{tag}"]
    np.testing.assert_allclose(float(out[f"{tag}_eps"]), eps_u, atol=1e-10)
    np.testing.assert_allclose(float(out[f"{tag}_eps"]), eps_j, atol=1e-10)
    np.testing.assert_allclose(float(out[f"{tag}_e_env"]), e_u, atol=1e-12)
    H = transverse_field_ising(g=G_VUMPS, period=2)

    def density(tensors):
        q = infinite_mps_from_numpy(*tensors, device="cpu")
        with config.matmul_precision():
            return float(hamiltonian_environments(q, H).e_density)

    mine = density([out[f"{tag}_{f}"] for f in ("AL", "AR", "AC", "C")])
    assert abs(mine - density([getattr(q_u, f) for f in
                               ("AL", "AR", "AC", "C")])) <= 1e-10
    assert abs(mine - density(tensors_j)) <= 1e-10
    assert all(bool(r[f"{tag}_placed"]) for r in _ranks(res, world))


def test_find_groundstate_vumps_sharded(runs):
    """find_groundstate with VUMPS(tol=1e-8) on a state with its bonds
    over "bond" and its two-site cell over "site": the energy density of
    the unsharded port run to 1e-10, through both the returned
    environments and the replicated expectation_value; eps below tol; the
    state in the input placements, the environments sharded."""
    res, ref, _ = runs
    e_u, _ = ref["port_vumps_full"]
    for out in _ranks(res, 4):
        assert abs(float(out["vfull_e_env"]) - e_u) <= 1e-10
        assert abs(float(out["vfull_e"]) - e_u) <= 1e-10
        assert float(out["vfull_eps"]) < 1e-8
        assert bool(out["vfull_placed"]) and bool(out["vfull_envs_sharded"])


def test_tdvp_step(runs):
    """One complex128 TDVP step through `timestep` on a bond=2 mesh: the
    same state, up to a phase, as the unsharded port's and the JAX mesh
    run's; in the input placements, envs None."""
    res, ref, _ = runs
    for out in _ranks(res, 2):
        mine = (out["tdvp_AC"], out["tdvp_ARs"])
        for _, ARs_r, AC_r in (ref["port_tdvp"], ref["jax_tdvp"]):
            assert 1 - _overlap((AC_r, ARs_r), mine) <= 1e-10
        assert bool(out["tdvp_placed"]) and bool(out["tdvp_envs_none"])


def test_full_sharded_dmrg_matches_ed(runs):
    """find_groundstate on a bond-sharded complex128 state to tol 1e-10,
    its energy through the replicated expectation_value, within 1e-8 of
    exact diagonalization; sharded outputs and environments."""
    res, _, _ = runs
    H = transverse_field_ising(g=1.2)
    E_ed = float(np.linalg.eigvalsh(H.to_matrix(L))[0])
    for out in _ranks(res, 2):
        assert abs(float(out["full_E"]) - E_ed) < 1e-8
        assert float(out["full_eps"]) < 1e-10
        assert bool(out["full_placed"]) and bool(out["full_envs_sharded"])


@pytest.mark.parametrize("variant", [1, 2])
def test_rsdmrg_over_site_axis(runs, variant):
    """RS-DMRG (1) and RS-DMRG2 (2), nseg=4 over the site axis of
    make_mesh(site=2, bond=2): the energy within 1e-10 of the JAX mesh
    run and of the unsharded port run, on every rank; the segments were
    gathered by collectives."""
    res, ref, _ = runs
    for out in _ranks(res, 4):
        E = float(out[f"rs{variant}_E"])
        assert abs(E - ref[f"jax_rs{variant}"]) <= 1e-10
        assert abs(E - ref[f"port_rs{variant}"]) <= 1e-10
        assert int(out[f"rs{variant}_collectives"]) > 0


def test_layouts_round_trip_and_k1_refuses_dtensor(runs):
    """shard_finite_mps / shard_infinite_mps / shard_env / replicate and
    full_tensor() give the input bit for bit; a rank holds D/bond
    columns; K1's wrapper raises TypeError on a DTensor."""
    res, _, _ = runs
    for out in _ranks(res, 2):
        assert bool(out["layout_exact"])
        assert int(out["layout_local_width"]) == D // 2
        assert bool(out["layout_k1_type_error"])


def test_make_mesh_starts_one_rank_group(runs):
    """With no process group and no torchrun, make_mesh(device_type="cpu")
    starts a one-rank gloo group; "cuda" without a card raises and never
    falls back; set_mesh / get_mesh hold a MeshConfig."""
    res, _, _ = runs
    out = res[(1, 0)]
    assert bool(out["single_ok"]) and bool(out["single_cuda_raised"])
    assert bool(out["single_default"])


@pytest.mark.parametrize("loop", ["dmrg", "tdvp", "vumps"])
def test_one_rank_mesh_is_the_unsharded_run(runs, loop):
    """One DMRG sweep, one TDVP step and one VUMPS iteration (its unit cell
    over "site" too) through the BondSplit of a one-rank gloo mesh give
    every output of the same calls with split=None bit for bit: the split
    loops are the unsharded ones, and a collective of one rank changes no
    value."""
    res, _, _ = runs
    out = res[(1, 0)]
    keys = [k for k in out if k.startswith(f"plain_{loop}_")]
    assert len(keys) >= 5
    for k in keys:
        np.testing.assert_array_equal(out["mesh_" + k[len("plain_"):]],
                                      out[k], err_msg=k)
