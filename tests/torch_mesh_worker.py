"""One rank of a gloo process group on the CPU, for tests/test_torch_mesh.py.

    python tests/torch_mesh_worker.py WORLD RANK PORT INPUTS.npz OUT.npz

The inputs are numpy arrays made by the test from the JAX package's seeded
states. World 2 runs on make_mesh(bond=2): one-site DMRG sweep, VUMPS
iteration, finite TDVP step, full DMRG and the layout checks. World 4
runs on make_mesh(site=2, bond=2): the DMRG sweep, the VUMPS iteration
and a converged VUMPS run with the unit cell over "site", and RS-DMRG /
RS-DMRG2 with their segments over "site". World 1 starts no group:
make_mesh starts its own, on which the DMRG sweep, the TDVP step and the
VUMPS iteration run through the split and with split=None. Every rank
writes its results to OUT.npz. The module imports torch and the port only
(a test module imports jax, and `tests/` is no package)."""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from mpskit_tpu_torch import (
    DMRG, TDVP, VUMPS, MeshConfig, RealSpaceParallelDMRG, config,
    expectation_value, find_groundstate, timestep, transverse_field_ising,
    truncdim,
)
from mpskit_tpu_torch.algorithms import derivatives
from mpskit_tpu_torch.algorithms.dmrg import _dmrg_sweep_impl
from mpskit_tpu_torch.algorithms.rsdmrg import find_groundstate_rsdmrg
from mpskit_tpu_torch.algorithms.tdvp import _timestep_finite
from mpskit_tpu_torch.algorithms.vumps import _vumps_iteration_impl
from mpskit_tpu_torch.environments.finite import (
    compute_left_envs, compute_right_envs, left_boundary, right_boundary,
    stack_W,
)
from mpskit_tpu_torch.interop import (
    finite_mps_from_numpy, infinite_mps_from_numpy,
)
from mpskit_tpu_torch.kernels.ac_apply import ac_apply_bf16
from mpskit_tpu_torch.parallel import (
    make_mesh, replicate, shard_env, shard_finite_mps, shard_infinite_mps,
)
from mpskit_tpu_torch.parallel import split
from mpskit_tpu_torch.parallel.sharded import FiniteShards, InfiniteShards
from mpskit_tpu_torch.states.finitemps import support_mask

G_DMRG, G_VUMPS, G_RS = 1.3, 1.4, 1.1


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _finite(inp, key):
    return finite_mps_from_numpy(inp[key + "_ALs"], inp[key + "_ARs"],
                                 inp[key + "_AC"], 0, device="cpu")


def _same_placements(a, b):
    return all(tuple(getattr(a, f).placements) == tuple(
        getattr(b, f).placements) for f in a.__dataclass_fields__
        if hasattr(getattr(a, f), "placements"))


def dmrg_sweep_case(mesh, inp, tag):
    """One sweep (krylovdim 10, 2 restarts, inner tol 1e-8) of the JAX
    test's start state; the widths of the matvec's local operands."""
    psi = _finite(inp, "dmrg")
    L, D = psi.length, psi.D
    H = transverse_field_ising(g=G_DMRG)
    psi_s = shard_finite_mps(psi, mesh)
    shards = FiniteShards(psi_s)
    sp = shards.split
    ALs, ARs, AC = shards.locals(psi_s)
    Ws = stack_W(H, L, torch.float64, "cpu")
    GRs = compute_right_envs(ARs, Ws, right_boundary(
        Ws.shape[1], D, torch.float64, "cpu"), split=sp)
    widths = set()
    plain = derivatives.ac_apply

    def spy(GL, W, GR, x):
        widths.add((x.shape[-1], GR.shape[-1]))
        return plain(GL, W, GR, x)

    derivatives.ac_apply = spy
    split.collectives = 0
    try:
        ALs, ARs, AC, GRs, lam, eps, diag = _dmrg_sweep_impl(
            ALs, ARs, AC, Ws, GRs, 1e-8, 10, 2, split=sp)
    finally:
        derivatives.ac_apply = plain
    out = shards.state(ALs, ARs, AC)
    return {f"{tag}_lam": lam, f"{tag}_eps": eps,
            f"{tag}_ALs": _np(out.ALs), f"{tag}_ARs": _np(out.ARs),
            f"{tag}_AC": _np(out.AC), f"{tag}_widths": sorted(widths),
            f"{tag}_local_ARs": ARs.shape[-1],
            f"{tag}_collectives": split.collectives,
            f"{tag}_placed": _same_placements(out, psi_s)}


def vumps_case(mesh, inp, tag, shard_sites):
    """One VUMPS iteration (krylovdim 10, 2 restarts, tolerances as in the
    JAX test) of the two-site cell."""
    psi = infinite_mps_from_numpy(*(inp["vumps_" + f] for f in
                                    ("AL", "AR", "AC", "C")), device="cpu")
    H = transverse_field_ising(g=G_VUMPS, period=2)
    psi_s = shard_infinite_mps(psi, mesh, shard_sites=shard_sites)
    shards = InfiniteShards(psi_s)
    with config.matmul_precision():
        q, eps, envs, diag = _vumps_iteration_impl(
            shards.whole(psi_s), H, 10, 2, 1e-10, 1e-10, 1e-8,
            split=shards.split, site=shards.site)
    out = shards.state(q)
    res = {f"{tag}_eps": float(eps), f"{tag}_e_env": float(envs.e_density),
           f"{tag}_placed": _same_placements(out, psi_s)}
    for f in ("AL", "AR", "AC", "C"):
        res[f"{tag}_{f}"] = _np(getattr(out, f))
    return res


def vumps_full_case(mesh, inp):
    """find_groundstate(sharded, H, VUMPS(tol=1e-8)) with the unit cell
    over "site", and its energy density through the replicated
    expectation_value."""
    psi = infinite_mps_from_numpy(*(inp["vumps_" + f] for f in
                                    ("AL", "AR", "AC", "C")), device="cpu")
    H = transverse_field_ising(g=G_VUMPS, period=2)
    psi_s = shard_infinite_mps(psi, mesh, shard_sites=True)
    out, envs, eps = find_groundstate(psi_s, H, VUMPS(tol=1e-8,
                                                      maxiter=100,
                                                      verbosity=0))
    e = float(np.real(_np(expectation_value(out, H)).mean()))
    return {"vfull_e": e, "vfull_eps": eps,
            "vfull_e_env": float(envs.e_density),
            "vfull_placed": _same_placements(out, psi_s),
            "vfull_envs_sharded": hasattr(envs.GLs, "placements")}


def tdvp_case(mesh, inp):
    """One complex128 TDVP step (dt 0.05, expalg_m 20) through timestep."""
    psi = _finite(inp, "tdvp")
    H = transverse_field_ising(g=G_DMRG)
    psi_s = shard_finite_mps(psi, mesh)
    out, envs = timestep(psi_s, H, 0.0, 0.05, TDVP(expalg_m=20))
    return {"tdvp_ALs": _np(out.ALs), "tdvp_ARs": _np(out.ARs),
            "tdvp_AC": _np(out.AC), "tdvp_placed": _same_placements(
                out, psi_s), "tdvp_envs_none": envs is None}


def full_dmrg_case(mesh, inp):
    """find_groundstate(sharded, H, DMRG(tol=1e-10, maxiter=50)) and its
    energy through the replicated expectation_value."""
    psi = _finite(inp, "full")
    H = transverse_field_ising(g=1.2)
    psi_s = shard_finite_mps(psi, mesh)
    out, envs, eps = find_groundstate(psi_s, H, DMRG(tol=1e-10, maxiter=50))
    E = float(np.real(complex(expectation_value(out, H, envs=envs))))
    return {"full_E": E, "full_eps": eps,
            "full_placed": _same_placements(out, psi_s),
            "full_envs_sharded": hasattr(envs.GLs, "placements")
            and hasattr(envs.GRs, "placements")}


def layout_case(mesh, inp):
    """shard_* and replicate hand back the input bit for bit; a DTensor
    given to kernel K1's wrapper raises TypeError."""
    psi = _finite(inp, "dmrg")
    ps = shard_finite_mps(psi, mesh)
    qi = infinite_mps_from_numpy(*(inp["vumps_" + f] for f in
                                   ("AL", "AR", "AC", "C")), device="cpu")
    qs = shard_infinite_mps(qi, mesh)
    G = torch.from_numpy(inp["dmrg_ALs"])
    exact = all(torch.equal(a.full_tensor(), b) for a, b in (
        (ps.ALs, psi.ALs), (ps.ARs, psi.ARs), (ps.AC, psi.AC),
        (qs.AL, qi.AL), (qs.C, qi.C), (shard_env(G, mesh), G),
        (replicate(G, mesh), G)))
    local_w = ps.ALs.to_local().shape[-1]
    x = ps.AC.to(torch.float32)
    try:
        ac_apply_bf16(x, x, x, x)
        k1_type_error = False
    except TypeError:
        k1_type_error = True
    return {"layout_exact": exact, "layout_local_width": local_w,
            "layout_k1_type_error": k1_type_error}


def rs_case(mesh, inp):
    """RS-DMRG and RS-DMRG2 (nseg=4) with the segments over "site"."""
    psi = _finite(inp, "rs")
    H = transverse_field_ising(g=G_RS)
    res = {}
    for two_site in (False, True):
        kw = dict(nseg=4, tol=1e-10, maxiter=40, verbosity=0,
                  two_site=two_site)
        if two_site:
            kw["trscheme"] = truncdim(psi.D)
        split.collectives = 0
        out, envs, eps = find_groundstate_rsdmrg(
            psi, H, RealSpaceParallelDMRG(**kw), mesh=mesh)
        E = float(np.real(complex(expectation_value(out, H, envs=envs))))
        res[f"rs{int(two_site) + 1}_E"] = E
        res[f"rs{int(two_site) + 1}_collectives"] = split.collectives
    return res


def single_case():
    """No process group and no torchrun: make_mesh starts a one-rank gloo
    group; a card is never replaced by the CPU."""
    try:
        make_mesh(device_type="cuda")
        cuda_raised = torch.cuda.is_available()
    except RuntimeError:
        cuda_raised = True
    mesh = make_mesh(device_type="cpu")
    config.set_mesh(MeshConfig(mesh=mesh))
    ok = (dist.is_initialized() and dist.get_backend() == "gloo"
          and tuple(mesh.shape) == (1, 1)
          and config.get_mesh().mesh is mesh)
    config.set_mesh(MeshConfig.single_device())
    return {"single_ok": ok, "single_cuda_raised": cuda_raised,
            "single_default": config.get_mesh().mesh is None}


def one_rank_case(mesh, inp):
    """One DMRG sweep, one TDVP step and one VUMPS iteration through the
    BondSplit of a one-rank mesh, and the same calls with split=None on
    the same inputs: every output of each, under "mesh_*" and "plain_*"."""
    res = {}
    psi = _finite(inp, "dmrg")
    L, D, d = psi.length, psi.D, psi.physicaldim
    masks = torch.as_tensor(support_mask(L, d, D))
    Ws = stack_W(transverse_field_ising(g=G_DMRG), L, torch.float64, "cpu")
    GRL = right_boundary(Ws.shape[1], D, torch.float64, "cpu")
    GL0 = left_boundary(Ws.shape[1], D, torch.float64, "cpu")
    shards = FiniteShards(shard_finite_mps(psi, mesh))
    for tag, sp in (("plain", None), ("mesh", shards.split)):
        ALs, ARs, AC = (shards.locals(shards.psi) if sp else
                        (psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()))
        GRs = compute_right_envs(ARs, Ws, GRL, split=sp)
        out = _dmrg_sweep_impl(ALs, ARs, AC, Ws, GRs, 1e-8, 10, 2,
                               masks=masks, split=sp)
        GLs = compute_left_envs(out[0], Ws, GL0, split=sp)
        for k, v in zip(("ALs", "ARs", "AC", "GRs", "lam", "eps"), out):
            res[f"{tag}_dmrg_{k}"] = _np(v)
        res[f"{tag}_dmrg_GLs"] = _np(GLs)

    psi = _finite(inp, "tdvp")
    mk = masks.to(psi.dtype)
    Ws = stack_W(transverse_field_ising(g=G_DMRG), L, psi.dtype, "cpu")
    GRL = right_boundary(Ws.shape[1], D, psi.dtype, "cpu")
    shards = FiniteShards(shard_finite_mps(psi, mesh))
    for tag, sp in (("plain", None), ("mesh", shards.split)):
        ALs, ARs, AC = (shards.locals(shards.psi) if sp else
                        (psi.ALs, psi.ARs, psi.AC))
        ALs, ARs, AC = ALs * mk, ARs * mk, AC * mk[0]
        GRs = compute_right_envs(ARs, Ws, GRL, split=sp)
        out = _timestep_finite(ALs, ARs, AC, Ws, GRs, 20, dt=0.05,
                               masks=masks, split=sp)
        for k, v in zip(("ALs", "ARs", "AC", "GRs", "err"), out):
            res[f"{tag}_tdvp_{k}"] = _np(v)

    q = infinite_mps_from_numpy(*(inp["vumps_" + f] for f in
                                  ("AL", "AR", "AC", "C")), device="cpu")
    H = transverse_field_ising(g=G_VUMPS, period=2)
    shards = InfiniteShards(shard_infinite_mps(q, mesh, shard_sites=True))
    for tag, sp, site in (("plain", None, None),
                          ("mesh", shards.split, shards.site)):
        with config.matmul_precision():
            qo, eps, envs, diag = _vumps_iteration_impl(
                shards.whole(shards.psi) if sp else q, H, 10, 2, 1e-10,
                1e-10, 1e-8, split=sp, site=site)
        for f in ("AL", "AR", "AC", "C"):
            res[f"{tag}_vumps_{f}"] = _np(getattr(qo, f))
        res.update({f"{tag}_vumps_eps": _np(eps),
                    f"{tag}_vumps_GLs": _np(envs.GLs),
                    f"{tag}_vumps_GRs": _np(envs.GRs),
                    f"{tag}_vumps_e": _np(envs.e_density),
                    f"{tag}_vumps_diag": np.asarray(diag)})
    return res


def main(world, rank, port, inputs, out):
    torch.set_num_threads(1)
    inp = dict(np.load(inputs))
    if world == 1:
        res = single_case()
        res.update(one_rank_case(make_mesh(device_type="cpu"), inp))
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        if world == 2:
            mesh = make_mesh(bond=2, device_type="cpu")
            res = dmrg_sweep_case(mesh, inp, "b2")
            res.update(vumps_case(mesh, inp, "vb2", shard_sites=False))
            res.update(tdvp_case(mesh, inp))
            res.update(full_dmrg_case(mesh, inp))
            res.update(layout_case(mesh, inp))
        else:
            mesh = make_mesh(site=2, bond=2, device_type="cpu")
            res = dmrg_sweep_case(mesh, inp, "s2b2")
            res.update(vumps_case(mesh, inp, "vs2b2", shard_sites=True))
            res.update(vumps_full_case(mesh, inp))
            res.update(rs_case(mesh, inp))
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
