"""Checkpoints and PeriodicArray of the PyTorch port against the JAX
package on the CPU: a save / load round trip of every ported container
(FiniteMPS, InfiniteMPS, WindowMPS, MPSMultiline, LeftGaugedQP), a
checkpoint that the JAX package wrote loaded by the port and the reverse,
bit for bit, the symmetric containers (their modulus kept), the anyonic
container (its category rebuilt by name), and PeriodicArray's indexing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpskit_tpu.states.finitemps import FiniteMPS as JFiniteMPS
from mpskit_tpu.states.infinitemps import InfiniteMPS as JInfiniteMPS
from mpskit_tpu.states.multiline import MPSMultiline as JMultiline
from mpskit_tpu.states.quasiparticle import LeftGaugedQP as JLeftGaugedQP
from mpskit_tpu.states.quasiparticle import null_spaces as jnull_spaces
from mpskit_tpu.states.windowmps import WindowMPS as JWindowMPS
from mpskit_tpu.utils import periodic as jperiodic
from mpskit_tpu.utils import serialize as jser
from mpskit_tpu_torch import (
    FiniteMPS, InfiniteMPS, LeftGaugedQP, MPSMultiline, PeriodicArray,
    PeriodicVector, WindowMPS, load_state, save_state,
)
from mpskit_tpu_torch.utils import serialize as tser

torch.set_num_threads(1)

KINDS = ["FiniteMPS", "InfiniteMPS", "WindowMPS", "MPSMultiline",
         "LeftGaugedQP"]


def _jax_state(kind):
    """A JAX container of each kind, made from PRNGKeys."""
    ipsi = JInfiniteMPS.random(jax.random.PRNGKey(0), 2, 2, 5,
                               dtype=jnp.complex128)
    if kind == "FiniteMPS":
        return JFiniteMPS.random(jax.random.PRNGKey(1), 5, 2, 6,
                                 dtype=jnp.complex128).move_center(2)
    if kind == "InfiniteMPS":
        return ipsi
    if kind == "WindowMPS":
        return JWindowMPS.from_infinite(ipsi, 4, 6).grow(1, 0)
    if kind == "MPSMultiline":
        other = JInfiniteMPS.random(jax.random.PRNGKey(2), 2, 2, 5)
        return JMultiline((ipsi, other))
    VLs = jnull_spaces(ipsi.AL)
    Xs = jax.random.normal(jax.random.PRNGKey(3), (2, VLs.shape[-1], 5))
    return JLeftGaugedQP(Xs.astype(jnp.complex128), VLs, ipsi, ipsi,
                         jnp.asarray(0.5), True)


def _jax_leaves(psi):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(psi)]


def _torch_leaves(psi):
    return [t.numpy() for t in tser._leaves(psi)]


def _statics(psi):
    if isinstance(psi, (FiniteMPS, JFiniteMPS)):
        return (psi.center,)
    if isinstance(psi, (WindowMPS, JWindowMPS)):
        return (psi.window.center,)
    if isinstance(psi, (MPSMultiline, JMultiline)):
        return (len(psi.rows),)
    if isinstance(psi, (LeftGaugedQP, JLeftGaugedQP)):
        return (float(psi.momentum), bool(psi.trivial))
    return ()


def _equal(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_in_the_port_and_back(kind, tmp_path):
    """A checkpoint the JAX package wrote loads in the port (on the CPU as
    asked) bit for bit; the port's round trip and its checkpoint loaded
    by the JAX package give the same tensors and static data again."""
    pj = _jax_state(kind)
    jpath = str(tmp_path / "jax.npz")
    jser.save_state(jpath, pj)
    pt = load_state(jpath, device="cpu")
    assert type(pt).__name__ == kind
    _equal(_torch_leaves(pt), _jax_leaves(pj))
    assert _statics(pt) == _statics(pj)
    assert all(t.device.type == "cpu" for t in tser._leaves(pt))

    tpath = str(tmp_path / "torch.npz")
    save_state(tpath, pt)
    again = load_state(tpath, device="cpu")
    assert type(again) is type(pt) and _statics(again) == _statics(pt)
    _equal(_torch_leaves(again), _torch_leaves(pt))
    back = jser.load_state(tpath)
    assert type(back).__name__ == kind and _statics(back) == _statics(pj)
    _equal(_jax_leaves(back), _jax_leaves(pj))


def test_port_states_round_trip(tmp_path):
    """States the port made (float32 included) round-trip unchanged; a
    window keeps its center and its two sides."""
    gen = torch.Generator().manual_seed(0)
    psi = InfiniteMPS.random(1, 2, 4, torch.float32, "cpu", gen)
    fin = FiniteMPS.random(4, 2, 4, torch.float32, "cpu", gen)
    win = WindowMPS.from_infinite(psi, 5, 6, device="cpu").grow(1, 1)
    for state in (psi, fin, win):
        path = str(tmp_path / "s.npz")
        save_state(path, state)
        out = load_state(path, device="cpu")
        assert type(out) is type(state) and _statics(out) == _statics(state)
        _equal(_torch_leaves(out), _torch_leaves(state))


def _masks(state):
    m = state.masks
    return m if isinstance(m, tuple) else (m,)


def _symmetric_state(name, modulus):
    """A random symmetric container of the port on the CPU: spin-1/2
    charges (1, -1) for U(1), parity charges (0, 1) for modulus 2."""
    from mpskit_tpu_torch import SymmetricFiniteMPS, SymmetricInfiniteMPS

    gen = torch.Generator().manual_seed(5)
    phys = (1, -1) if modulus is None else (0, 1)
    if name == "SymmetricFiniteMPS":
        return SymmetricFiniteMPS.random(6, phys, 6, 0, torch.float64,
                                         modulus, "cpu", gen)
    return SymmetricInfiniteMPS.random(2, phys, 6, torch.complex128,
                                       modulus, "cpu", gen)


@pytest.mark.parametrize("name", ["SymmetricFiniteMPS",
                                  "SymmetricInfiniteMPS",
                                  "AnyonicInfiniteMPS"])
def test_symmetric_containers_name_item_11(name, tmp_path):
    """The anyonic container round-trips in both packages' layout: a JAX
    AnyonicInfiniteMPS checkpoint loads in the port with its labels,
    anyon and category (rebuilt by name), and the port's loads in the JAX
    package, bit for bit. The abelian symmetric containers are ported: a Z_2 state (modulus 2, which the JAX package's
    layout drops) and a U(1) state round-trip with their labels, modulus
    and masks, bit for bit; a stand-in is no container."""
    if name != "AnyonicInfiniteMPS":
        for modulus in (2, None):
            state = _symmetric_state(name, modulus)
            path = str(tmp_path / f"s{modulus}.npz")
            save_state(path, state)
            back = load_state(path, device="cpu")
            assert type(back) is type(state) and back.modulus == modulus
            assert back.phys_charges == state.phys_charges
            for a, b in zip(back.bond_charges, state.bond_charges):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(_masks(back), _masks(state)):
                np.testing.assert_array_equal(a, b)
            _equal(_torch_leaves(back), _torch_leaves(state))
            if modulus is not None:
                # what the JAX layout reloads: the same labels as U(1),
                # with other masks
                u1 = dataclasses.replace(state, modulus=None)
                assert any(not np.array_equal(a, b) for a, b in
                           zip(_masks(u1), _masks(state)))
        with pytest.raises(TypeError):
            save_state(str(tmp_path / "x.npz"), type(name, (), {})())
        return
    from mpskit_tpu.symmetry import AnyonicInfiniteMPS as JAnyonic
    from mpskit_tpu.symmetry import ising_category as jising

    jpsi = JAnyonic.random(jax.random.PRNGKey(4), jising(), 1, D=6, L=2,
                           seed=(1,))
    path = str(tmp_path / "y.npz")
    jser.save_state(path, jpsi)
    back = load_state(path, device="cpu")
    assert type(back).__name__ == name and back.anyon == 1
    assert back.labels == jpsi.labels and back.cat.name == "Ising"
    np.testing.assert_array_equal(back.cat.F, jpsi.cat.F)
    _equal(_torch_leaves(back), _jax_leaves(jpsi.state))
    for a, b in zip(back.masks, jpsi.masks):
        np.testing.assert_array_equal(a, b)
    path2 = str(tmp_path / "x.npz")
    save_state(path2, back)
    again = jser.load_state(path2)
    assert again.labels == jpsi.labels and again.cat.name == "Ising"
    _equal(_jax_leaves(again.state), _jax_leaves(jpsi.state))
    with pytest.raises(TypeError):
        save_state(str(tmp_path / "z.npz"), object())


def test_periodic_array():
    """Indexing, slices, assignment, iteration, repeat and equality as the
    JAX package's PeriodicArray gives them."""
    data = [10, 11, 12]
    p, q = PeriodicArray(data), jperiodic.PeriodicArray(data)
    assert PeriodicVector is PeriodicArray
    for i in range(-7, 8):
        assert p[i] == q[i]
    for sl in (slice(None), slice(-2, 5), slice(1, 7, 2)):
        assert p[sl] == q[sl]
    assert list(p) == list(q) and len(p) == len(q) == 3
    assert p.repeat(2).data == q.repeat(2).data
    p[-1] = 5
    q[-1] = 5
    assert p.data == q.data == [10, 11, 5] and p == PeriodicArray(p.data)
    assert repr(p) == "PeriodicArray([10, 11, 5])"
    with pytest.raises(ValueError):
        PeriodicArray([])
