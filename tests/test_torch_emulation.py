"""Spaces and emulation of the PyTorch port against the JAX package.

For every entry of the mock-space suite (MOCK_OBSERVATION_SPACES,
MOCK_ACTION_SPACES), both packages emulate the same space: the flat
spaces' repr, the structured dtypes and the nativize_dtype specs must be
equal. A batch of observations made with numpy from a seed then goes
through both packages' flatten_obs_batch, and the bytes must be equal
exactly; the same bytes go through both nativize_tensor, and every leaf
must be equal exactly (a 64-bit leaf as its low 32-bit word on both
sides, as the JAX package gives it without x64). Nested actions nativize
to the same leaves.

One difference is held on purpose: without x64 the JAX flatten_obs_batch
packs a 64-bit leaf as 32-bit words, so its bytes no longer match the
structured dtype it nativizes with (ROADMAP, fault 3.9). The port writes
numpy's own layout, so for a space with a 64-bit leaf its bytes are held
to numpy's structured array instead, which the JAX package's own host
path (emulation.emulate) fills.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pufferlib_tpu import emulation as jemulation
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu import vector as jvector
from pufferlib_tpu.environments.test import environment as jmock

from pufferlib_tpu_torch import emulation, spaces, vector
from pufferlib_tpu_torch.environments.test import environment as mock

torch.set_num_threads(1)

B = 6


def _spec_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b) == 4, (a, b)
        assert np.dtype(a[0]) == np.dtype(b[0]) and tuple(a[1]) == tuple(
            b[1]) and a[2:] == b[2:], (a, b)
        return
    assert isinstance(b, dict) and list(a) == list(b), (a, b)
    for k in a:
        _spec_equal(a[k], b[k])


def _has_wide_leaf(space):
    return any(np.dtype(leaf.dtype).itemsize == 8
        for leaf in emulation.flatten_space(space))


def _sample(space, rng):
    """A numpy tree of B samples of `space`, values in each leaf's range
    (64-bit leaves within 32 bits)."""
    if isinstance(space, spaces.Dict):
        return {k: _sample(v, rng) for k, v in space.items()}
    if isinstance(space, spaces.Tuple):
        return tuple(_sample(s, rng) for s in space)
    if isinstance(space, spaces.Discrete):
        return rng.randint(0, space.n, B).astype(space.dtype)
    dtype = np.dtype(space.dtype)
    if np.issubdtype(dtype, np.floating):
        return rng.uniform(-3, 3, (B,) + space.shape).astype(dtype)
    info = np.iinfo(np.int32 if dtype.itemsize == 8 else dtype)
    low = max(int(space.low.min()), info.min)
    high = min(int(space.high.max()), info.max)
    return rng.randint(low, high, (B,) + space.shape, dtype=np.int64
        ).astype(dtype)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(fn, v) for v in tree)
    return fn(tree)


def _fill(struct, tree):
    """numpy's structured array of the batch: the host reference."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = ((f'f{i}', v) for i, v in enumerate(tree))
    else:
        struct[...] = tree.reshape(struct.shape)
        return
    for k, v in items:
        if isinstance(v, (dict, tuple)):
            _fill(struct[k], v)
        else:
            struct[k] = v.reshape(struct[k].shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + '/' + p, v) for k in tree for p, v in _leaves(tree[k])]
    return [('', tree)]


@pytest.mark.parametrize('name', sorted(mock.MOCK_OBSERVATION_SPACES))
def test_observation_emulation_matches_jax(name):
    space = mock.MOCK_OBSERVATION_SPACES[name]
    jspace = jmock.MOCK_OBSERVATION_SPACES[name]
    flat, struct_dtype = emulation.emulate_observation_space(space)
    jflat, jstruct_dtype = jemulation.emulate_observation_space(jspace)
    assert repr(flat) == repr(jflat)
    assert struct_dtype == jstruct_dtype
    assert emulation.is_emulated(space) == jemulation.is_emulated(jspace)
    em = emulation.make_emulated(space)
    jem = jemulation.make_emulated(jspace)
    assert em.observation_dtype == jem.observation_dtype
    spec = emulation.nativize_dtype(em)
    _spec_equal(spec, jemulation.nativize_dtype(jem))

    obs = _sample(space, np.random.RandomState(len(name)))
    got = vector.flatten_obs_batch(_tree(torch.from_numpy, obs), space, em)
    if isinstance(space, spaces.Box):
        # a Box passes through with its shape, on both sides
        np.testing.assert_array_equal(got.numpy(), obs)
        flat_bytes = obs.reshape(B, -1)
    else:
        struct = np.zeros(B, struct_dtype)
        _fill(struct, obs)
        flat_bytes = struct.view(em.observation_dtype).reshape(B, -1)
        assert got.dtype == emulation.torch_dtype(em.observation_dtype)
        np.testing.assert_array_equal(got.numpy(), flat_bytes)
        if not _has_wide_leaf(space):
            want = jvector.flatten_obs_batch(_tree(jnp.asarray, obs),
                jspace, jem)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the same bytes through both nativize_tensor: every leaf exactly
    leaves = emulation.nativize_tensor(torch.from_numpy(flat_bytes), spec)
    jleaves = jemulation.nativize_tensor(jnp.asarray(flat_bytes),
        jemulation.nativize_dtype(jem))
    got_leaves, want_leaves = _leaves(leaves), _leaves(jleaves)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)

    # emulate_tensor is nativize_tensor's inverse (64-bit leaves come back
    # from their low words, exact for values within 32 bits). The JAX
    # emulate_tensor refuses a signed byte leaf in a uint8 batch, so it is
    # held to the host reference alone
    back = emulation.emulate_tensor(leaves, em)
    np.testing.assert_array_equal(back.numpy(), flat_bytes)


@pytest.mark.parametrize('name', sorted(mock.MOCK_ACTION_SPACES))
def test_action_emulation_matches_jax(name):
    space = mock.MOCK_ACTION_SPACES[name]
    jspace = jmock.MOCK_ACTION_SPACES[name]
    flat, dtype = emulation.emulate_action_space(space)
    jflat, jdtype = jemulation.emulate_action_space(jspace)
    assert repr(flat) == repr(jflat)
    assert np.dtype(dtype) == np.dtype(jdtype)

    rng = np.random.RandomState(len(name))
    nvec = [flat.n] if isinstance(flat, spaces.Discrete) else list(flat.nvec)
    actions = np.stack([rng.randint(0, n, B) for n in nvec], axis=1
        ).astype(np.int32)
    if isinstance(flat, spaces.Discrete):
        actions = actions[:, 0]
    got = vector.nativize_actions(torch.from_numpy(actions), space)
    want = jvector.nativize_actions(jnp.asarray(actions), jspace)
    for (path, a), (_, b) in zip(_leaves(_as_dict(got)),
            _leaves(_as_dict(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
            err_msg=path)
    assert len(_leaves(_as_dict(got))) == len(_leaves(_as_dict(want)))
    # the host unpacking of one flat action
    row = actions[0]
    assert repr(emulation.nativize_multidiscrete(row, space)) == repr(
        jemulation.nativize_multidiscrete(row, jspace))


def _as_dict(tree):
    """Tuples as {'f0': ..}, so that _leaves walks them."""
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {f'f{i}': _as_dict(v) for i, v in enumerate(tree)}
    return tree


@pytest.mark.parametrize('name', ['dict_mixed', 'tuple_nested',
    'dict_of_tuple', 'nmmo_full'])
def test_numpy_host_emulation_matches_jax(name):
    """emulate / make_buffer / nativize on the host, one sample."""
    space = mock.MOCK_OBSERVATION_SPACES[name]
    jspace = jmock.MOCK_OBSERVATION_SPACES[name]
    sample = space.sample(np.random.RandomState(3))
    jsample = jspace.sample(np.random.RandomState(3))
    assert repr(sample) == repr(jsample)
    assert space.contains(sample) == jspace.contains(jsample)
    em = emulation.make_emulated(space)
    arr, struct = emulation.make_buffer(em.observation_dtype,
        em.emulated_observation_dtype)
    jarr, jstruct = jemulation.make_buffer(em.observation_dtype,
        em.emulated_observation_dtype)
    emulation.emulate(struct[0] if struct.shape else struct, sample)
    jemulation.emulate(jstruct[0] if jstruct.shape else jstruct, jsample)
    np.testing.assert_array_equal(arr, jarr)
    assert repr(emulation.nativize(arr, space,
        em.emulated_observation_dtype)) == repr(jemulation.nativize(jarr,
        jspace, em.emulated_observation_dtype))


def test_nested_spaces_match_jax():
    """MultiBinary, Dict and Tuple: sample, contains, repr and eq as the
    JAX package's."""
    pairs = [
        (spaces.MultiBinary(7), jspaces.MultiBinary(7)),
        (spaces.Dict(b=spaces.Discrete(3), a=spaces.MultiBinary(2)),
            jspaces.Dict(b=jspaces.Discrete(3), a=jspaces.MultiBinary(2))),
        (spaces.Tuple([spaces.Discrete(4), spaces.Box(0, 1, (2,))]),
            jspaces.Tuple([jspaces.Discrete(4), jspaces.Box(0, 1, (2,))])),
    ]
    for space, jspace in pairs:
        assert repr(space) == repr(jspace)
        a = space.sample(np.random.RandomState(5))
        b = jspace.sample(np.random.RandomState(5))
        assert repr(a) == repr(b)
        assert space.contains(a) and jspace.contains(b)
        assert space == space and (space == spaces.Discrete(2)) == (
            jspace == jspaces.Discrete(2))
    assert list(pairs[1][0].keys()) == ['a', 'b']
    assert not pairs[0][0].contains(np.full(7, 2))
    assert not pairs[1][0].contains({'a': np.zeros(2)})
    assert not pairs[2][0].contains((1,))
    assert len(pairs[2][0]) == 2 and pairs[2][0][0] == spaces.Discrete(4)


def test_box_action_space_cannot_be_emulated():
    with pytest.raises(ValueError, match='discretize'):
        emulation.emulate_action_space(spaces.Dict(
            a=spaces.Box(0, 1, (2,))))
