"""The port's zoo policies and bindings (pufferlib_tpu_torch.environments:
nethack, minihack, nmmo, nmmo3, pokemon_red, procgen's make) against the
JAX package's, on the CPU.

- nethack, nmmo and nmmo3 Policy at the JAX tests' widths
  (tests/test_zoo_policies.py) on their real observation layouts, batch 4,
  weights carried by convert.{nethack,nmmo,nmmo3}_state_dict: logits and
  values within rtol 1e-5 / atol 1e-5 in f32. nmmo's batch has a row whose
  agent has no entity row and one whose only match has id 0; the maps are
  not square (nmmo3's 11 x 15, nethack's 21 x 79), so a flatten in the
  wrong order shows. Inside LSTMWrapper(256, 256), a (B 4, T 3) segment
  through the plain scan and through cat's plain version (the card's
  route) against the JAX wrapper's: logits, values, h and c.
- Each binding's make on the same fake backends as
  tests/test_zoo_fake_backends{,2,3}.py beside the JAX binding's: spaces,
  dtypes, observation bytes, rewards, dones and episode stats equal.
- config.cli.resolve_env_module finds the new packages and still refuses
  one the port lacks (bsuite).
- One ppo_host epoch of nethack's Policy in LSTMWrapper on its fake env
  (environments.test.host_fixtures.make_fake_nethack), finite losses.
"""
import functools

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import jax
import jax.numpy as jnp
from pufferlib_tpu import emulation as jemulation
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper

import test_zoo_fake_backends as fakes1
import test_zoo_fake_backends2 as fakes2
import test_zoo_fake_backends3 as fakes3
from pufferlib_tpu_torch import emulation, spaces, vector_host
from pufferlib_tpu_torch.config import cli
from pufferlib_tpu_torch.convert import (
    lstm_state_dict, nethack_params, nethack_state_dict, nmmo3_params,
    nmmo3_state_dict, nmmo_params, nmmo_state_dict)
from pufferlib_tpu_torch.environments.test import host_fixtures
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import LSTMWrapper, RecurrentPolicy
from pufferlib_tpu_torch.training import ppo_host

torch.set_num_threads(1)

B, T = 4, 3
RTOL = ATOL = 1e-5


def _nethack_space(mod):
    return mod.Dict({
        'blstats': mod.Box(-2**15, 2**15 - 1, (27,), np.int32),
        'chars': mod.Box(0, 255, (21, 79), np.uint8),
    })


def _nmmo_space(mod, rows=32):
    return mod.Dict({
        'AgentId': mod.Box(0, 2**15 - 1, (1,), np.int16),
        'Entity': mod.Box(-2**15, 2**15 - 1, (rows, 31), np.int16),
        'Tile': mod.Box(0, 255, (225, 3), np.int16),
    })


def _emulate(space, samples):
    """(flat batch, JAX emulated, flat space) of structured samples."""
    jem = jemulation.make_emulated(space)
    flat_space, _ = jemulation.emulate_observation_space(space)
    arr, struct = jemulation.make_buffer(flat_space.dtype,
        jem.emulated_observation_dtype, n=len(samples))
    for i, sample in enumerate(samples):
        jemulation.emulate(struct[i], sample)
    return np.asarray(arr).reshape(len(samples), -1).copy(), jem, flat_space


def _nethack_obs(rng, n):
    return [{'blstats': rng.randint(-3, 300, 27).astype(np.int32),
        'chars': rng.randint(0, 256, (21, 79)).astype(np.uint8)}
        for _ in range(n)]


def _nmmo_obs(rng, n, rows=32):
    out = []
    for i in range(n):
        entity = rng.randint(-40, 400, (rows, 31)).astype(np.int16)
        entity[:, 0] = rng.randint(0, 6, rows)
        my_id = 7 + i
        if i == 1:
            pass  # no row matches: the entity input is a zero row
        elif i == 2:
            my_id = 0  # only id-0 rows match, which never count
        else:
            entity[[5, 9], 0] = my_id  # the first match counts
        tile = rng.randint(0, 256, (225, 3)).astype(np.int16)
        out.append({'AgentId': np.array([my_id], np.int16),
            'Entity': entity, 'Tile': tile})
    return out


def _case(name, rng):
    """(JAX module, port module builder, state-dict carry, flat obs of
    B * T rows)."""
    if name == 'nethack':
        from pufferlib_tpu.environments.nethack.policy import Policy as JP
        from pufferlib_tpu_torch.environments.nethack.policy import Policy
        obs, jem, flat = _emulate(_nethack_space(jspaces),
            _nethack_obs(rng, B * T))
        tem = emulation.make_emulated(_nethack_space(spaces))
        jmod = JP(obs_shape=flat.shape, action_space=jspaces.Discrete(8),
            emulated=jem)
        build = functools.partial(Policy, flat.shape, spaces.Discrete(8),
            emulated=tem)
        return jmod, build, nethack_state_dict, obs
    if name == 'nmmo':
        from pufferlib_tpu.environments.nmmo.policy import Policy as JP
        from pufferlib_tpu_torch.environments.nmmo.policy import Policy
        obs, jem, flat = _emulate(_nmmo_space(jspaces), _nmmo_obs(rng,
            B * T))
        tem = emulation.make_emulated(_nmmo_space(spaces))
        jmod = JP(obs_shape=flat.shape, action_space=jspaces.MultiDiscrete(
            [5, 4, 3]), emulated=jem)
        build = functools.partial(Policy, flat.shape, spaces.MultiDiscrete(
            [5, 4, 3]), emulated=tem)
        return jmod, build, nmmo_state_dict, obs
    from pufferlib_tpu.environments.nmmo3.policy import Policy as JP
    from pufferlib_tpu_torch.environments.nmmo3.policy import Policy
    total = int(np.prod((4, 4, 16, 5, 3, 5, 5, 6, 7, 4)))
    obs = np.concatenate([rng.randint(0, total, (B * T, 165)),
        rng.randint(-5, 200, (B * T, 44))], axis=1).astype(np.int32)
    jmod = JP(obs_shape=(209,), action_space=jspaces.Discrete(6))
    build = functools.partial(Policy, (209,), spaces.Discrete(6))
    return jmod, build, nmmo3_state_dict, obs


def _close(got, want, what):
    got = [g.detach().numpy() for g in got] if isinstance(got, list) \
        else [got.detach().numpy()]
    want = [np.asarray(w) for w in want] if isinstance(want, list) \
        else [np.asarray(want)]
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


ZOO = ['nethack', 'nmmo', 'nmmo3']


@pytest.mark.parametrize('name', ZOO)
def test_policy_matches_jax(name):
    jmod, build, carry, obs = _case(name, np.random.RandomState(0))
    obs = obs[:B]
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1),
        jnp.asarray(obs)))
    tmod = build()
    tmod.load_state_dict(carry(params))
    want_logits, want_value = jmod.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value = tmod(torch.as_tensor(obs))
    _close(logits, want_logits, f'{name} logits')
    _close(value, want_value, f'{name} value')


@pytest.mark.parametrize('use_kernel', [False, True])
@pytest.mark.parametrize('name', ZOO)
def test_lstm_segment_matches_jax(name, use_kernel):
    """LSTMWrapper(256, 256) over the policy on a (B, T) segment from a
    non-zero state; use_kernel=True runs cat's plain version, the route
    the card takes (the policies have no encoder_features contract)."""
    rng = np.random.RandomState(2)
    jinner, build, carry, obs = _case(name, rng)
    obs = obs.reshape((B, T) + obs.shape[1:])
    jmod = JaxLSTMWrapper(policy=jinner, obs_shape=obs.shape[2:],
        input_size=256, hidden_size=256, use_pallas=False)
    tmod = LSTMWrapper(build(), obs_shape=obs.shape[2:], input_size=256,
        hidden_size=256, use_kernel=use_kernel)
    assert tmod.route(T, 'cpu') == ('cat' if use_kernel else 'off')
    state = tuple((rng.randn(1, B, 256) * 0.5).astype(np.float32)
        for _ in range(2))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3),
        jnp.asarray(obs), tuple(jnp.asarray(s) for s in state)))
    tmod.load_state_dict(lstm_state_dict(params, carry))
    want_logits, want_value, (want_h, want_c) = jmod.apply(params,
        jnp.asarray(obs), tuple(jnp.asarray(s) for s in state))
    with torch.no_grad():
        logits, value, (h, c) = tmod(torch.as_tensor(obs),
            tuple(torch.as_tensor(s) for s in state))
    _close(logits, want_logits, f'{name} logits')
    _close(value, want_value, f'{name} value')
    _close(h, want_h, f'{name} h')
    _close(c, want_c, f'{name} c')


@pytest.mark.parametrize('name,carry,back', [
    ('nethack', nethack_state_dict, nethack_params),
    ('nmmo', nmmo_state_dict, nmmo_params),
    ('nmmo3', nmmo3_state_dict, nmmo3_params)])
def test_weight_carry_round_trip(name, carry, back):
    """The *_params carries invert the *_state_dict ones on the port's own
    init (a generator-seeded module)."""
    _, build, _, _ = _case(name, np.random.RandomState(0))
    sd = build(generator=torch.Generator().manual_seed(0)).state_dict()
    again = carry(back(sd))
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_nmmo_own_entity_is_the_one_hot_row():
    """own_entity: the first matching row, zeros where none matches, and
    after the clip the same integers as the JAX one-hot contraction in
    bf16 (values past 256 round, to values past 255)."""
    from pufferlib_tpu_torch.environments.nmmo.policy import Policy
    tmod = Policy((1,), spaces.Discrete(2),
        emulated=emulation.make_emulated(_nmmo_space(spaces)))
    rng = np.random.RandomState(5)
    entity = rng.randint(-300, 3000, (6, 9, 31)).astype(np.int64)
    entity[:, :, 0] = rng.randint(0, 3, (6, 9))
    my_id = np.array([1, 2, 7, 0, 1, 2])
    got = tmod.own_entity(torch.as_tensor(entity), torch.as_tensor(my_id))
    ids = entity[:, :, 0]
    mask = (ids == my_id[:, None]) & (ids != 0)
    onehot = (mask & (np.cumsum(mask, 1) == 1)).astype(np.float32)
    want = np.einsum('br,brf->bf', onehot, entity.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    bf16 = jnp.einsum('br,brf->bf', jnp.asarray(onehot, jnp.bfloat16),
        jnp.asarray(entity, jnp.bfloat16))
    np.testing.assert_array_equal(np.clip(got.numpy(), 0, 255),
        np.clip(np.asarray(bf16.astype(jnp.int32)), 0, 255))
    assert not got[2].any() and not got[3].any()


def test_nmmo3_decompress_map_matches_jax():
    from pufferlib_tpu.environments.nmmo3.policy import (
        decompress_map as jax_decompress)
    from pufferlib_tpu_torch.environments.nmmo3.policy import (
        N_CHANNELS, decompress_map)
    codes = np.random.RandomState(0).randint(0, 16128000, (3, 11, 15))
    got = decompress_map(torch.as_tensor(codes)).numpy()
    assert got.shape == (3, 11, 15, N_CHANNELS)
    np.testing.assert_array_equal(got, np.asarray(jax_decompress(
        jnp.asarray(codes, jnp.int32))))


def test_pokemon_red_policy_widths():
    """pokemon_red.Policy: Convolutional channels-last, fc's width from
    obs_shape (64 * 5 * 6 at pokegym's 72 x 80), Recurrent 512."""
    from pufferlib_tpu_torch.environments import pokemon_red
    pol = pokemon_red.Policy((72, 80, 4), spaces.Discrete(7),
        generator=torch.Generator().manual_seed(0))
    assert pol.fc.in_features == 64 * 5 * 6 and pol.channels_last
    assert pokemon_red.Policy((80, 96, 4), spaces.Discrete(7)).fc \
        .in_features == 64 * 6 * 8
    logits, value = pol(torch.zeros(2, 72, 80, 4, dtype=torch.uint8))
    assert logits.shape == (2, 7) and value.shape == (2, 1)
    assert pokemon_red.Recurrent == dict(input_size=512, hidden_size=512,
        num_layers=1)


# --------------------------------------------------------------------------
# The bindings on the JAX tests' fake backends


def _run_both(make_jax, make_port, actions, steps):
    """Reset and step both envs; every output equal."""
    jenv, tenv = make_jax(), make_port()
    assert tenv.single_observation_space.shape == \
        jenv.single_observation_space.shape
    assert np.dtype(tenv.single_observation_space.dtype) == np.dtype(
        jenv.single_observation_space.dtype)
    assert type(tenv.single_action_space).__name__ == type(
        jenv.single_action_space).__name__
    outs = []
    for env in (jenv, tenv):
        obs, _ = env.reset(seed=0)
        trace = [obs]
        for _ in range(steps):
            trace.append(env.step(actions))
        env.close()
        outs.append(trace)
    jtrace, ttrace = outs

    def flat(x):
        if isinstance(x, dict):
            return [flat(x[k]) for k in sorted(x)]
        if isinstance(x, (tuple, list)):
            return [flat(v) for v in x]
        return np.asarray(x)

    def equal(a, b):
        if isinstance(a, list):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                equal(u, v)
        else:
            np.testing.assert_array_equal(a, b)

    equal(flat(ttrace), flat(jtrace))
    return jenv, tenv, ttrace


def test_nethack_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'nle',
        __import__('types').ModuleType('nle'))
    monkeypatch.setattr(gymnasium, 'make',
        lambda name, **kw: fakes1.FakeNetHack())
    from pufferlib_tpu.environments import nethack as jnethack
    from pufferlib_tpu_torch.environments import nethack
    jenv, tenv, trace = _run_both(jnethack.make, nethack.make,
        np.array([0]), 5)
    assert trace[-1][2] and trace[-1][4]['episode_return'] == 5.0
    # the bytes nativize back to the Dict observation
    native = emulation.nativize(np.asarray(trace[0]),
        tenv.native_observation_space, tenv.emulated
        .emulated_observation_dtype)
    for k, space in fakes1.NETHACK_SPACE.items():
        assert native[k].shape == space.shape
        assert native[k].dtype == space.dtype
    assert nethack.Recurrent == jnethack.Recurrent
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    assert nethack.Policy is Policy


def test_minihack_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'minihack',
        __import__('types').ModuleType('minihack'))
    seen = []

    def fake_make(name, **kw):
        seen.append((name, kw))
        return fakes1.FakeNetHack()

    monkeypatch.setattr(gymnasium, 'make', fake_make)
    from pufferlib_tpu.environments import minihack as jminihack
    from pufferlib_tpu_torch.environments import minihack
    _run_both(lambda: jminihack.make('MiniHack-River-v0'),
        lambda: minihack.make('MiniHack-River-v0'), np.array([0]), 5)
    assert seen[0] == seen[1] and seen[1][1]['observation_keys'] == (
        'glyphs', 'chars', 'colors', 'blstats')
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    assert minihack.Policy is Policy


def test_nmmo_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'nmmo',
        type('nmmo', (), {'Env': fakes1.FakeNMMO}))
    from pufferlib_tpu.environments import nmmo as jnmmo
    from pufferlib_tpu_torch.environments import nmmo
    _, _, trace = _run_both(jnmmo.make, nmmo.make, np.zeros(3, np.int64), 4)
    # agent 2 dies at step 2, then is padded out: reward 0, done
    assert trace[2][2][2] and trace[3][1][2] == 0 and trace[3][2][2]
    assert all(trace[4][2].values())


def test_nmmo3_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'nmmo3',
        type('nmmo3', (), {'PuffEnv': fakes3.FakePuffEnv}))
    from pufferlib_tpu.environments import nmmo3 as jnmmo3
    from pufferlib_tpu_torch.environments import nmmo3
    _, tenv, trace = _run_both(jnmmo3.make, nmmo3.make, np.zeros(4,
        np.int64), 3)
    assert tenv.emulated is None and tenv.num_agents == 4
    vec = vector_host.make(nmmo3.env_creator(), num_envs=2,
        backend=vector_host.HostSerial)
    obs, _ = vec.reset(seed=0)
    assert obs.shape == (8, 11)
    assert vec.step(np.zeros(8, np.int64))[1].sum() == 8.0
    vec.close()


def test_pokemon_red_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'pokegym',
        type('pokegym', (), {'Environment': fakes2.FakePokegym}))
    from pufferlib_tpu.environments import pokemon_red as jpokemon
    from pufferlib_tpu_torch.environments import pokemon_red
    _, _, trace = _run_both(jpokemon.make, pokemon_red.make, np.array([0]),
        4)
    assert trace[-1][2] and trace[-1][4]['pokemon_exploration_map'] is not \
        None


def test_procgen_binding_matches_jax(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'procgen',
        type('procgen', (), {'ProcgenEnv': fakes1.FakeProcgenVec}))
    from pufferlib_tpu.environments import procgen as jprocgen
    from pufferlib_tpu_torch.environments import procgen
    _, _, trace = _run_both(lambda: jprocgen.make('bigfish'),
        lambda: procgen.make('bigfish'), np.array([0]), 3)
    assert [step[1] for step in trace[1:]] == [10.0] * 3  # clipped
    assert trace[3][2] and trace[3][4]['episode_return'] == 30.0
    from pufferlib_tpu_torch.models import ProcgenResnet
    assert procgen.Policy is ProcgenResnet


@pytest.mark.parametrize('package', ['nethack', 'minihack', 'nmmo',
    'nmmo3', 'pokemon_red', 'procgen'])
def test_missing_backend_raises(package):
    """Without its backend each make raises the JAX binding's ImportError."""
    import importlib
    module = importlib.import_module(
        f'pufferlib_tpu_torch.environments.{package}')
    with pytest.raises(ImportError, match='is not installed'):
        module.env_creator()()


# --------------------------------------------------------------------------
# The CLI and the host trainer


@pytest.mark.parametrize('package', ['nethack', 'minihack', 'nmmo',
    'nmmo3', 'pokemon_red', 'procgen'])
def test_resolve_env_module_finds_the_zoo(package):
    module = cli.resolve_env_module(package)
    assert module.__name__ == f'pufferlib_tpu_torch.environments.{package}'
    assert callable(module.env_creator) and module.Policy is not None


def test_resolve_env_module_refuses_a_missing_package():
    with pytest.raises(APIUsageError, match='queue 1 item 7'):
        cli.resolve_env_module('bsuite')


def test_make_policy_builds_the_zoo_lstm():
    """config.cli.make_policy on nethack's section: the package's Policy
    (emulated passed), inside LSTMWrapper from its Recurrent dict."""
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    args, module, _ = cli.load_config(argv=['--env', 'nethack',
        '--train.device', 'cpu'])
    vec = vector_host.make(host_fixtures.make_fake_nethack,
        backend=vector_host.HostSerial, num_envs=1)
    policy = cli.make_policy(vec, module, args)
    vec.close()
    assert isinstance(policy, RecurrentPolicy)
    assert isinstance(policy.module.policy, Policy)
    assert policy.module.policy.native_spec is not None
    assert (policy.module.input_size, policy.module.hidden_size) == (256, 256)


def test_nethack_ppo_host_epoch(tmp_path):
    """One ppo_host epoch of nethack's Policy (hidden 32) in LSTMWrapper
    (32, 32) on the fake NLE through HostSerial: finite losses, episode
    stats."""
    vec = vector_host.make(functools.partial(host_fixtures.make_fake_nethack,
        8), backend=vector_host.HostSerial, num_envs=2)
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    g = torch.Generator().manual_seed(0)
    shape = vec.single_observation_space.shape
    policy = RecurrentPolicy(LSTMWrapper(Policy(shape,
        vec.single_action_space, emulated=vec.emulated, hidden_size=32,
        generator=g), obs_shape=shape, input_size=32, hidden_size=32,
        use_kernel=True, generator=g))
    config = ppo_host.default_config(env='nethack', batch_size=64,
        minibatch_size=32, bptt_horizon=8, total_timesteps=10 ** 6,
        verbose=False, device='cpu', data_dir=str(tmp_path),
        checkpoint_interval=10 ** 6)
    data = ppo_host.create(config, vec, policy)
    stats, _ = ppo_host.evaluate(data)
    ppo_host.train(data)
    ppo_host.close(data)
    for loss in ('policy_loss', 'value_loss', 'entropy'):
        assert np.isfinite(getattr(data.losses, loss)), loss
    assert stats['episode_return'] == 8.0
