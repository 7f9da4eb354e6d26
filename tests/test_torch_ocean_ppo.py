"""The fused trainer of the PyTorch port on the other Ocean envs, against
the JAX package.

One update: the JAX trainer collects a batch on the env (ppo.create +
ppo.evaluate); the same batch and the same params (carried by
convert.py) then go through both packages' update, which must agree at
the tolerances of tests/test_torch_ppo.py (2e-5 absolute on the params,
1e-4 relative and 1e-5 absolute on the stats):
- spaces: a Dict observation emulated as 108 bytes, nativized by Default
  into 30 features, and a Dict action emulated as MultiDiscrete [2, 2];
- multiagent: two agents a lane, rows agent-major;
- memory: the recurrent trainer (time slabs) through the enc5 kernel's
  plain version, its input width 1; spaces the same, its 30 features.
An env with a variable count of live agents (DyingAgents, ported from
tests/test_training_extra.py) goes through both rollouts with the JAX
draws injected: batch['mask'] must be equal exactly, and the update must
consume it. Last, the port's trainer must learn spaces on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from pufferlib_tpu import spaces as jspaces
import pufferlib_tpu.vector as jax_vector
from pufferlib_tpu.environment import PufferEnv as JaxPufferEnv
from pufferlib_tpu.environment import Step as JaxStep
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.ocean import env_creator as jax_env_creator
from pufferlib_tpu.training import ppo as jax_ppo

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.convert import (
    default_params, default_state_dict, lstm_params, lstm_state_dict)
from pufferlib_tpu_torch.environment import PufferEnv, Step
from pufferlib_tpu_torch.models import (
    Default, LSTMWrapper, Policy, RecurrentPolicy)
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.training import ppo

torch.set_num_threads(1)

LR = 3e-3
HIDDEN = 32


def _jax_policy(jvec, recurrent, hidden=HIDDEN, seed=0):
    shape = jvec.single_observation_space.shape
    jmod = JaxDefault(obs_shape=shape,
        action_space=jvec.single_action_space, hidden_size=hidden,
        emulated=jvec.emulated)
    if recurrent:
        jmod = JaxLSTMWrapper(policy=jmod, obs_shape=shape,
            input_size=hidden, hidden_size=hidden, use_pallas=False)
        return JaxRecurrentPolicy(jmod)
    return JaxPolicy(jmod)


def _port_policy(vecenv, params, recurrent, hidden=HIDDEN):
    shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=shape, action_space=vecenv.single_action_space,
        hidden_size=hidden, emulated=vecenv.emulated)
    if recurrent:
        module = LSTMWrapper(module, obs_shape=shape, input_size=hidden,
            hidden_size=hidden, kernel='enc5', use_kernel=True)
        module.load_state_dict(lstm_state_dict(params))
        return RecurrentPolicy(module)
    module.load_state_dict(default_state_dict(params))
    return Policy(module)


def _params_of(policy, recurrent):
    return lstm_params(policy.module.state_dict()) if recurrent \
        else default_params(policy.module.state_dict())


def _assert_update_matches(jparams, jstats, policy, stats, recurrent,
        before):
    got = dict(jax.tree.leaves_with_path(_params_of(policy, recurrent)))
    start = dict(jax.tree.leaves_with_path(before))
    moved = 0.0
    for path, leaf in jax.tree.leaves_with_path(jparams):
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=0,
            atol=2e-5, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(leaf)
            - np.asarray(start[path])).max()))
    assert moved > 1e-4, 'the update must move the params'
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
            rtol=1e-4, atol=1e-5, err_msg=k)


UPDATE_CASES = {
    # env, lanes, rollout steps, minibatch rows, recurrent
    'spaces': ('spaces', 16, 8, 32, False),
    'multiagent': ('multiagent', 8, 8, 32, False),
    'memory_recurrent': ('memory', 16, 8, 64, True),
    # structured obs through LSTMWrapper's enc5 fuse (its plain version):
    # the encoder reads the 30 nativized features
    'spaces_recurrent': ('spaces', 16, 8, 64, True),
}


@pytest.mark.parametrize('case', sorted(UPDATE_CASES))
def test_one_update_on_the_env_batch_matches_jax(case, tmp_path):
    name, lanes, T, minibatch, recurrent = UPDATE_CASES[case]
    horizon = 4
    jvec = jax_vector.make(jax_env_creator(name), backend=jax_vector.Device,
        num_envs=lanes)
    agents = jvec.num_agents
    overrides = dict(batch_size=T * agents, minibatch_size=minibatch,
        bptt_horizon=horizon, update_epochs=2, learning_rate=LR,
        anneal_lr=False, verbose=False)
    jpolicy = _jax_policy(jvec, recurrent)
    jdata = jax_ppo.create(jax_ppo.default_config(data_dir=str(tmp_path),
        **overrides), jvec, jpolicy)
    jax_ppo.evaluate(jdata)
    jbatch = jdata.batch
    assert jbatch['obs'].shape[:2] == (T, agents)
    params = jax.tree.map(np.asarray, jdata.params)
    num_minibatches = T * agents // minibatch
    seg_rows = minibatch // horizon
    obs_shape = jvec.single_observation_space.shape
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-5)
    jupdate = jax_ppo.make_update_fn(jpolicy, tx,
        jax_ppo.default_config(**overrides), T, agents, num_minibatches,
        seg_rows, obs_shape=obs_shape)
    jparams, _, jstats = jax.jit(jupdate)(jdata.params,
        tx.init(jdata.params), jbatch, jax.random.PRNGKey(1),
        jnp.float32(LR))

    vecenv = vector.make(env_creator(name), num_envs=lanes, device='cpu')
    assert vecenv.num_agents == agents
    policy = _port_policy(vecenv, params, recurrent)
    optimizer = torch.optim.Adam(policy.parameters(), lr=LR,
        betas=(0.9, 0.999), eps=1e-5)
    update = ppo.make_update_fn(policy, optimizer,
        ppo.default_config(device='cpu', **overrides), T, agents,
        num_minibatches, seg_rows, obs_shape)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()
        if k != 'lstm0'}
    if recurrent:
        tbatch['lstm0'] = tuple(torch.from_numpy(np.array(s))
            for s in jbatch['lstm0'])
    if name == 'spaces':
        assert tbatch['obs'].dtype == torch.uint8
        encoder = (policy.module.policy if recurrent
            else policy.module).encoder
        assert encoder.in_features == 30
    stats = update(tbatch, LR)
    _assert_update_matches(jparams, jstats, policy, stats, recurrent, params)


@pytest.mark.parametrize('use_kernel', [False, True])
def test_default_nativizes_structured_obs_as_jax(use_kernel):
    """Default on spaces' 108-byte observations: the JAX module (its
    encoder reading the nativized leaves) and the port's, plain and
    through the fused MLP head's plain version, from the same params:
    logits and value to 1e-5 (the same f32 products, summed in another
    order)."""
    jvec = jax_vector.make(jax_env_creator('spaces'),
        backend=jax_vector.Device, num_envs=12)
    obs, _ = jvec.reset(seed=4)
    jmod = JaxDefault(obs_shape=jvec.single_observation_space.shape,
        action_space=jvec.single_action_space, hidden_size=HIDDEN,
        emulated=jvec.emulated)
    params = jmod.init(jax.random.PRNGKey(6), obs[:1])
    jlogits, jvalue = jmod.apply(params, obs)
    vecenv = vector.make(env_creator('spaces'), num_envs=12, device='cpu')
    module = Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=HIDDEN,
        emulated=vecenv.emulated, use_kernel=use_kernel)
    module.load_state_dict(default_state_dict(jax.tree.map(np.asarray,
        params)))
    with torch.no_grad():
        logits, value = module(torch.from_numpy(np.array(obs)))
    assert len(logits) == len(jlogits) == 2
    for a, b in zip(list(logits) + [value], list(jlogits) + [jvalue]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
            atol=1e-5)


class JaxDyingAgents(JaxPufferEnv):
    """2 agents; agent 1 dies after 2 ticks; episode ends at 6
    (tests/test_training_extra.py:178-203)."""
    num_agents = 2
    info_spec = {'score': {'shape': (2,), 'dtype': jnp.float32}}

    def __init__(self):
        self.observation_space = jspaces.Box(low=-1, high=1, shape=(2,))
        self.action_space = jspaces.Discrete(2)

    def reset(self, key):
        return dict(tick=jnp.int32(0)), jnp.zeros((2, 2), jnp.float32)

    def agent_mask(self, state):
        return jnp.stack([jnp.bool_(True), state['tick'] < 2])

    def step(self, state, action, key):
        tick = state['tick'] + 1
        done_ep = tick >= 6
        obs = jnp.full((2, 2), tick, jnp.float32) / 6
        reward = jnp.ones(2, jnp.float32)
        done = jnp.stack([done_ep, done_ep])
        info = {'score': jnp.where(done, reward, 0.0)}
        return JaxStep(dict(tick=tick), obs, reward, done,
            jnp.zeros(2, jnp.bool_), info)


class DyingAgents(PufferEnv):
    """The same env, batched over lanes."""
    num_agents = 2

    def __init__(self):
        self.observation_space = spaces.Box(low=-1, high=1, shape=(2,))
        self.action_space = spaces.Discrete(2)

    def reset(self, draws):
        n = draws.shape[0]
        return (dict(tick=torch.zeros(n, dtype=torch.int32)),
            torch.zeros(n, 2, 2))

    def agent_mask(self, state):
        return torch.stack([torch.ones_like(state['tick'], dtype=torch.bool),
            state['tick'] < 2], dim=1)

    def step(self, state, action, draws=None):
        tick = state['tick'] + 1
        n = tick.shape[0]
        done_ep = tick >= 6
        # times the float32 reciprocal, as XLA compiles the division
        obs = tick.float()[:, None, None].expand(n, 2, 2) * float(
            np.float32(1 / 6))
        reward = torch.ones(n, 2)
        done = torch.stack([done_ep, done_ep], dim=1)
        info = {'score': torch.where(done, reward, 0.0)}
        return Step(dict(tick=tick), obs, reward, done,
            torch.zeros_like(done), info)


def test_agent_mask_rollout_and_update_match_jax():
    """The JAX rollout and the port's, with the JAX sampler's uniforms
    injected: the same actions, obs and batch['mask'] exactly (agent 1's
    rows drop out two ticks into each episode), logprobs and values to
    1e-5. Then one update of each on the JAX batch, mask included, agree;
    without the mask the port's update moves the params elsewhere."""
    lanes, T, horizon = 8, 12, 6
    rows = 2 * lanes
    jvec = jax_vector.make(JaxDyingAgents, backend=jax_vector.Device,
        num_envs=lanes)
    jreset, jstep = jax_vector.make_env_ops(jvec.env, jvec.emulated)
    jpolicy = JaxPolicy(JaxDefault(obs_shape=(2,),
        action_space=jspaces.Discrete(2), hidden_size=HIDDEN))
    params = jpolicy.init(jax.random.PRNGKey(2), jnp.zeros((1, 2)))
    overrides = dict(batch_size=T * rows, minibatch_size=rows * horizon,
        bptt_horizon=horizon, update_epochs=2, learning_rate=LR,
        anneal_lr=False, verbose=False)
    jconfig = jax_ppo.default_config(**overrides)
    jrollout = jax_ppo.make_rollout_fn(jpolicy, jstep, jconfig, T,
        mask_fn=jax_vector.make_mask_fn(jvec.env))
    key = jax.random.PRNGKey(3)
    lane_keys = jax.random.split(jax.random.PRNGKey(4), lanes)
    env_states, obs, dones = jreset(jax.random.split(jax.random.PRNGKey(5),
        lanes))
    carry = dict(env=env_states, done=dones, obs=obs, keys=lane_keys,
        t=jnp.uint32(0), lstm=None, key=key)
    _, jbatch, _, _ = jax.jit(jrollout)(params, carry)
    jbatch = jax.tree.map(np.asarray, jbatch)

    u = []
    for _ in range(T):
        key, act_key = jax.random.split(key)
        u.append(np.asarray(jax.random.uniform(
            jax.random.split(act_key, 1)[0], (rows,), dtype=jnp.float32)))
    draws = dict(u=torch.from_numpy(np.stack(u)),
        reset=torch.zeros(T, lanes, 0))

    vecenv = vector.make(DyingAgents, num_envs=lanes, device='cpu')
    reset_batch, step_batch = vector.make_env_ops(vecenv.env,
        vecenv.emulated)
    module = Default(obs_shape=(2,), action_space=spaces.Discrete(2),
        hidden_size=HIDDEN)
    module.load_state_dict(default_state_dict(jax.tree.map(np.asarray,
        params)))
    policy = Policy(module)
    states, tobs, tdones = reset_batch(torch.zeros(lanes, 0))
    rollout = ppo.make_rollout_fn(policy, vecenv.env, step_batch,
        ppo.default_config(device='cpu', **overrides), T, torch.Generator(),
        mask_fn=vector.make_mask_fn(vecenv.env))
    _, tbatch, _, episodes = rollout(dict(env=states, done=tdones, obs=tobs,
        lstm=None), draws)

    assert episodes > 0
    for name in ('action', 'obs', 'mask', 'done', 'reward'):
        np.testing.assert_array_equal(tbatch[name].numpy(), jbatch[name],
            err_msg=name)
    assert tbatch['mask'].dtype == torch.float32
    assert 0 < tbatch['mask'].mean() < 1, 'agent 1 must die in the rollout'
    for name in ('logprob', 'value', 'last_value'):
        np.testing.assert_allclose(tbatch[name].numpy(), jbatch[name],
            rtol=0, atol=1e-5, err_msg=name)

    # one update each on the JAX batch, mask included
    num_minibatches = T * rows // overrides['minibatch_size']
    seg_rows = overrides['minibatch_size'] // horizon
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-5)
    jupdate = jax_ppo.make_update_fn(jpolicy, tx, jconfig, T, rows,
        num_minibatches, seg_rows, obs_shape=(2,))
    jparams, _, jstats = jax.jit(jupdate)(params, tx.init(params),
        {k: jnp.asarray(v) for k, v in jbatch.items()},
        jax.random.PRNGKey(1), jnp.float32(LR))

    def port_update(batch):
        module.load_state_dict(default_state_dict(jax.tree.map(np.asarray,
            params)))
        optimizer = torch.optim.Adam(policy.parameters(), lr=LR,
            betas=(0.9, 0.999), eps=1e-5)
        update = ppo.make_update_fn(policy, optimizer,
            ppo.default_config(device='cpu', **overrides), T, rows,
            num_minibatches, seg_rows, (2,))
        return update({k: torch.from_numpy(np.array(v))
            for k, v in batch.items()}, LR)

    stats = port_update(jbatch)
    _assert_update_matches(jparams, jstats, policy, stats, False,
        jax.tree.map(np.asarray, params))
    masked = {k: v.clone() for k, v in module.state_dict().items()}
    port_update({k: v for k, v in jbatch.items() if k != 'mask'})
    assert any(not torch.equal(v, masked[k])
        for k, v in module.state_dict().items()), 'the mask was not used'


def test_trainer_wires_the_agent_mask(tmp_path):
    """ppo.create takes the mask from the env: evaluate() stores it, and
    vector.Device.recv reports it per row."""
    vecenv = vector.make(DyingAgents, num_envs=4, device='cpu')
    policy = Policy(Default(obs_shape=(2,), action_space=spaces.Discrete(2),
        hidden_size=8, generator=torch.Generator().manual_seed(0)))
    data = ppo.create(ppo.default_config(batch_size=8 * 6,
        minibatch_size=24, bptt_horizon=6, verbose=False, device='cpu',
        data_dir=str(tmp_path)), vecenv, policy)
    ppo.evaluate(data)
    mask = data.batch['mask']
    assert mask.shape == (6, 8)
    # ticks 0-1 of each episode: both agents; then agent 1 (odd rows) dead
    assert torch.all(mask[:2] == 1) and torch.all(mask[2:, 0::2] == 1)
    assert torch.all(mask[2:, 1::2] == 0)
    ppo.train(data)
    assert np.isfinite(data.losses.policy_loss)
    vecenv.async_reset()
    *_, mask = vecenv.recv()
    assert mask.all()
    for _ in range(2):
        vecenv.send(torch.zeros(8, dtype=torch.int64))
        *_, mask = vecenv.recv()
    np.testing.assert_array_equal(mask, np.tile([True, False], 4))


def test_trainer_learns_spaces_on_the_cpu(tmp_path):
    """Dict obs (bytes, nativized) and a Dict action through the whole
    fused trainer: the score must pass 0.8 (random play scores 0.5; the
    JAX package's own test asks the same at 64 lanes,
    tests/test_training_extra.py:105-130). 32 lanes x 16 steps, hidden
    32, 25 epochs, one thread: about 1.3 s on one CPU core, within a
    budget of 20 s. Measured there over seeds 0-3: 0.898-0.922; with
    learning rate 0, 0.498-0.527."""
    vecenv = vector.make(env_creator('spaces'), num_envs=32, device='cpu')
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=32,
        emulated=vecenv.emulated,
        generator=torch.Generator().manual_seed(0)))
    config = ppo.default_config(env='spaces', batch_size=512,
        minibatch_size=128, bptt_horizon=8, total_timesteps=512 * 25,
        learning_rate=0.02, verbose=False, data_dir=str(tmp_path),
        checkpoint_interval=10 ** 6, device='cpu', seed=0)
    data = ppo.create(config, vecenv, policy)
    ppo.step_many(data, 24)
    ppo.evaluate(data)
    assert data.stats['score'] > 0.8, data.stats
