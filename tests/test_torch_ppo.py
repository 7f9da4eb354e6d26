"""PPO losses and the fused trainer of the PyTorch port against the JAX
package, and the trainer's own contracts on the CPU.

One full update: the same batch and the same params (JAX flax init,
carried across by convert.py) go through pufferlib_tpu's
ppo.make_update_fn (on the CPU, scan GAE) and the port's. The new params
and every losses/* stat must agree in f32: 2e-5 absolute on params, 1e-4
on the stats. Both run the same float32 math; sums are taken in other
orders, and Adam's update divides by sqrt(v) + eps, which magnifies a
last-bit difference of a tiny gradient component at most to lr * 1e-3.
The recurrent update (RecurrentPolicy(LSTMWrapper(Default))) is held to
the same tolerances in both minibatch layouts, and a recurrent rollout
replays the JAX rollout's own draws.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from pufferlib_tpu import spaces as jspaces
import pufferlib_tpu.vector as jax_vector
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.ocean import env_creator as jax_env_creator
from pufferlib_tpu.ops import ppo_losses as jax_ppo_losses
from pufferlib_tpu.training import ppo as jax_ppo

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.convert import (
    default_params, default_state_dict, lstm_params, lstm_state_dict)
from pufferlib_tpu_torch.models import (
    Default, LSTMWrapper, Policy, RecurrentPolicy)
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.ops import ppo_losses
from pufferlib_tpu_torch.training import checkpoint, ppo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_SHAPE = (7, 7)
T, N, HIDDEN = 8, 16, 32


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('clip_vloss', [True, False])
def test_ppo_losses_match_jax(masked, clip_vloss):
    rng = np.random.RandomState(int(masked) + 2 * int(clip_vloss))
    n = 257
    arrays = dict(
        newlogprob=rng.randn(n) * 0.1 - 2,
        logprob=rng.randn(n) * 0.1 - 2,
        entropy=rng.rand(n) * 2,
        newvalue=rng.randn(n, 1),
        values=rng.randn(n),
        advantages=rng.randn(n) * 3 + 1,
        returns=rng.randn(n),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    kw = dict(clip_coef=0.2, vf_clip_coef=0.3, vf_coef=0.5, ent_coef=0.01,
        clip_vloss=clip_vloss)
    mask = (rng.rand(n) < 0.7).astype(np.float32) if masked else None
    jloss, jstats = jax_ppo_losses(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        mask=None if mask is None else jnp.asarray(mask), **kw)
    loss, stats = ppo_losses(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
            rtol=0, atol=1e-5, err_msg=k)


def _batch(seed):
    """A rollout-shaped batch: obs of the squared grid, actions and
    logprobs from a nearby policy, rewards in the env's range."""
    rng = np.random.RandomState(seed)
    obs = rng.choice([-1.0, 0.0, 1.0], size=(T, N, 49),
        p=[0.1, 0.8, 0.1]).astype(np.float32)
    return dict(
        obs=obs,
        action=rng.randint(0, 8, (T, N)).astype(np.int32),
        logprob=(np.log(1 / 8) + rng.randn(T, N) * 0.05).astype(np.float32),
        value=(rng.randn(T, N) * 0.3).astype(np.float32),
        reward=rng.uniform(-1, 1, (T, N)).astype(np.float32),
        done=(rng.rand(T, N) < 0.25).astype(np.float32),
        last_value=(rng.randn(N) * 0.3).astype(np.float32),
    )


UPDATE_CASES = {
    'contiguous': dict(),
    'agent_major': dict(mlp_contiguous_minibatches=False),
    'target_kl': dict(target_kl=1e-4),
    'no_norm_adv': dict(norm_adv=False, clip_vloss=False, update_epochs=2),
}


@pytest.mark.parametrize('case', sorted(UPDATE_CASES))
def test_one_update_matches_jax(case):
    overrides = dict(batch_size=T * N, minibatch_size=32, bptt_horizon=4,
        update_epochs=3, learning_rate=3e-3, anneal_lr=False, verbose=False)
    overrides.update(UPDATE_CASES[case])
    lr = 3e-3
    num_minibatches = T * N // 32
    seg_rows = 32 // 4

    jmod = JaxDefault(obs_shape=OBS_SHAPE, action_space=jspaces.Discrete(8),
        hidden_size=HIDDEN)
    jpolicy = JaxPolicy(jmod)
    params = jpolicy.init(jax.random.PRNGKey(0),
        jnp.zeros((1,) + OBS_SHAPE, jnp.float32))
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-5)
    jconfig = jax_ppo.default_config(**overrides)
    jupdate = jax_ppo.make_update_fn(jpolicy, tx, jconfig, T, N,
        num_minibatches, seg_rows, obs_shape=OBS_SHAPE)
    batch = _batch(1)
    jparams, _, jstats = jax.jit(jupdate)(params, tx.init(params),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), jnp.float32(lr))

    module = Default(obs_shape=OBS_SHAPE, action_space=spaces.Discrete(8),
        hidden_size=HIDDEN)
    module.load_state_dict(default_state_dict(jax.tree.map(np.asarray,
        params)))
    policy = Policy(module)
    optimizer = torch.optim.Adam(policy.parameters(), lr=lr,
        betas=(0.9, 0.999), eps=1e-5)
    update = ppo.make_update_fn(policy, optimizer,
        ppo.default_config(device='cpu', **overrides), T, N,
        num_minibatches, seg_rows, OBS_SHAPE)
    stats = update({k: torch.from_numpy(v) for k, v in batch.items()}, lr)

    got = default_params(module.state_dict())['params']
    moved = 0.0
    for layer in ('encoder', 'head'):
        for k in ('kernel', 'bias'):
            expected = np.asarray(jparams['params'][layer][k])
            np.testing.assert_allclose(got[layer][k], expected, rtol=0,
                atol=2e-5, err_msg=f'{layer}.{k}')
            moved = max(moved, float(np.abs(
                expected - np.asarray(params['params'][layer][k])).max()))
    assert moved > 1e-3, 'the update must move the params'
    adam_steps = int(optimizer.state[module.encoder.weight]['step'])
    all_steps = overrides['update_epochs'] * num_minibatches
    if case == 'target_kl':
        assert num_minibatches <= adam_steps < all_steps, 'early stop'
    else:
        assert adam_steps == all_steps
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
            rtol=1e-4, atol=1e-5, err_msg=k)


def _trainer(tmp_path, **overrides):
    vecenv = vector.make(env_creator('squared'), num_envs=16, device='cpu')
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=16,
        generator=torch.Generator().manual_seed(0)))
    cfg = dict(batch_size=16 * 8, minibatch_size=32, bptt_horizon=4,
        update_epochs=2, total_timesteps=16 * 8 * 100, verbose=False,
        data_dir=str(tmp_path), device='cpu')
    cfg.update(overrides)
    config = ppo.default_config(**cfg)
    return ppo.create(config, vecenv, policy)


@pytest.mark.parametrize('obs_store_dtype', [None, 'bfloat16'])
def test_steps_on_cpu_give_finite_stats(tmp_path, obs_store_dtype):
    data = _trainer(tmp_path, obs_store_dtype=obs_store_dtype,
        track_history=True)
    ppo.step(data)
    ppo.step_many(data, 2)
    assert data.epoch == 3 and data.global_step == 3 * 16 * 8
    losses = data.losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert losses.grad_norm > 0
    assert set(data.stats) == {'score', 'episode_return', 'episode_length'}
    assert all(np.isfinite(v) for v in data.stats.values())
    # 16 lanes, episodes of 3 steps, 3 epochs of 8 steps
    assert data.stats['episode_length'] == 3.0


def test_evaluate_train_and_checkpoint(tmp_path, capsys):
    data = _trainer(tmp_path, checkpoint_interval=1, verbose=True)
    data.profile.interval = 0.0  # report every epoch
    with pytest.raises(APIUsageError):
        ppo.train(data)
    stats, infos = ppo.evaluate(data)
    assert data.batch['obs'].shape == (8, 16, 49)
    assert data.batch['done'].dtype == torch.float32
    ppo.train(data)
    assert np.isfinite(data.losses.policy_loss)
    assert 'epoch 1 step 128' in capsys.readouterr().out
    saved = {k: v.clone() for k, v in data.policy.state_dict().items()}

    resumed = _trainer(tmp_path, checkpoint_interval=1,
        exp_id=data.config.exp_id)
    assert checkpoint.try_load_checkpoint(resumed)
    assert resumed.epoch == 1 and resumed.global_step == 16 * 8
    for k, v in resumed.policy.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    # 2 epochs x 4 minibatches of Adam steps
    assert resumed.optimizer.state_dict()['state'][0]['step'] == 8


def test_anneal_uses_post_rollout_step_count():
    config = ppo.default_config(learning_rate=1.0, total_timesteps=100,
        batch_size=10)
    assert ppo._lr(config, 10) == pytest.approx(0.9)
    assert ppo._lr(config, 200) == 0.0
    config.anneal_lr = False
    assert ppo._lr(config, 200) == 1.0


def test_create_checks_geometry(tmp_path):
    with pytest.raises(APIUsageError, match='bptt_horizon'):
        _trainer(tmp_path, bptt_horizon=3)
    with pytest.raises(APIUsageError, match='minibatch_size'):
        _trainer(tmp_path, minibatch_size=48)


def test_cuda_is_the_default_and_absence_raises(tmp_path):
    """Entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    assert ppo.default_config().device == 'cuda'
    with pytest.raises(RuntimeError, match='cuda'):
        vector.make(env_creator('squared'), num_envs=4)
    for name in ('spaces', 'multiagent'):
        for backend in (vector.Device, vector.Serial):
            with pytest.raises(RuntimeError, match='cuda'):
                vector.make(env_creator(name), backend=backend, num_envs=4)
    vecenv = vector.make(env_creator('squared'), num_envs=4, device='cpu')
    policy = Policy(Default(obs_shape=(7, 7),
        action_space=vecenv.single_action_space, hidden_size=8))
    config = ppo.default_config(batch_size=32, minibatch_size=16,
        bptt_horizon=4, data_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match='cuda'):
        ppo.create(config, vecenv, policy)


def test_package_imports_no_jax():
    """The port imports torch, never jax or any module of pufferlib_tpu
    (checked in a fresh interpreter: this test process has both): its
    modules, every zoo binding and both torch examples' modules."""
    code = ('import sys, pufferlib_tpu_torch, '
        'pufferlib_tpu_torch.training.ppo, pufferlib_tpu_torch.convert, '
        'pufferlib_tpu_torch.ops.cuda, pufferlib_tpu_torch.ops.cuda.lstm_enc, '
        'pufferlib_tpu_torch.ops.cuda.lstm_cat, pufferlib_tpu_torch.ocean, '
        'pufferlib_tpu_torch.emulation, pufferlib_tpu_torch.vector, '
        'pufferlib_tpu_torch.ops.cuda.burn, '
        'pufferlib_tpu_torch.environments.test.environment, '
        'pufferlib_tpu_torch.config.cli, pufferlib_tpu_torch.vector_host, '
        'pufferlib_tpu_torch.training.dashboard, '
        'pufferlib_tpu_torch.training.ppo_host, '
        'pufferlib_tpu_torch.models.transformer, '
        'pufferlib_tpu_torch.policy_pool, pufferlib_tpu_torch.policy_store, '
        'pufferlib_tpu_torch.policy_ranker, demo_torch, bench_torch, '
        'importlib, runpy; '
        '[importlib.import_module("pufferlib_tpu_torch.environments." + n) '
        'for n in ("bsuite", "butterfly", "classic_control", "crafter", '
        '"dm_control", "dm_lab", "griddly", "links_awaken", "magent", '
        '"microrts", "minerl", "minigrid", "nocturne", "open_spiel", '
        '"open_spiel.adapters", "slimevolley", "smac", "stable_retro", '
        '"vizdoom")]; '
        'runpy.run_path("examples/cleanrl_style_ppo_torch.py"); '
        'runpy.run_path("examples/wrap_one_env_torch.py"); '
        'bad = [m for m in sys.modules if m in ("jax", "flax", "optax", '
        '"pufferlib_tpu") or m.startswith(("jax.", "flax.", "optax.", '
        '"pufferlib_tpu."))]; '
        'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
        timeout=120)


def _jax_recurrent(hidden=HIDDEN, seed=0):
    jmod = JaxLSTMWrapper(policy=JaxDefault(obs_shape=OBS_SHAPE,
        action_space=jspaces.Discrete(8), hidden_size=hidden),
        obs_shape=OBS_SHAPE, input_size=hidden, hidden_size=hidden,
        use_pallas=False)
    jpolicy = JaxRecurrentPolicy(jmod)
    params = jpolicy.init(jax.random.PRNGKey(seed),
        jnp.zeros((1,) + OBS_SHAPE, jnp.float32), jpolicy.initial_state(1))
    return jpolicy, params


def _port_recurrent(params, hidden=HIDDEN, **kwargs):
    module = LSTMWrapper(Default(obs_shape=OBS_SHAPE,
        action_space=spaces.Discrete(8), hidden_size=hidden),
        obs_shape=OBS_SHAPE, input_size=hidden, hidden_size=hidden, **kwargs)
    module.load_state_dict(lstm_state_dict(jax.tree.map(np.asarray, params)))
    return RecurrentPolicy(module)


RECURRENT_CASES = {
    # minibatch_size, overrides, LSTMWrapper kwargs of the port
    'time_slab': (64, dict(), dict()),
    'agent_major': (64, dict(lstm_time_slab_minibatches=False), dict()),
    # num_minibatches != T // h: agent-major whatever the flag
    'agent_major_mb32_cat': (32, dict(), dict(kernel='cat', use_kernel=True)),
    # the enc5 kernel's plain version on the time-slab path
    'time_slab_enc5': (64, dict(), dict(kernel='enc5', use_kernel=True)),
}


@pytest.mark.parametrize('case', sorted(RECURRENT_CASES))
def test_one_recurrent_update_matches_jax(case):
    minibatch_size, extra, port_kwargs = RECURRENT_CASES[case]
    overrides = dict(batch_size=T * N, minibatch_size=minibatch_size,
        bptt_horizon=4, update_epochs=2, learning_rate=3e-3, anneal_lr=False,
        verbose=False, **extra)
    lr = 3e-3
    num_minibatches = T * N // minibatch_size
    seg_rows = minibatch_size // 4
    jpolicy, params = _jax_recurrent()
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-5)
    jupdate = jax_ppo.make_update_fn(jpolicy, tx,
        jax_ppo.default_config(**overrides), T, N, num_minibatches, seg_rows,
        obs_shape=OBS_SHAPE)
    batch = _batch(3)
    h, c = (np.random.RandomState(4).randn(2, T // 4, 1, N, HIDDEN) * 0.5
        ).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch['lstm0'] = (jnp.asarray(h), jnp.asarray(c))
    jparams, _, jstats = jax.jit(jupdate)(params, tx.init(params), jbatch,
        jax.random.PRNGKey(1), jnp.float32(lr))

    policy = _port_recurrent(params, **port_kwargs)
    optimizer = torch.optim.Adam(policy.parameters(), lr=lr,
        betas=(0.9, 0.999), eps=1e-5)
    update = ppo.make_update_fn(policy, optimizer,
        ppo.default_config(device='cpu', **overrides), T, N,
        num_minibatches, seg_rows, OBS_SHAPE)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch['lstm0'] = (torch.from_numpy(h), torch.from_numpy(c))
    stats = update(tbatch, lr)

    got = dict(jax.tree.leaves_with_path(
        lstm_params(policy.module.state_dict())))
    before = dict(jax.tree.leaves_with_path(params))
    moved = 0.0
    for path, leaf in jax.tree.leaves_with_path(jparams):
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=0,
            atol=2e-5, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(leaf)
            - np.asarray(before[path])).max()))
    assert moved > 1e-3, 'the update must move the params'
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
            rtol=1e-4, atol=1e-5, err_msg=k)


def test_recurrent_rollout_replays_jax_draws():
    """The JAX rollout and the port's, from the same weights and env
    lanes, with the JAX sampler's uniforms and reset draws injected: the
    same actions and obs exactly; logprobs, values, the stored segment
    states lstm0, the carried state and the bootstrap value to 1e-5. The
    state is carried through episode ends (squared's end every few
    steps)."""
    steps, lanes, horizon = 12, 8, 4
    kwargs = dict(distance_to_target=3, num_targets=1)
    jvec = jax_vector.make(jax_env_creator('squared'), env_kwargs=kwargs,
        backend=jax_vector.Device, num_envs=lanes)
    jreset, jstep = jax_vector.make_env_ops(jvec.env, jvec.emulated)
    jpolicy, params = _jax_recurrent(seed=2)
    jconfig = jax_ppo.default_config(batch_size=steps * lanes,
        minibatch_size=steps * lanes, bptt_horizon=horizon)
    jrollout = jax_ppo.make_rollout_fn(jpolicy, jstep, jconfig, steps)
    key = jax.random.PRNGKey(3)
    lane_keys = jax.random.split(jax.random.PRNGKey(4), lanes)
    reset_keys = jax.random.split(jax.random.PRNGKey(5), lanes)
    env_states, obs, dones = jreset(reset_keys)
    carry = dict(env=env_states, done=dones, obs=obs, keys=lane_keys,
        t=jnp.uint32(0), lstm=jpolicy.initial_state(lanes), key=key)
    jcarry, jbatch, _, _ = jax.jit(jrollout)(params, carry)

    # the draws the JAX rollout made: the action key chain, and each lane's
    # reset target from fold_in(fold_in(lane_key, t), 0)
    def chosen_index(keys):
        states, _ = jax.vmap(jvec.env.reset)(keys)
        return np.argmax(np.asarray(states['env']['chosen']), axis=1)
    u, resets = [], []
    for t in range(steps):
        key, act_key = jax.random.split(key)
        u.append(np.asarray(jax.random.uniform(jax.random.split(act_key, 1)[0],
            (lanes,), dtype=jnp.float32)))
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(lane_keys, t)
        resets.append(chosen_index(jax.vmap(jax.random.fold_in,
            (0, None))(step_keys, 0)))
    draws = dict(u=torch.from_numpy(np.stack(u)),
        reset=torch.from_numpy(np.stack(resets)))

    vecenv = vector.make(env_creator('squared'), env_kwargs=kwargs,
        num_envs=lanes, device='cpu')
    reset_batch, step_batch = vector.make_env_ops(vecenv.env,
        vecenv.emulated)
    policy = _port_recurrent(params)
    states, tobs, tdones = reset_batch(torch.from_numpy(
        chosen_index(reset_keys)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    rollout = ppo.make_rollout_fn(policy, vecenv.env, step_batch,
        ppo.default_config(device='cpu', bptt_horizon=horizon), steps,
        torch.Generator())
    tcarry, tbatch, _, episodes = rollout(dict(env=states, done=tdones,
        obs=tobs, lstm=policy.initial_state(lanes)), draws)

    assert episodes > 0, 'the rollout must cross episode ends'
    np.testing.assert_array_equal(tbatch['action'].numpy(),
        np.asarray(jbatch['action']))
    np.testing.assert_array_equal(tbatch['obs'].numpy(),
        np.asarray(jbatch['obs']))
    for name in ('logprob', 'value', 'last_value'):
        np.testing.assert_allclose(tbatch[name].numpy(),
            np.asarray(jbatch[name]), rtol=0, atol=1e-5, err_msg=name)
    assert tbatch['lstm0'][0].shape == (steps // horizon, 1, lanes, HIDDEN)
    for got, want in zip(tbatch['lstm0'] + tcarry['lstm'],
            tuple(jbatch['lstm0']) + tuple(jcarry['lstm'])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
            atol=1e-5)


def _recurrent_trainer(tmp_path, **overrides):
    vecenv = vector.make(env_creator('squared'), num_envs=16, device='cpu')
    shape = vecenv.single_observation_space.shape
    policy = RecurrentPolicy(LSTMWrapper(Default(obs_shape=shape,
        action_space=vecenv.single_action_space, hidden_size=16,
        generator=torch.Generator().manual_seed(0)), obs_shape=shape,
        input_size=16, hidden_size=16,
        generator=torch.Generator().manual_seed(1)))
    cfg = dict(batch_size=16 * 8, minibatch_size=64, bptt_horizon=4,
        update_epochs=2, total_timesteps=16 * 8 * 100, verbose=False,
        data_dir=str(tmp_path), device='cpu')
    cfg.update(overrides)
    return ppo.create(ppo.default_config(**cfg), vecenv, policy)


@pytest.mark.parametrize('obs_store_dtype', [None, 'bfloat16'])
def test_recurrent_steps_on_cpu_give_finite_stats(tmp_path,
        obs_store_dtype):
    data = _recurrent_trainer(tmp_path, obs_store_dtype=obs_store_dtype)
    assert ppo.default_config().lstm_time_slab_minibatches is True
    ppo.step(data)
    ppo.step_many(data, 2)
    assert data.epoch == 3
    losses = data.losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert losses.grad_norm > 0
    h, c = data.carry['lstm']
    assert h.shape == (1, 16, 16) and torch.isfinite(h).all()
    assert torch.any(h != 0), 'the rollout carries the LSTM state'
