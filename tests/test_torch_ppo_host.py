"""The host trainer of the PyTorch port (training/ppo_host.py) against the
JAX package's, on the CPU.

- One evaluate + train of both trainers from the same weights on
  CartPole through HostSerial (8 envs, batch 512, minibatch 128, bptt 8),
  with the JAX sampler's uniforms injected (its key chain replayed):
  actions, observations, rewards and dones exactly; logprobs and values
  to 1e-5; after the update every parameter to 1e-4 and the losses to
  1e-4 of their size (the same f32 math summed in other orders, through
  16 Adam steps). With `Default` and with `LSTMWrapper(Default)`.
- The flat GAE through the GAE kernel's plain version (one column of
  N - 1 steps) equals compute_gae_flat bit for bit, and the JAX one to
  1e-5.
- The cpu_offload update equals the fused one (1e-6), with and without
  shuffled minibatches (the same injected permutations); shuffled
  minibatches run from the trainer's own draws; LSTM segments start
  from the state the rollout had there (mirrors tests/test_ppo_host.py).
- Convolutional + LSTM through HostMultiprocessing and the native driver
  on the fake ALE at a small frame, and ProcgenResnet on the fake procgen
  env: finite losses.
"""
import functools

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import jax
import jax.numpy as jnp
from pufferlib_tpu import vector_host as jvector_host
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.ops import compute_gae_flat as jax_compute_gae_flat
from pufferlib_tpu.training import ppo as jax_ppo
from pufferlib_tpu.training import ppo_host as jax_ppo_host

from pufferlib_tpu_torch import vector_host
from pufferlib_tpu_torch.convert import default_state_dict, lstm_state_dict
from pufferlib_tpu_torch.environments.test import host_fixtures
from pufferlib_tpu_torch.models import (
    Convolutional, Default, LSTMWrapper, Policy, ProcgenResnet,
    RecurrentPolicy)
from pufferlib_tpu_torch.ops.gae import compute_gae, compute_gae_flat
from pufferlib_tpu_torch.training import ppo_host

torch.set_num_threads(1)

HIDDEN = 32


def make_cartpole():
    return gymnasium.make('CartPole-v1')


CONFIG = dict(env='cartpole', batch_size=512, minibatch_size=128,
    bptt_horizon=8, total_timesteps=1024, verbose=False,
    checkpoint_interval=10 ** 6)


def _port_data(tmp_path, recurrent=False, **cfg):
    vecenv = vector_host.make(make_cartpole,
        backend=vector_host.HostSerial, num_envs=8)
    obs_shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=obs_shape,
        action_space=vecenv.single_action_space, hidden_size=HIDDEN)
    policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
        input_size=HIDDEN, hidden_size=HIDDEN)) if recurrent \
        else Policy(module)
    config = ppo_host.default_config(**{**CONFIG, **cfg}, device='cpu',
        data_dir=str(tmp_path))
    return ppo_host.create(config, vecenv, policy)


def _jax_data(tmp_path, recurrent=False, **cfg):
    vecenv = jvector_host.make(make_cartpole,
        backend=jvector_host.HostSerial, num_envs=8)
    obs_shape = vecenv.single_observation_space.shape
    module = JaxDefault(obs_shape=obs_shape,
        action_space=vecenv.single_action_space, hidden_size=HIDDEN)
    policy = JaxRecurrentPolicy(JaxLSTMWrapper(policy=module,
        obs_shape=obs_shape, input_size=HIDDEN, hidden_size=HIDDEN)) \
        if recurrent else JaxPolicy(module)
    config = jax_ppo.default_config(**{**CONFIG, **cfg},
        data_dir=str(tmp_path))
    return jax_ppo_host.create(config, vecenv, policy)


def _jax_uniforms(key, calls, rows):
    """The uniforms the JAX host trainer's sampler draws at each forward:
    key, sub = split(key); uniform(split(sub, 1)[0], (rows,))."""
    out = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(
            jax.random.split(sub, 1)[0], (rows,), dtype=jnp.float32))))
    return out


@pytest.mark.parametrize('recurrent', [False, True])
def test_evaluate_and_train_match_jax(tmp_path, recurrent):
    jdata = _jax_data(tmp_path / 'jax', recurrent)
    data = _port_data(tmp_path / 'port', recurrent)
    params = jax.tree.map(np.asarray, jdata.params)
    data.policy.module.load_state_dict(lstm_state_dict(params) if recurrent
        else default_state_dict(params))
    draws = iter(_jax_uniforms(jdata.key, 64, 8))

    jax_ppo_host.evaluate(jdata)
    ppo_host.evaluate(data, draws)
    jexp, exp = jdata.experience, data.experience
    for name in ('actions', 'obs', 'rewards', 'dones', 'key_agent',
            'key_step'):
        np.testing.assert_array_equal(getattr(exp, name),
            getattr(jexp, name), err_msg=name)
    for name in ('logprobs', 'values'):
        np.testing.assert_allclose(getattr(exp, name), getattr(jexp, name),
            rtol=0, atol=1e-5, err_msg=name)
    if recurrent:
        assert sorted(exp.lstm_snap) == sorted(jexp.lstm_snap)
        for k, (h, c) in exp.lstm_snap.items():
            np.testing.assert_allclose(h, jexp.lstm_snap[k][0], rtol=0,
                atol=1e-5)
            np.testing.assert_allclose(c, jexp.lstm_snap[k][1], rtol=0,
                atol=1e-5)
        np.testing.assert_allclose(exp.lstm_h.numpy(),
            np.asarray(jexp.lstm_h), rtol=0, atol=1e-5)

    jax_ppo_host.train(jdata)
    ppo_host.train(data)
    want = jax.tree.map(np.asarray, jdata.params)
    want = lstm_state_dict(want) if recurrent else default_state_dict(want)
    for k, v in data.policy.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
            atol=1e-4, err_msg=k)
    for k in ('policy_loss', 'value_loss', 'entropy', 'approx_kl',
            'explained_variance', 'adv_var'):
        w = float(jdata.losses[k])
        assert abs(float(data.losses[k]) - w) <= 1e-4 * max(1.0, abs(w)), k
    ppo_host.close(data)
    jax_ppo_host.close(jdata)


def test_flat_gae_through_the_kernel_equals_jax():
    """compute_gae_flat_cuda's column (rewards and dones shifted by one,
    the last value as the bootstrap), run by the kernel's plain version,
    equals compute_gae_flat bit for bit, adv[N-1] = 0 included, and the
    JAX compute_gae_flat to 1e-5 (tests/test_torch_gae.py's tolerance:
    XLA fuses a multiply-add)."""
    rng = np.random.RandomState(0)
    N = 777
    dones = (rng.rand(N) < 0.1).astype(np.float32)
    values = rng.randn(N).astype(np.float32)
    rewards = rng.randn(N).astype(np.float32)
    want = np.asarray(jax_compute_gae_flat(dones, values, rewards, 0.99,
        0.95))
    d, v, r = (torch.from_numpy(a) for a in (dones, values, rewards))
    got = torch.zeros(N)
    got[:-1] = compute_gae(r[1:, None], v[:-1, None], d[1:, None], v[-1:],
        0.99, 0.95)[:, 0]
    assert got.numpy().tobytes() == compute_gae_flat(d, v, r, 0.99,
        0.95).numpy().tobytes()
    assert got[-1] == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('shuffle', [False, True])
def test_cpu_offload_matches_fused_update(tmp_path, shuffle):
    """cpu_offload copies one minibatch at a time to the device through
    make_minibatch_update; the params and losses equal the fused epoch
    runner's after the same rollout (and, shuffled, the same injected
    segment permutations)."""
    datas = [_port_data(tmp_path / str(off), seed=5, cpu_offload=off,
        shuffle_minibatches=shuffle) for off in (True, False)]
    assert datas[0].run_minibatch is not None
    assert datas[1].run_minibatch is None
    datas[1].policy.load_state_dict(datas[0].policy.state_dict())
    S = 512 // 8
    perms = torch.stack([torch.randperm(S, generator=torch.Generator(
        ).manual_seed(e)) for e in range(4)]) if shuffle else None
    for d in datas:
        ppo_host.evaluate(d, iter(_jax_uniforms(jax.random.PRNGKey(9), 64,
            8)))
        ppo_host.train(d, perms)
    for (k, a), b in zip(datas[0].policy.state_dict().items(),
            datas[1].policy.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
            atol=1e-6, err_msg=k)
    for k in ('policy_loss', 'value_loss', 'approx_kl'):
        assert np.isclose(datas[0].losses[k], datas[1].losses[k], rtol=1e-4,
            atol=1e-5), k


@pytest.mark.parametrize('offload', [False, True])
def test_shuffled_minibatches_run(tmp_path, offload):
    data = _port_data(tmp_path, seed=9, cpu_offload=offload,
        shuffle_minibatches=True)
    ppo_host.evaluate(data)
    ppo_host.train(data)
    assert np.isfinite(data.losses.policy_loss)
    ppo_host.close(data)


def test_recurrent_segments_start_from_rollout_state(tmp_path):
    """BPTT minibatches start from the LSTM state the rollout had at each
    segment start, not zeros."""
    data = _port_data(tmp_path, recurrent=True, total_timesteps=10 ** 9)
    ppo_host.evaluate(data)
    exp = data.experience
    assert exp.lstm_snap, 'no LSTM segment snapshots captured'
    assert exp.lstm_h.shape == (1, 8, HIDDEN)
    nonzero = [k for k, (h, c) in exp.lstm_snap.items()
        if k[1] > 0 and np.abs(h).sum() > 0]
    assert nonzero, 'segment snapshots are all zeros'
    ppo_host.train(data)
    assert np.isfinite(data.losses.policy_loss)
    ppo_host.close(data)


def test_conv_lstm_on_the_envpool(tmp_path):
    """chip_smoke.py's atari phase at a small frame on the CPU:
    Convolutional + LSTMWrapper through HostMultiprocessing with the
    native driver (two of four worker groups in flight: the pipelined
    rollout) and cpu_offload; then ProcgenResnet through HostSerial on the
    fake procgen env. Two epochs each, finite losses, episode stats."""
    frame = (4, 36, 36)
    vec = vector_host.make(functools.partial(host_fixtures.make_fake_atari,
        23, frame), backend=vector_host.HostMultiprocessing, num_envs=4,
        num_workers=4, batch_size=2, native=True)
    assert vec.supports_pipeline
    conv = Convolutional(vec.single_action_space, 4, 64, hidden_size=32)
    policy = RecurrentPolicy(LSTMWrapper(conv, obs_shape=frame,
        input_size=32, hidden_size=32))
    config = ppo_host.default_config(env='atari', batch_size=256,
        minibatch_size=128, bptt_horizon=16, cpu_offload=True,
        total_timesteps=10 ** 6, verbose=False, device='cpu',
        data_dir=str(tmp_path), checkpoint_interval=10 ** 6)
    data = ppo_host.create(config, vec, policy)
    for _ in range(2):
        stats, _ = ppo_host.evaluate(data)
        ppo_host.train(data)
        assert np.isfinite(data.losses.policy_loss)
    assert 'episode_return' in stats
    ppo_host.close(data)

    vec = vector_host.make(host_fixtures.make_fake_procgen,
        backend=vector_host.HostSerial, num_envs=2)
    policy = Policy(ProcgenResnet(vec.single_action_space, cnn_width=4,
        mlp_width=16, obs_shape=vec.single_observation_space.shape))
    config = ppo_host.default_config(env='procgen', batch_size=128,
        minibatch_size=64, bptt_horizon=16, total_timesteps=10 ** 6,
        verbose=False, device='cpu', data_dir=str(tmp_path),
        checkpoint_interval=10 ** 6)
    data = ppo_host.create(config, vec, policy)
    for _ in range(2):
        ppo_host.evaluate(data)
        ppo_host.train(data)
        assert np.isfinite(data.losses.policy_loss)
    ppo_host.close(data)
