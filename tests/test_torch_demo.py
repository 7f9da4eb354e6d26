"""demo_torch.py, the port's CLI, on the CPU (--train.device cpu), held to
demo.py where both compute the same thing:

- routing: an Ocean creator to vector.Device and the fused trainer, a
  host creator to vector_host and ppo_host;
- train squared for a few epochs, write a checkpoint, resume it by
  --exp-id, and --mode eval loads the model_*.pt (PUFFER_EVAL_STEPS=2);
  a file that is neither this policy's state_dict nor a reference
  checkpoint is refused (a reference one plays:
  tests/test_torch_frameworks.py);
- sample_sweep_params from RandomState(0) and sweep_objective equal the
  JAX package's exactly; the local sweep reads each run's stats series;
- autotune, profile (with a torch.profiler trace), memory through the
  LSTM; --mode bench propagates bench_torch.py's exit code; --backend
  sb3 reaches frameworks.sb3, whose ImportError names stable_baselines3.
"""
import os
import sys

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import demo as jdemo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import demo_torch  # noqa: E402
from pufferlib_tpu_torch import vector, vector_host  # noqa: E402
from pufferlib_tpu_torch.exceptions import APIUsageError  # noqa: E402
from pufferlib_tpu_torch.namespace import namespace  # noqa: E402
from pufferlib_tpu_torch.ocean import env_creator  # noqa: E402

torch.set_num_threads(1)

SMALL = ['--train.device', 'cpu', '--train.num_envs', '64',
    '--train.batch_size', '1024', '--train.minibatch_size', '512',
    '--train.bptt_horizon', '8', '--no-train.verbose']


class _TinyGym:
    """A gymnasium-style host env."""

    def __init__(self):
        self.observation_space = gymnasium.spaces.Box(
            low=0, high=1, shape=(3,), dtype=np.float32)
        self.action_space = gymnasium.spaces.Discrete(2)
        self.render_mode = None
        self._t = 0

    def reset(self, seed=None, options=None):
        self._t = 0
        return np.zeros(3, np.float32), {}

    def step(self, action):
        self._t += 1
        return (np.full(3, self._t / 4, np.float32), 1.0, self._t >= 4,
            False, {})

    def close(self):
        pass


def _host_creator():
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    return GymnasiumPufferEnv(env=_TinyGym())


def _args(vec='serial', num_envs=2, **train):
    return namespace(vec=vec, env_kwargs=namespace(),
        train=namespace(num_envs=num_envs, device='cpu', **train))


def test_routes_device_creator():
    vecenv = demo_torch.make_vecenv(_args('device'), env_creator('squared'))
    assert isinstance(vecenv, vector.Device)
    assert vecenv.device == torch.device('cpu')
    vecenv.close()


@pytest.mark.parametrize('vec,backend', [
    ('serial', vector_host.HostSerial),
    ('multiprocessing', vector_host.HostMultiprocessing)])
def test_routes_host_creator(vec, backend):
    vecenv = demo_torch.make_vecenv(_args(vec), _host_creator)
    assert isinstance(vecenv, backend)
    obs, _ = vecenv.reset(seed=0)
    assert obs.shape == (2, 3)
    vecenv.close()


def test_host_env_trains_through_ppo_host(tmp_path):
    from pufferlib_tpu_torch import ocean
    args = namespace(vec='serial', env='tiny', exp_id=None, track=False,
        use_rnn=False, env_kwargs=namespace(), policy=namespace(),
        rnn=namespace(), train=namespace(num_envs=4, device='cpu',
            batch_size=64, minibatch_size=32, bptt_horizon=8,
            total_timesteps=128, verbose=False, data_dir=str(tmp_path)))
    data = demo_torch.train(args, ocean, _host_creator)
    assert data.global_step >= 128 and data.epoch == 2
    assert np.isfinite(data.losses.policy_loss)


def test_train_resume_and_eval(tmp_path, monkeypatch, capsys):
    exp = ['--exp-id', 'resume', '--train.data_dir', str(tmp_path)]
    data = demo_torch.main(['--env', 'squared', '--mode', 'train',
        '--train.total_timesteps', '2048'] + SMALL + exp)
    assert data.epoch == 2
    run = tmp_path / 'resume'
    assert sorted(os.listdir(run)) == ['model_000002.pt',
        'trainer_state.pt']
    data = demo_torch.main(['--env', 'squared', '--mode', 'train',
        '--train.total_timesteps', '4096'] + SMALL + exp)
    assert 'Loaded checkpoint model_000002.pt' in capsys.readouterr().out
    assert data.epoch == 4 and data.global_step == 4096

    monkeypatch.setenv('PUFFER_EVAL_STEPS', '2')
    monkeypatch.setenv('PUFFER_EVAL_DELAY', '0')
    demo_torch.main(['--env', 'squared', '--mode', 'eval',
        '--train.device', 'cpu', '--model-path',
        str(run / 'model_000004.pt')])
    assert capsys.readouterr().out.count('Reward:') == 2

    # a state_dict of another layout, and a pickled module that is no
    # reference policy
    other = tmp_path / 'reference.pt'
    for obj, refusal in (({'policy.weight': torch.zeros(1)},
            'not a state_dict of this policy'),
            (torch.nn.Linear(2, 2), 'holds no policy state_dict')):
        torch.save(obj, other)
        with pytest.raises(APIUsageError, match=refusal):
            demo_torch.main(['--env', 'squared', '--mode', 'eval',
                '--train.device', 'cpu', '--model-path', str(other)])


def test_memory_trains_through_the_lstm(tmp_path):
    data = demo_torch.main(['--env', 'memory', '--train.total_timesteps',
        '1024', '--train.data_dir', str(tmp_path)] + SMALL)
    assert data.policy.lstm is not None and data.epoch == 1
    assert np.isfinite(data.losses.policy_loss)


SPACES = [
    {'learning_rate': {'distribution': 'log_uniform', 'min': 1e-4,
        'max': 3e-2},
     'ent_coef': {'distribution': 'log_uniform', 'min': 1e-3, 'max': 1e-1},
     'gamma': {'distribution': 'uniform', 'min': 0.9, 'max': 0.999}},
    {'update_epochs': {'distribution': 'int_uniform', 'min': 1, 'max': 8},
     'clip_coef': {'distribution': 'categorical', 'values': [0.1, 0.2,
         0.3]},
     'norm_adv': {'distribution': 'categorical', 'values': [True, False]}},
]


@pytest.mark.parametrize('space', SPACES)
def test_sample_sweep_params_matches_jax(space):
    rng, jrng = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(20):
        assert demo_torch.sample_sweep_params(space, rng) == \
            jdemo.sample_sweep_params(space, jrng)


def test_sample_sweep_params_refuses_unknown():
    with pytest.raises(ValueError, match='Unknown distribution'):
        demo_torch.sample_sweep_params({'x': {'distribution': 'normal'}},
            np.random.RandomState(0))


def test_sweep_objective_matches_jax():
    data = namespace(
        stats_history=[(1024, {'score': 0.1}), (2048, {'score': 0.5}),
            (3072, {'score': 0.3, 'other': 2.0})],
        stats={'score': 0.3})
    for metric in ('score', 'other', 'reward'):
        for mode in ('mean', 'max', 'final'):
            assert demo_torch.sweep_objective(data, metric, mode) == \
                jdemo.sweep_objective(data, metric, mode)
    data.stats = {'episode_return': 1.5}
    assert demo_torch.sweep_objective(data, 'reward') == 1.5


def test_local_sweep_reads_the_series(tmp_path, capsys):
    config = tmp_path / 'config.yaml'
    config.write_text(
        'default:\n  package: ocean\n'
        f'  train: {{device: tpu, seed: 1, data_dir: {tmp_path}}}\n'
        'squared:\n  package: ocean\n  env: {name: squared}\n'
        '  sweep:\n    metric: score\n    num_runs: 2\n'
        '    parameters:\n      learning_rate: {distribution: log_uniform,'
        ' min: 0.001, max: 0.03}\n'
        '  train:\n    total_timesteps: 2048\n    num_envs: 64\n'
        '    batch_size: 1024\n    minibatch_size: 512\n'
        '    bptt_horizon: 8\n    checkpoint_interval: 1000\n')
    results = demo_torch.main(['--env', 'squared', '--mode', 'sweep',
        '--config', str(config), '--train.device', 'cpu'])
    assert len(results) == 2
    want = [jdemo.sample_sweep_params({'learning_rate': {
        'distribution': 'log_uniform', 'min': 0.001, 'max': 0.03}},
        np.random.RandomState(0)) for _ in range(1)]
    assert results[0]['score'] >= results[1]['score']
    assert want[0]['learning_rate'] in [r['learning_rate'] for r in results]
    assert 'Best:' in capsys.readouterr().out


def test_autotune_mode(monkeypatch, capsys):
    monkeypatch.setenv('PUFFER_AUTOTUNE_LANES', '32,64')
    monkeypatch.setenv('PUFFER_AUTOTUNE_HORIZON', '16')
    results = demo_torch.main(['--env', 'squared', '--mode', 'autotune',
        '--train.device', 'cpu'])
    assert sorted(results) == [32, 64]
    assert all(v > 0 for v in results.values())
    best = max(results, key=results.get)
    assert f'Best: --train.num_envs {best}' in capsys.readouterr().out


def test_autotune_reports_a_failed_rung(monkeypatch, capsys):
    monkeypatch.setenv('PUFFER_AUTOTUNE_LANES', '32,33,64')
    monkeypatch.setenv('PUFFER_AUTOTUNE_HORIZON', '16')
    # 33 lanes x 16 = 528 rows: batch // 4 = 132 is no multiple of the
    # bptt horizon 16, which ppo.create refuses; the ladder stops there
    results = demo_torch.main(['--env', 'squared', '--mode', 'autotune',
        '--train.device', 'cpu'])
    assert list(results) == [32]
    assert '33 failed' in capsys.readouterr().out


def test_autotune_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    monkeypatch.setenv('PUFFER_AUTOTUNE_LANES', '32')
    with pytest.raises(RuntimeError, match='cuda'):
        demo_torch.main(['--env', 'squared', '--mode', 'autotune'])


def test_profile_mode_writes_a_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('PUFFER_TRACE_DIR', str(tmp_path / 'trace'))
    demo_torch.main(['--env', 'squared', '--mode', 'profile',
        '--train.data_dir', str(tmp_path)] + SMALL)
    out = capsys.readouterr().out
    assert 'function calls' in out
    assert os.path.getsize(tmp_path / 'trace' / 'trace.json') > 0


def test_bench_mode_propagates_the_exit_code(monkeypatch):
    calls = []

    def run(cmd, cwd=None):
        calls.append(cmd)
        return namespace(returncode=3)

    monkeypatch.setattr(demo_torch.subprocess, 'run', run)
    with pytest.raises(SystemExit) as e:
        demo_torch.main(['--mode', 'bench'])
    assert e.value.code == 3
    assert calls[0][-1].endswith('bench_torch.py')


def test_sb3_backend_names_the_frameworks_item(monkeypatch):
    # --backend sb3 reaches frameworks.sb3.train_sb3, which names the
    # package it needs (with a fake one: tests/test_torch_frameworks.py)
    monkeypatch.setitem(sys.modules, 'stable_baselines3', None)
    with pytest.raises(ImportError, match='stable_baselines3'):
        demo_torch.main(['--env', 'squared', '--backend', 'sb3',
            '--train.device', 'cpu'])
