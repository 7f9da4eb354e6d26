"""The port's wandb sinks against the JAX package's, through a fake wandb
with the surface demo_torch.py and the trainers use (init, log, sweep,
agent, Artifact, run.log_artifact, finish): the key sets each trainer
logs equal the JAX trainer's (the fused trainer through demo --track,
the host trainer through evaluate + train), close() logs the model
artifact and finishes the run, a wandb sweep runs through the agent, and
--mode baseline evaluates the artifact's last model. wandb is imported
only by the caller (demo_torch's init_wandb); it is not installed
here."""
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import demo as jdemo
from pufferlib_tpu import vector_host as jvector_host
from pufferlib_tpu.host_env import GymnasiumPufferEnv as JaxGymnasiumPufferEnv
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.postprocess import EpisodeStats as JaxEpisodeStats
from pufferlib_tpu.training import ppo_host as jppo_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import demo_torch  # noqa: E402
from pufferlib_tpu_torch import vector_host  # noqa: E402
from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv  # noqa: E402
from pufferlib_tpu_torch.models import Default, Policy  # noqa: E402
from pufferlib_tpu_torch.postprocess import EpisodeStats  # noqa: E402
from pufferlib_tpu_torch.training import ppo_host  # noqa: E402

torch.set_num_threads(1)


class FakeArtifact:
    def __init__(self, name, type=None):
        self.name = name
        self.type = type
        self.files = []

    def add_file(self, path):
        self.files.append(path)


class FakeWandb(types.ModuleType):
    def __init__(self):
        super().__init__('wandb')
        self.inits = []
        self.logged = []
        self.finished = 0
        self.run = types.SimpleNamespace(artifacts=[])
        self.run.log_artifact = self.run.artifacts.append
        self.Artifact = FakeArtifact
        self.Image = lambda x: ('image', np.asarray(x).shape)
        self.config = {}
        self.util = types.SimpleNamespace(generate_id=lambda: 'fakeid')
        self.sweeps = []
        self.agent_calls = []

    def init(self, **kwargs):
        self.inits.append(kwargs)
        return self

    def log(self, metrics):
        self.logged.append(metrics)

    def finish(self):
        self.finished += 1

    def sweep(self, sweep=None, project=None):
        self.sweeps.append(sweep)
        return 'sweep-id-1'

    def agent(self, sweep_id, fn, count=1):
        # one run, whatever the count
        self.agent_calls.append((sweep_id, count))
        fn()

    def keys(self):
        return set().union(*(m.keys() for m in self.logged))


class _FastClock:
    """time.time advancing 10 s a call: the 3 s wandb throttle and the
    1 s profile interval always pass."""

    def __init__(self):
        self.t = time.time()

    def __call__(self):
        self.t += 10.0
        return self.t


@pytest.fixture
def fast_clock(monkeypatch):
    monkeypatch.setattr(time, 'time', _FastClock())


def _track(module, monkeypatch, argv):
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, 'wandb', fake)
    module.main(argv)
    return fake


TRAIN = ['--env', 'squared', '--mode', 'train', '--track',
    '--train.total_timesteps', '2048', '--train.num_envs', '64',
    '--train.batch_size', '1024', '--train.minibatch_size', '512',
    '--train.bptt_horizon', '8', '--no-train.verbose']


def test_fused_trainer_logs_the_jax_keys(tmp_path, monkeypatch, fast_clock):
    got = _track(demo_torch, monkeypatch, TRAIN + ['--exp-id', 'port',
        '--train.device', 'cpu', '--train.data_dir', str(tmp_path)])
    want = _track(jdemo, monkeypatch, TRAIN + ['--exp-id', 'jax',
        '--train.data_dir', str(tmp_path)])
    assert got.logged and got.keys() == want.keys()
    assert {'0verview/SPS', 'losses/policy_loss',
        'environment/score'} <= got.keys()
    assert got.inits[0]['id'] == 'port'
    assert set(got.inits[0]['config']) == set(want.inits[0]['config'])
    assert got.inits[0]['config']['train']['device'] == 'cpu'
    art = got.run.artifacts
    assert [a.name for a in art] == ['port_model'] and art[0].type == 'model'
    assert art[0].files[0].endswith('.pt') and os.path.exists(
        art[0].files[0])
    assert got.finished == want.finished == 1


def _host_envs(module, wrap, stats):
    class TinyGym(gymnasium.Env):
        observation_space = gymnasium.spaces.Box(0, 1, (3,), np.float32)
        action_space = gymnasium.spaces.Discrete(2)
        render_mode = None

        def __init__(self):
            self.t = 0

        def reset(self, seed=None, options=None):
            self.t = 0
            return np.zeros(3, np.float32), {}

        def step(self, action):
            self.t += 1
            return (np.full(3, self.t / 4, np.float32), float(action),
                self.t >= 4, False, {})

    return module.make(lambda: wrap(env=stats(TinyGym())), num_envs=4,
        backend=module.HostSerial)


def test_host_trainer_logs_the_jax_keys(tmp_path, fast_clock):
    kwargs = dict(batch_size=64, minibatch_size=32, bptt_horizon=8,
        total_timesteps=128, verbose=False, data_dir=str(tmp_path))
    fakes = []
    for trainer, module, wrap, stats, default, policy, extra in (
            (ppo_host, vector_host, GymnasiumPufferEnv, EpisodeStats,
                Default, Policy, dict(device='cpu')),
            (jppo_host, jvector_host, JaxGymnasiumPufferEnv,
                JaxEpisodeStats, JaxDefault, JaxPolicy, {})):
        fake = FakeWandb()
        vecenv = _host_envs(module, wrap, stats)
        net = policy(default(obs_shape=(3,),
            action_space=vecenv.single_action_space, hidden_size=16))
        config = trainer.default_config(env='tiny', exp_id='host',
            **kwargs, **extra)
        data = trainer.create(config, vecenv, net, wandb=fake)
        while data.global_step < config.total_timesteps:
            trainer.evaluate(data)
            trainer.train(data)
        trainer.close(data)
        fakes.append(fake)
    got, want = fakes
    assert got.logged and got.keys() == want.keys()
    assert 'environment/episode_return' in got.keys()
    assert [a.name for a in got.run.artifacts] == ['host_model']
    assert got.finished == 1


def test_wandb_sweep_runs_the_agent(tmp_path, monkeypatch, fast_clock):
    fake = _track(demo_torch, monkeypatch, ['--env', 'squared', '--mode',
        'sweep', '--track', '--train.total_timesteps', '1024',
        '--train.num_envs', '64', '--train.batch_size', '1024',
        '--train.minibatch_size', '512', '--train.bptt_horizon', '8',
        '--no-train.verbose', '--train.device', 'cpu', '--train.data_dir',
        str(tmp_path)])
    spec = fake.sweeps[0]
    assert spec['method'] == 'random' and spec['name'] == 'sweep-squared'
    assert spec['metric'] == {'goal': 'maximize',
        'name': 'environment/score'}
    assert spec['parameters']['learning_rate'] == {
        'distribution': 'log_uniform_values', 'min': 1e-4, 'max': 3e-2}
    assert fake.agent_calls == [('sweep-id-1', 10)]
    assert fake.logged and fake.finished == 1


def test_baseline_evaluates_the_latest_artifact(tmp_path, monkeypatch,
        capsys):
    """--mode baseline (reference demo.py:245-258): the fake artifact's
    directory holds a trained run; its last model_*.pt is evaluated."""
    demo_torch.main(['--env', 'squared', '--exp-id', 'base',
        '--train.device', 'cpu', '--train.data_dir', str(tmp_path),
        '--train.total_timesteps', '2048', '--train.num_envs', '64',
        '--train.batch_size', '1024', '--train.minibatch_size', '512',
        '--train.bptt_horizon', '8', '--no-train.verbose'])
    fake = FakeWandb()
    used = []

    def use_artifact(name):
        used.append(name)
        return types.SimpleNamespace(
            download=lambda: str(tmp_path / 'base'))

    fake.run.use_artifact = use_artifact
    monkeypatch.setitem(sys.modules, 'wandb', fake)
    monkeypatch.setenv('PUFFER_EVAL_STEPS', '2')
    monkeypatch.setenv('PUFFER_EVAL_DELAY', '0')
    capsys.readouterr()
    demo_torch.main(['--env', 'squared', '--mode', 'baseline', '--exp-id',
        'base', '--train.device', 'cpu'])
    assert used == ['base_model:latest']
    assert fake.inits[0]['resume'] is False
    assert capsys.readouterr().out.count('Reward:') == 2
