"""The port's frameworks bridge (pufferlib_tpu_torch.frameworks: torch_import,
cleanrl, sb3, rllib) against the JAX package's, on the CPU.

- torch_import.convert of seeded reference-layout state_dicts, each layout
  (Discrete `decoder`, MultiDiscrete `decoder.{i}`, the LSTM's
  `recurrent.*`, the cleanrl `policy.` prefix, torch.compile's
  `_orig_mod.`): the port's Default / LSTMWrapper(Default) with the
  converted weights against the JAX modules with JAX's own
  torch_import.convert of the same state_dict: logits, values, h and c
  within rtol 1e-5 / atol 1e-6 in f32; and against the reference math
  (nn.Linear + nn.LSTM + split heads, chip_smoke.py's), forward and every
  gradient, through the plain scan and enc5's plain version.
- export of the port's state_dict equals JAX's export of the carried
  params key for key and exactly; convert(export(sd)) == sd exactly.
- PolicyStore and demo_torch.py --mode eval take a reference-layout file;
  a pickled reference module raises the ImportError naming `pufferlib`
  where the caller asks for it to be unpickled; the store refuses it
  unread, and every reader refuses a pickle of no reference module
  unread.
- The cleanrl re-exports are the port's objects.
- sb3 against a fake stable_baselines3: the two TypeErrors, the
  ImportError, make_vec_env handed a creator that yields the port's
  GymnasiumAdapter; --backend sb3 and sb3_demo_torch.py reach it.
- rllib against a fake ray (tests/test_rllib_bridge.py's, copied):
  register_env for gymnasium and PettingZoo envs, create_policies,
  read_checkpoints, make_policy for feed-forward and recurrent port
  policies with value_function after a forward; rllib_ppo_torch.py's
  ImportError.
"""
import contextlib
import os
import sys
import types

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import jax.numpy as jnp
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.frameworks import torch_import as jax_torch_import
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import demo_torch  # noqa: E402
from pufferlib_tpu_torch import spaces  # noqa: E402
from pufferlib_tpu_torch.exceptions import APIUsageError  # noqa: E402
from pufferlib_tpu_torch.frameworks import (  # noqa: E402
    cleanrl, rllib, sb3, torch_import)
from pufferlib_tpu_torch.host_env import (  # noqa: E402
    GymnasiumAdapter, GymnasiumPufferEnv, PettingZooPufferEnv)
from pufferlib_tpu_torch.models import (  # noqa: E402
    Default, LSTMWrapper, Policy, RecurrentPolicy)
from pufferlib_tpu_torch.policy_store import (  # noqa: E402
    PolicyStore, read_policy)

torch.set_num_threads(1)

OBS, H, B, T = (7, 7), 32, 5, 3
RTOL, ATOL = 1e-5, 1e-6


def reference_state_dict(nvec, recurrent, seed=0):
    """A reference Default (or LSTMWrapper(Default)) state_dict in the
    reference's key layout, drawn from a numpy seed."""
    rng = np.random.RandomState(seed)

    def draw(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.3).astype(np.float32))
    pre = 'policy.' if recurrent else ''
    sd = {f'{pre}encoder.weight': draw(H, int(np.prod(OBS))),
        f'{pre}encoder.bias': draw(H)}
    for i, n in enumerate(nvec):
        key = f'{pre}decoder.' + (f'{i}.' if len(nvec) > 1 else '')
        sd[key + 'weight'] = draw(n, H)
        sd[key + 'bias'] = draw(n)
    sd[f'{pre}value_head.weight'] = draw(1, H)
    sd[f'{pre}value_head.bias'] = draw(1)
    if recurrent:
        for k, shape in (('weight_ih_l0', (4 * H, H)),
                ('weight_hh_l0', (4 * H, H)), ('bias_ih_l0', (4 * H,)),
                ('bias_hh_l0', (4 * H,))):
            sd[f'recurrent.{k}'] = draw(*shape)
    return sd


def wrap_layout(sd, layout):
    """The same weights as a cleanrl wrapper or a torch.compile'd module
    saves them."""
    if layout == 'cleanrl':
        return {f'policy.{k}': v for k, v in sd.items()}
    if layout == 'compiled':
        return {f'_orig_mod.{k}': v for k, v in sd.items()}
    return dict(sd)


def _spaces(nvec):
    if len(nvec) == 1:
        return jspaces.Discrete(nvec[0]), spaces.Discrete(nvec[0])
    return jspaces.MultiDiscrete(nvec), spaces.MultiDiscrete(nvec)


def _modules(nvec, recurrent, use_kernel=False):
    jspace, tspace = _spaces(nvec)
    jmod = JaxDefault(obs_shape=OBS, action_space=jspace, hidden_size=H)
    tmod = Default(OBS, tspace, hidden_size=H)
    if recurrent:
        jmod = JaxLSTMWrapper(policy=jmod, obs_shape=OBS, input_size=H,
            hidden_size=H, use_pallas=False)
        tmod = LSTMWrapper(tmod, obs_shape=OBS, input_size=H, hidden_size=H,
            use_kernel=use_kernel)
    return jmod, tmod


def _close(got, want, what):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
            rtol=RTOL, atol=ATOL, err_msg=what)


CASES = [((8,), False, 'plain'), ((5, 4, 3), False, 'plain'),
    ((8,), True, 'plain'), ((5, 4, 3), True, 'plain'),
    ((8,), False, 'cleanrl'), ((8,), True, 'cleanrl'),
    ((8,), False, 'compiled'), ((5, 4, 3), True, 'compiled')]


@pytest.mark.parametrize('nvec,recurrent,layout', CASES)
def test_convert_matches_jax(nvec, recurrent, layout):
    ref = wrap_layout(reference_state_dict(nvec, recurrent), layout)
    jmod, tmod = _modules(nvec, recurrent)
    converted = torch_import.convert(ref)
    assert sorted(converted) == sorted(tmod.state_dict())
    tmod.load_state_dict(converted, strict=True)
    params = jax_torch_import.convert(ref)
    rng = np.random.RandomState(1)
    if recurrent:
        obs = rng.randn(B, T, *OBS).astype(np.float32)
        state = tuple((rng.randn(1, B, H) * 0.5).astype(np.float32)
            for _ in range(2))
        want = jmod.apply(params, jnp.asarray(obs),
            tuple(jnp.asarray(s) for s in state))
        with torch.no_grad():
            got = tmod(torch.as_tensor(obs), tuple(torch.as_tensor(s)
                for s in state))
        _close(got[2], want[2], 'h, c')
    else:
        obs = rng.randn(B, *OBS).astype(np.float32)
        want = jmod.apply(params, jnp.asarray(obs))
        with torch.no_grad():
            got = tmod(torch.as_tensor(obs))
    _close(got[0], want[0], 'logits')
    _close(got[1], want[1], 'value')


def test_reference_import_check_rehearses_on_the_cpu():
    """chip_smoke.py's check at a small size on the CPU: a reference
    checkpoint through convert against nn.Linear + nn.LSTM + split heads,
    forward and every gradient, through enc5's plain version."""
    launches, ref = chip_smoke.check_reference_import(torch, 'CPU',
        device='cpu', B=16, T=4, hidden=H)
    assert set(ref) == set(chip_smoke.reference_checkpoint(torch, 49, 8,
        H))


@pytest.mark.parametrize('use_kernel', [False, True])
def test_convert_matches_the_reference_math(use_kernel):
    """A converted reference checkpoint against the reference math
    (chip_smoke.py's), through the plain scan and (use_kernel) enc5's
    plain version."""
    ref = chip_smoke.reference_checkpoint(torch, 49, 8, H)
    lstm = LSTMWrapper(Default(OBS, spaces.Discrete(8), hidden_size=H),
        obs_shape=OBS, input_size=H, hidden_size=H, use_kernel=use_kernel)
    lstm.load_state_dict(torch_import.convert(ref))
    assert lstm.route(4, 'cpu') == ('enc5' if use_kernel else 'off')
    mods = chip_smoke.reference_modules(torch, ref, 'cpu')
    x = torch.randn(6, 4, *OBS, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = chip_smoke.reference_math(mods, x.reshape(6, 4, -1), None)
        got = lstm(x)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('nvec,recurrent', [((8,), False),
    ((5, 4, 3), False), ((8,), True), ((5, 4, 3), True)])
def test_export_matches_jax(nvec, recurrent):
    """export of the port's state_dict (as the module holds it, and under
    Policy's `module.`) equals JAX's export of the same weights carried
    to flax, key for key and exactly; convert(export(sd)) == sd."""
    _, tmod = _modules(nvec, recurrent)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in tmod.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    sd = tmod.state_dict()
    params = jax_torch_import.convert(torch_import.export(sd, list(nvec)))
    want = jax_torch_import.export(params, list(nvec))
    for wrapped in (sd, {f'module.{k}': v for k, v in sd.items()}):
        got = torch_import.export(wrapped, list(nvec))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    back = torch_import.convert(torch_import.export(sd, list(nvec)))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_convert_errors_keep_the_jax_messages():
    sd = reference_state_dict((8,), False)
    no_decoder = {k: v for k, v in sd.items() if 'decoder' not in k}
    for fn in (torch_import.convert_default, jax_torch_import.convert_default):
        with pytest.raises(ValueError, match='no decoder weights'):
            fn(no_decoder)
    for fn in (torch_import.convert_lstm, jax_torch_import.convert_lstm):
        with pytest.raises(ValueError, match='no recurrent'):
            fn(wrap_layout(sd, 'cleanrl'))
    with pytest.raises(ValueError, match='does not tile'):
        torch_import.export(torch_import.convert(sd), [3, 4])
    assert torch_import.is_reference(sd)
    assert not torch_import.is_reference(torch_import.convert(sd))
    assert not torch_import.is_reference(Policy(Default(OBS,
        spaces.Discrete(8), hidden_size=H)).state_dict())


def test_convert_takes_a_module():
    """A reference module (here a stand-in with its keys) converts through
    its state_dict, wrapper=True gives Policy's keys."""
    ref = reference_state_dict((8,), False)

    class Ref(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = torch.nn.Linear(49, H)
            self.decoder = torch.nn.Linear(H, 8)
            self.value_head = torch.nn.Linear(H, 1)

    mod = Ref()
    mod.load_state_dict(ref)
    policy = Policy(Default(OBS, spaces.Discrete(8), hidden_size=H))
    policy.load_state_dict(torch_import.convert(mod, wrapper=True))
    for k, v in torch_import.convert(ref).items():
        assert torch.equal(policy.module.state_dict()[k], v)


# the classes whose instances were unpickled, in order
UNPICKLED = []


class Tripwire(torch.nn.Linear):
    """A module that records its unpickling."""

    def __setstate__(self, state):
        UNPICKLED.append(type(self).__name__)
        super().__setstate__(state)


@contextlib.contextmanager
def reference_package():
    """A stand-in `pufferlib` package whose models.Default has the
    reference Default's layers and records its unpickling; taken away on
    exit, as a machine without the reference sees a file that pickles
    it."""
    package = types.ModuleType('pufferlib')
    models = types.ModuleType('pufferlib.models')

    class Default(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = torch.nn.Linear(49, H)
            self.decoder = torch.nn.Linear(H, 8)
            self.value_head = torch.nn.Linear(H, 1)

        def __setstate__(self, state):
            UNPICKLED.append(type(self).__name__)
            super().__setstate__(state)

    Default.__module__ = 'pufferlib.models'
    Default.__qualname__ = 'Default'
    models.Default = Default
    package.models = models
    sys.modules['pufferlib'] = package
    sys.modules['pufferlib.models'] = models
    try:
        yield Default
    finally:
        del sys.modules['pufferlib'], sys.modules['pufferlib.models']


def test_pickled_reference_module_names_the_package(tmp_path):
    path = str(tmp_path / 'model_000001.pt')
    with reference_package() as Default:
        torch.save(Default(), path)
    with pytest.raises(ImportError, match="'pufferlib'") as e:
        torch_import.load_pt(path)
    assert e.value.name == 'pufferlib'
    with pytest.raises(ImportError, match="'pufferlib'"):
        read_policy(path, unpickle_reference=True)


def test_the_store_refuses_a_pickled_module_unread(tmp_path):
    """The store unpickles no module, a reference one either; read_policy
    unpickles it where the caller asks, and converts it."""
    ref = reference_state_dict((8,), False)
    path = str(tmp_path / 'model_000001.pt')
    with reference_package() as Default:
        mod = Default()
        mod.load_state_dict(ref)
        torch.save(mod, path)
        UNPICKLED.clear()
        with pytest.raises(APIUsageError, match='not unpickled here'):
            PolicyStore(str(tmp_path)).get_policy('model_000001')
        assert UNPICKLED == []
        got = read_policy(path, unpickle_reference=True)
    assert UNPICKLED == ['Default']
    want = torch_import.convert(ref, wrapper=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_a_pickle_of_no_reference_module_is_refused_unread(tmp_path,
        monkeypatch):
    """A pickled object of no reference class is refused without being
    unpickled: by the store, by read_policy where the caller asks for a
    reference module, and by demo_torch.py --model-path."""
    path = str(tmp_path / 'model_000001.pt')
    torch.save(Tripwire(2, 2), path)
    monkeypatch.setenv('PUFFER_EVAL_STEPS', '1')
    monkeypatch.setenv('PUFFER_EVAL_DELAY', '0')
    UNPICKLED.clear()
    reads = (lambda: PolicyStore(str(tmp_path)).get_policy('model_000001'),
        lambda: read_policy(path, unpickle_reference=True),
        lambda: demo_torch.main(['--env', 'squared', '--mode', 'eval',
            '--train.device', 'cpu', '--model-path', path]))
    for read in reads:
        with pytest.raises(APIUsageError, match='was not unpickled'):
            read()
    assert UNPICKLED == []
    # the tripwire works: an unpickling records it
    torch.load(path, weights_only=False)
    assert UNPICKLED == ['Tripwire']


def test_policy_store_converts_a_reference_file(tmp_path):
    ref = reference_state_dict((8,), True)
    torch.save(ref, str(tmp_path / 'model_000001.pt'))
    torch.save(wrap_layout(ref, 'cleanrl'), str(tmp_path /
        'model_000002.pt'))
    store = PolicyStore(str(tmp_path))
    want = torch_import.convert(ref, wrapper=True)
    for name in store.policy_names():
        got = store.get_policy(name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    policy = RecurrentPolicy(LSTMWrapper(Default(OBS, spaces.Discrete(8),
        hidden_size=H), obs_shape=OBS, input_size=H, hidden_size=H))
    policy.load_state_dict(store.get_policy('model_000001'), strict=True)


@pytest.mark.parametrize('recurrent', [False, True])
def test_demo_eval_plays_a_reference_file(tmp_path, monkeypatch, capsys,
        recurrent):
    """demo_torch.py --mode eval --model-path ref.pt on squared (the
    port's Default h128, with --use-rnn its LSTM): the reference file
    loads converted and plays."""
    monkeypatch.setattr(sys.modules[__name__], 'H', 128)
    path = str(tmp_path / 'ref.pt')
    torch.save(reference_state_dict((8,), recurrent), path)
    monkeypatch.setenv('PUFFER_EVAL_STEPS', '2')
    monkeypatch.setenv('PUFFER_EVAL_DELAY', '0')
    argv = ['--env', 'squared', '--mode', 'eval', '--train.device', 'cpu',
        '--model-path', path] + (['--use-rnn', 'True'] if recurrent else [])
    demo_torch.main(argv)
    assert capsys.readouterr().out.count('Reward:') == 2
    # the other architecture's keys do not fit: refused
    torch.save(reference_state_dict((8,), not recurrent), path)
    with pytest.raises(APIUsageError, match='not a state_dict of this '
            'policy'):
        demo_torch.main(argv)


def test_cleanrl_reexports_the_ports_objects():
    from pufferlib_tpu_torch.models import distributions, policy
    assert cleanrl.Policy is policy.Policy
    assert cleanrl.RecurrentPolicy is policy.RecurrentPolicy
    for name in ('sample_logits', 'log_prob', 'entropy'):
        assert getattr(cleanrl, name) is getattr(distributions, name)


# --------------------------------------------------------------------------
# Stable-Baselines3, against a fake stable_baselines3


class _TinyGym(gymnasium.Env):
    observation_space = gymnasium.spaces.Box(0, 1, (3,), np.float32)
    action_space = gymnasium.spaces.Discrete(2)

    def reset(self, seed=None, options=None):
        return np.zeros(3, np.float32), {}

    def step(self, action):
        return np.zeros(3, np.float32), 1.0, True, False, {}


def _install_fake_sb3(monkeypatch):
    calls = {}

    class DummyVecEnv:
        pass

    def make_vec_env(fn, n_envs, seed, vec_env_cls):
        envs = [fn() for _ in range(n_envs)]
        calls['make_vec_env'] = dict(envs=envs, seed=seed,
            vec_env_cls=vec_env_cls)
        return envs

    class PPO:
        def __init__(self, policy, envs, verbose, n_epochs, gamma):
            calls['PPO'] = dict(policy=policy, envs=envs, n_epochs=n_epochs,
                gamma=gamma)

        def learn(self, total_timesteps):
            calls['learn'] = total_timesteps

        def save(self, path):
            calls['save'] = path

    root = types.ModuleType('stable_baselines3')
    root.PPO = PPO
    common = types.ModuleType('stable_baselines3.common')
    env_util = types.ModuleType('stable_baselines3.common.env_util')
    env_util.make_vec_env = make_vec_env
    vec_env = types.ModuleType('stable_baselines3.common.vec_env')
    vec_env.DummyVecEnv = DummyVecEnv
    for name, mod in {'stable_baselines3': root,
            'stable_baselines3.common': common,
            'stable_baselines3.common.env_util': env_util,
            'stable_baselines3.common.vec_env': vec_env}.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def test_sb3_trains_on_a_host_creator(monkeypatch):
    calls = _install_fake_sb3(monkeypatch)
    model = sb3.train_sb3(lambda: GymnasiumPufferEnv(env=_TinyGym()),
        n_envs=3, seed=5, total_timesteps=64, update_epochs=2, gamma=0.9)
    envs = calls['make_vec_env']['envs']
    assert len(envs) == 3 and all(isinstance(e, GymnasiumAdapter)
        for e in envs)
    assert isinstance(envs[0], gymnasium.Env)
    assert envs[0].reset(seed=0)[0].shape == (3,)
    assert calls['make_vec_env']['seed'] == 5
    assert calls['PPO']['n_epochs'] == 2 and calls['PPO']['gamma'] == 0.9
    assert calls['learn'] == 64 and model is not None


def test_sb3_refuses_multiagent_and_device_envs():
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.environments.test import host_fixtures
    with pytest.raises(TypeError, match='single-agent'):
        sb3.make_sb3_env_fn(lambda: host_fixtures.make_fake_nmmo(2))()
    with pytest.raises(TypeError, match='device-native'):
        sb3.make_sb3_env_fn(env_creator('squared'))()
    assert isinstance(host_fixtures.make_fake_nmmo(2), PettingZooPufferEnv)


def test_sb3_absent_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, 'stable_baselines3', None)
    with pytest.raises(ImportError, match='stable_baselines3'):
        sb3.train_sb3(lambda: GymnasiumPufferEnv(env=_TinyGym()))


def test_sb3_backend_and_demo_reach_the_bridge(monkeypatch, tmp_path):
    """--backend sb3 and sb3_demo_torch.py call frameworks.sb3.train_sb3:
    on squared (a device env) its TypeError; on nethack over a fake nle
    it trains and saves."""
    calls = _install_fake_sb3(monkeypatch)
    with pytest.raises(TypeError, match='device-native'):
        demo_torch.main(['--env', 'squared', '--backend', 'sb3',
            '--train.device', 'cpu'])
    import test_zoo_fake_backends as fakes
    monkeypatch.setitem(sys.modules, 'nle', types.ModuleType('nle'))
    monkeypatch.setattr(gymnasium, 'make', lambda name, **kw:
        fakes.FakeNetHack())
    monkeypatch.chdir(tmp_path)
    import sb3_demo_torch
    sb3_demo_torch.main(['--env', 'nethack', '--timesteps', '32',
        '--n-envs', '2'])
    assert calls['learn'] == 32 and calls['save'] == 'ppo_nethack'
    assert len(calls['make_vec_env']['envs']) == 2


# --------------------------------------------------------------------------
# RLlib, against tests/test_rllib_bridge.py's fake ray (copied)


def _install_fake_ray(monkeypatch):
    registry = {}

    ray = types.ModuleType('ray')
    tune = types.ModuleType('ray.tune')
    tune_registry = types.ModuleType('ray.tune.registry')
    tune_registry.register_env = lambda name, fn: registry.update(
        {name: fn})
    rllib_mod = types.ModuleType('ray.rllib')
    rllib_env = types.ModuleType('ray.rllib.env')

    class ParallelPettingZooEnv:
        def __init__(self, env):
            self.par_env = env

    rllib_env.ParallelPettingZooEnv = ParallelPettingZooEnv
    policy_mod = types.ModuleType('ray.rllib.policy')
    policy_policy = types.ModuleType('ray.rllib.policy.policy')

    class PolicySpec:
        def __init__(self, policy_class=None, observation_space=None,
                action_space=None, config=None):
            self.policy_class = policy_class
            self.observation_space = observation_space
            self.action_space = action_space
            self.config = config

    policy_policy.PolicySpec = PolicySpec
    models = types.ModuleType('ray.rllib.models')
    models_torch = types.ModuleType('ray.rllib.models.torch')
    modelv2 = types.ModuleType('ray.rllib.models.torch.torch_modelv2')

    class TorchModelV2:
        def __init__(self, *args):
            self.model_args = args

    modelv2.TorchModelV2 = TorchModelV2
    recurrent = types.ModuleType('ray.rllib.models.torch.recurrent_net')

    class RecurrentNetwork(TorchModelV2):
        pass

    recurrent.RecurrentNetwork = RecurrentNetwork

    for name, mod in {
            'ray': ray, 'ray.tune': tune,
            'ray.tune.registry': tune_registry,
            'ray.rllib': rllib_mod, 'ray.rllib.env': rllib_env,
            'ray.rllib.policy': policy_mod,
            'ray.rllib.policy.policy': policy_policy,
            'ray.rllib.models': models,
            'ray.rllib.models.torch': models_torch,
            'ray.rllib.models.torch.torch_modelv2': modelv2,
            'ray.rllib.models.torch.recurrent_net': recurrent,
    }.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return registry


def test_register_env_gymnasium(monkeypatch):
    registry = _install_fake_ray(monkeypatch)
    rllib.register_env('tiny', lambda: GymnasiumPufferEnv(env=_TinyGym()))
    env = registry['tiny']({})
    assert isinstance(env, gymnasium.Env)
    assert isinstance(env.action_space, gymnasium.spaces.Discrete)
    assert env.reset(seed=0)[0].shape == (3,)
    with pytest.raises(TypeError):
        rllib.register_env(123, lambda: None)


def test_register_env_pettingzoo_wrapped(monkeypatch):
    from pufferlib_tpu_torch.environments.test import host_fixtures
    registry = _install_fake_ray(monkeypatch)
    rllib.register_env('multi', lambda: host_fixtures.make_fake_nmmo(2))
    wrapped = registry['multi']({})
    assert type(wrapped).__name__ == 'ParallelPettingZooEnv'
    assert isinstance(wrapped.par_env, PettingZooPufferEnv)


def test_create_policies_and_checkpoints(monkeypatch, tmp_path):
    _install_fake_ray(monkeypatch)
    specs = rllib.create_policies(3, config={'gamma': 0.9})
    assert set(specs) == {'policy_0', 'policy_1', 'policy_2'}
    assert specs['policy_1'].config == {'gamma': 0.9}
    assert rllib.read_checkpoints(tmp_path) == []
    (tmp_path / 'trial_a').mkdir()
    (tmp_path / 'trial_b').mkdir()
    with pytest.raises(ValueError):
        rllib.read_checkpoints(tmp_path)


@pytest.mark.parametrize('nvec', [(8,), (5, 4, 3)])
def test_make_policy_feed_forward(monkeypatch, nvec):
    """The adapter runs the port's Default (or Policy around it) as it is:
    its logits side by side, its value after the forward."""
    _install_fake_ray(monkeypatch)
    tspace = _spaces(nvec)[1]

    def build(wrapped, **kw):
        module = Default(OBS, tspace, hidden_size=H,
            generator=torch.Generator().manual_seed(0))
        return Policy(module) if wrapped else module

    x = torch.randn(4, *OBS)
    for wrapped in (False, True):
        cls = rllib.make_policy(build, lstm_layers=0)
        model = cls('obs_space', 'action_space', sum(nvec), {}, 'name',
            wrapped=wrapped)
        assert model.model_args[2] == sum(nvec)
        logits, state = model.forward({'obs': x}, [], None)
        want_logits, want_value = build(False)(x)
        want_logits = torch.cat(want_logits, -1) if len(nvec) > 1 \
            else want_logits
        assert torch.equal(logits, want_logits) and state == []
        assert torch.equal(model.value_function(), want_value.reshape(-1))
        assert any(p.requires_grad for p in model.parameters())


def test_make_policy_recurrent(monkeypatch):
    """The adapter runs the port's LSTMWrapper (or RecurrentPolicy): its
    initial state from num_layers / hidden_size, RLlib's (B, layers, H)
    state carried through the wrapper's (layers, B, H)."""
    _install_fake_ray(monkeypatch)

    def build(wrapped):
        lstm = LSTMWrapper(Default(OBS, spaces.Discrete(8), hidden_size=H,
            generator=torch.Generator().manual_seed(0)), obs_shape=OBS,
            input_size=H, hidden_size=H,
            generator=torch.Generator().manual_seed(1))
        return RecurrentPolicy(lstm) if wrapped else lstm

    x = torch.randn(4, T, *OBS)
    for wrapped in (False, True):
        model = rllib.make_policy(build, lstm_layers=1)('modelv2-args',
            wrapped=wrapped)
        h0, c0 = model.get_initial_state()
        assert h0.shape == (1, H) and c0.shape == (1, H)
        state = [torch.randn(4, 1, H), torch.randn(4, 1, H)]
        logits, (h, c) = model.forward_rnn(x, state, None)
        want_logits, want_value, (want_h, want_c) = build(False)(x,
            tuple(s.transpose(0, 1) for s in state))
        assert logits.shape == (4, T, 8)
        assert torch.equal(logits.reshape(4 * T, 8), want_logits)
        assert torch.equal(h, want_h.transpose(0, 1))
        assert torch.equal(c, want_c.transpose(0, 1))
        assert model.value_function().shape == (4 * T,)
        assert torch.equal(model.value_function(), want_value.reshape(-1))


def test_rllib_ppo_torch_needs_ray(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ray', None)
    import rllib_ppo_torch
    with pytest.raises(ImportError, match='ray'):
        rllib_ppo_torch.main(['--env', 'squared'])
