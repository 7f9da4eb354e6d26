"""The port's CLI config (pufferlib_tpu_torch.config.cli) and the utils
it needs, against the JAX package's.

- load_config of both packages on the same argv gives the same train,
  env_kwargs, policy and rnn sections (and the same top-level fields),
  exactly, for every config.yaml section whose env package the port has;
  the one difference is train.device: config.yaml's 'tpu' is the card,
  'cuda'. Every section's package is in the port; one renamed to a
  package that does not exist raises the port's APIUsageError naming it.
- make_policy builds the same architecture: with the JAX parameters
  carried across by convert.py the forward outputs agree to 1e-5 in f32
  for squared (Default) and memory (LSTMWrapper, the plain scan on the
  CPU).
- get_init_args, compare_space_samples and Suppress behave as the JAX
  package's.
"""
import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax
from pufferlib_tpu import utils as jutils
from pufferlib_tpu import vector as jvector
from pufferlib_tpu.config import cli as jcli
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy

from pufferlib_tpu_torch import utils, vector
from pufferlib_tpu_torch.config import cli
from pufferlib_tpu_torch.convert import default_state_dict, lstm_state_dict
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import RecurrentPolicy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, 'config.yaml')) as f:
    SECTIONS = yaml.safe_load(f)
# the last zoo slice: the packages of the bindings without an LSTM policy
ZOO2_PACKAGES = ('bsuite', 'butterfly', 'classic_control', 'crafter',
    'dm_control', 'dm_lab', 'griddly', 'links_awaken', 'magent', 'microrts',
    'minerl', 'minigrid', 'nocturne', 'open_spiel', 'slimevolley', 'smac',
    'stable_retro', 'vizdoom')
PORT_PACKAGES = ('ocean', 'atari', 'test', 'nethack', 'minihack', 'nmmo',
    'nmmo3', 'pokemon_red', 'procgen') + ZOO2_PACKAGES


def _package(name):
    return SECTIONS[name].get('package', SECTIONS['default']['package'])


PORTED = sorted(n for n in SECTIONS
    if n != 'default' and _package(n) in PORT_PACKAGES)
NOT_PORTED = sorted(n for n in SECTIONS
    if n != 'default' and _package(n) not in PORT_PACKAGES)
ZOO2 = sorted(n for n in SECTIONS
    if n != 'default' and _package(n) in ZOO2_PACKAGES)


def _top(args):
    return {k: args[k] for k in ('env', 'env_name', 'backend', 'mode', 'vec',
        'exp_id', 'model_path', 'track', 'use_rnn', 'wandb_project',
        'wandb_group', 'package')} | {'sweep': args.sweep}


def _sections(args):
    return {s: dict(args[s]) for s in ('train', 'env_kwargs', 'policy',
        'rnn')}


@pytest.mark.parametrize('section', PORTED)
def test_load_config_matches_jax(section):
    argv = ['--env', section]
    try:
        jargs, _, _ = jcli.load_config(argv=argv)
    except Exception as e:
        # the 'ocean' package section names no creator: both refuse it
        with pytest.raises(type(e)):
            cli.load_config(argv=argv)
        return
    args, module, creator = cli.load_config(argv=argv)
    want = _sections(jargs)
    assert want['train']['device'] == 'tpu'
    want['train']['device'] = 'cuda'
    assert _sections(args) == want
    assert _top(args) == _top(jargs)
    assert module.__name__.startswith('pufferlib_tpu_torch.')
    assert callable(creator)


@pytest.mark.parametrize('argv', [
    ['--env', 'squared', '--train.learning_rate', '0.003',
        '--no-train.anneal_lr', '--env.num_targets', '2', '--use-rnn',
        'True', '--mode', 'sweep', '--exp-id', 'x'],
    ['--env', 'memory', '--policy.hidden_size', '64', '--train.seed', '7',
        '--vec', 'serial', '--track'],
    ['--env', 'breakout', '--train.num_envs', '8', '--env.framestack', '4'],
])
def test_flags_match_jax(argv):
    jargs, _, _ = jcli.load_config(argv=argv)
    args, _, _ = cli.load_config(argv=argv)
    want = _sections(jargs)
    want['train']['device'] = 'cuda'
    assert _sections(args) == want
    assert _top(args) == _top(jargs)


def test_every_section_is_ported():
    assert NOT_PORTED == []
    assert set(ZOO2_PACKAGES) <= {_package(n) for n in PORTED}


@pytest.mark.parametrize('section', ZOO2)
def test_missing_package_raises_named_error(section, tmp_path):
    """A section whose package does not exist raises the port's
    APIUsageError naming it: each of the last zoo slice's sections, its
    package renamed in a copy of config.yaml."""
    config = copy.deepcopy(SECTIONS)
    missing = f'no_such_{_package(section)}'
    config[section]['package'] = missing
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(config))
    with pytest.raises(APIUsageError,
            match=f"unknown env package '{missing}'"):
        cli.load_config(argv=['--env', section, '--config', str(path)])


def test_device_names():
    args, _, _ = cli.load_config(argv=['--env', 'squared',
        '--train.device', 'cpu'])
    assert args.train.device == 'cpu'
    args, _, _ = cli.load_config(argv=['--env', 'squared',
        '--train.device', 'tpu'])
    assert args.train.device == 'cuda'


def test_use_kernel_flag_only_when_given():
    args, _, _ = cli.load_config(argv=['--env', 'squared'])
    assert 'use_kernel' not in args.policy
    args, _, _ = cli.load_config(argv=['--env', 'squared',
        '--policy.use_kernel', 'True'])
    assert args.policy.use_kernel is True


def _cpu_args(env):
    args, module, creator = cli.load_config(argv=['--env', env,
        '--train.device', 'cpu'])
    jargs, jmodule, jcreator = jcli.load_config(argv=['--env', env])
    return (args, module, creator), (jargs, jmodule, jcreator)


@pytest.mark.parametrize('env,T', [('squared', 1), ('memory', 1),
    ('memory', 4)])
def test_make_policy_matches_jax(env, T):
    (args, module, creator), (jargs, jmodule, jcreator) = _cpu_args(env)
    N = 16
    vecenv = vector.make(creator, env_kwargs=dict(args.env_kwargs),
        num_envs=N, device='cpu')
    jvecenv = jvector.make(jcreator, env_kwargs=dict(jargs.env_kwargs),
        backend=jvector.Device, num_envs=N)
    policy = cli.make_policy(vecenv, module, args)
    jpolicy = jcli.make_policy(jvecenv, jmodule, jargs)
    recurrent = isinstance(jpolicy, JaxRecurrentPolicy)
    assert isinstance(policy, RecurrentPolicy) == recurrent

    rng = np.random.RandomState(0)
    shape = (N,) + ((T,) if T > 1 else ()) + tuple(
        vecenv.single_observation_space.shape)
    obs = rng.uniform(-1, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(0)
    if recurrent:
        params = jpolicy.init(key, obs[:1], jpolicy.initial_state(1))
        hidden = jpolicy.module.hidden_size
        h0 = (rng.randn(1, N, hidden) * 0.5).astype(np.float32)
        c0 = (rng.randn(1, N, hidden) * 0.5).astype(np.float32)
        jlogits, jvalue, (jh, jc) = jpolicy.module.apply(params, obs,
            (h0, c0))
        policy.module.load_state_dict(lstm_state_dict(
            jax.tree.map(np.asarray, params)))
        with torch.no_grad():
            logits, value, (h, c) = policy.module(torch.from_numpy(obs),
                (torch.from_numpy(h0), torch.from_numpy(c0)))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    else:
        params = jpolicy.init(key, obs[:1])
        jlogits, jvalue = jpolicy.module.apply(params, obs)
        policy.module.load_state_dict(default_state_dict(
            jax.tree.map(np.asarray, params)))
        with torch.no_grad():
            logits, value = policy.module(torch.from_numpy(obs))
    assert set(policy.state_dict()) == set(
        f'module.{k}' for k in policy.module.state_dict())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
        atol=1e-5)
    np.testing.assert_allclose(value.numpy().reshape(-1),
        np.asarray(jvalue).reshape(-1), atol=1e-5)


def test_make_policy_weights_follow_the_seed():
    (args, module, creator), _ = _cpu_args('squared')
    vecenv = vector.make(creator, env_kwargs=dict(args.env_kwargs),
        num_envs=4, device='cpu')
    a = cli.make_policy(vecenv, module, args).state_dict()
    b = cli.make_policy(vecenv, module, args).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    args.train.seed = 2
    c = cli.make_policy(vecenv, module, args).state_dict()
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_make_policy_dtype_names():
    (args, module, creator), _ = _cpu_args('squared')
    args.policy['dtype'] = 'bfloat16'
    vecenv = vector.make(creator, env_kwargs=dict(args.env_kwargs),
        num_envs=4, device='cpu')
    assert cli.make_policy(vecenv, module, args).module.dtype is \
        torch.bfloat16
    args.policy['dtype'] = 'no_such_dtype'
    with pytest.raises(ValueError, match='no_such_dtype'):
        cli.make_policy(vecenv, module, args)


def _creator(a, b=2, *args, episode_stats=True, **kwargs):
    return a


@pytest.mark.parametrize('fn', [_creator, None, lambda: 0,
    lambda env, policy, x=1: 0])
def test_get_init_args_matches_jax(fn):
    assert utils.get_init_args(fn) == jutils.get_init_args(fn)


@pytest.mark.parametrize('pair', [
    (np.arange(3), np.arange(6).reshape(2, 3), 0),
    (np.arange(3), np.arange(6).reshape(2, 3), 1),
    ({'a': np.ones(2), 'b': (np.zeros(1), 3)},
        {'a': np.ones((2, 2)), 'b': (np.zeros((2, 1)), [3, 3])}, 1),
    ((1, 2), (1, 2, 3), None),
    ({'a': 1}, {'b': 1}, None),
])
def test_compare_space_samples_matches_jax(pair):
    a, b, idx = pair
    assert utils.compare_space_samples(a, b, idx) == \
        jutils.compare_space_samples(a, b, idx)


def test_suppress_swallows_output(capfd):
    with utils.Suppress():
        print('hidden')
        os.write(1, b'hidden fd\n')
    print('shown')
    out = capfd.readouterr().out
    assert 'hidden' not in out and 'shown' in out
