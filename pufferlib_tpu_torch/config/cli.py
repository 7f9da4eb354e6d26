"""Layered YAML config and the flags introspected from it (counterpart of
pufferlib_tpu/config/cli.py).

config.yaml's sections merge default -> package -> env; the env
creator's signature (get_init_args) and the train / env / policy / rnn
sections turn into flags such as --train.learning_rate and
--env.num_targets, with --no-<flag> for booleans. The result is the same
namespace tree as the JAX package's, read from the repository's own
config.yaml, with two differences:

- train.device 'tpu' (config.yaml's default) means the accelerator, which
  here is the card: it becomes 'cuda'. 'cpu' and 'cuda' pass through.
  The trainers raise where 'cuda' is asked for and no card is present.
- --policy.use_kernel (Default's fused MLP head kernel) is a flag of its
  own; it enters the policy section only when given.

Parity: reference demo.py:22-99.
"""
import argparse
import ast
import importlib
import inspect
import os

from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.namespace import namespace
from pufferlib_tpu_torch.utils import get_init_args

CONFIG_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'config.yaml')

# config.yaml's device names -> torch device types
_DEVICES = {'tpu': 'cuda'}


def _deep_update(base, extra):
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml_config(env_name, path=None):
    import yaml
    with open(path or CONFIG_PATH) as f:
        raw = yaml.safe_load(f)

    if env_name not in raw:
        # default + the env name as its creator's
        merged = dict(raw['default'])
        merged.setdefault('env', {})['name'] = env_name
        return merged

    section = raw[env_name]
    package = section.get('package', raw['default'].get('package'))
    merged = {}
    _deep_update(merged, raw['default'])
    if package in raw and package != env_name:
        _deep_update(merged, raw[package])
    _deep_update(merged, section)
    merged['package'] = package
    return merged


def resolve_env_module(package):
    """The env package: ocean is pufferlib_tpu_torch.ocean, any other
    pufferlib_tpu_torch.environments.<package>. A package that does not
    exist (or has no env_creator) raises."""
    name = 'pufferlib_tpu_torch.ocean' if package == 'ocean' else \
        f'pufferlib_tpu_torch.environments.{package}'
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        module = None
    if module is None or not hasattr(module, 'env_creator'):
        raise APIUsageError(
            f'unknown env package {package!r}: no {name} with an '
            'env_creator')
    return module


def torch_device(name):
    """The torch device type for a config.yaml device name."""
    return _DEVICES.get(name, name)


def _parse_value(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _add_section_flags(parser, section, values):
    for key, default in values.items():
        flag = f'--{section}.{key}'
        if isinstance(default, bool):
            parser.add_argument(flag, type=_parse_value, default=default)
            parser.add_argument(f'--no-{section}.{key}',
                dest=f'{section}.{key}', action='store_false')
        else:
            parser.add_argument(flag, type=_parse_value, default=default)


def load_config(env_name=None, argv=None, config_path=None):
    """(namespace tree, env module, env creator) from config.yaml and the
    flags in argv."""
    base = argparse.ArgumentParser(add_help=False)
    base.add_argument('--env', '--environment', default=env_name
        or 'squared')
    base.add_argument('--mode', default='train', choices=(
        'train', 'eval', 'sweep', 'autotune', 'profile', 'baseline',
        'bench'))
    base.add_argument('--vec', default='device',
        choices=('device', 'serial', 'multiprocessing'))
    base.add_argument('--backend', default='native',
        choices=('native', 'sb3'))
    base.add_argument('--exp-id', '--exp-name', default=None)
    base.add_argument('--model-path', default=None)
    base.add_argument('--track', action='store_true')
    base.add_argument('--config', default=config_path)
    base.add_argument('--wandb-project', default='pufferlib-tpu')
    base.add_argument('--wandb-group', default='debug')
    args, _ = base.parse_known_args(argv)

    cfg = load_yaml_config(args.env, args.config)
    package = cfg['package']
    env_module = resolve_env_module(package)

    # the creator's defaults, under the env section's own values
    env_cfg = dict(cfg.get('env', {}))
    creator_name = env_cfg.pop('name', args.env)
    creator = env_module.env_creator(creator_name)
    for k, v in get_init_args(creator).items():
        env_cfg.setdefault(k, v)

    parser = argparse.ArgumentParser(parents=[base])
    _add_section_flags(parser, 'train', cfg.get('train', {}))
    _add_section_flags(parser, 'env', env_cfg)
    policy_cfg = cfg.get('policy', {})
    _add_section_flags(parser, 'policy', policy_cfg)
    if 'use_kernel' not in policy_cfg:
        parser.add_argument('--policy.use_kernel', type=_parse_value,
            default=argparse.SUPPRESS)
    _add_section_flags(parser, 'rnn', cfg.get('rnn', {}))
    parser.add_argument('--use-rnn', type=_parse_value,
        default=cfg.get('use_rnn', False))
    parsed = vars(parser.parse_args(argv))

    out = namespace(
        env=args.env,
        env_name=creator_name,
        backend=parsed['backend'],
        sweep=cfg.get('sweep', {}),
        mode=parsed['mode'],
        vec=parsed['vec'],
        exp_id=parsed['exp_id'],
        model_path=parsed['model_path'],
        track=parsed['track'],
        use_rnn=parsed['use_rnn'],
        wandb_project=parsed['wandb_project'],
        wandb_group=parsed['wandb_group'],
        package=package,
        train=namespace(),
        env_kwargs=namespace(),
        policy=namespace(),
        rnn=namespace(),
    )
    for key, value in parsed.items():
        if '.' not in key:
            continue
        section, name = key.split('.', 1)
        target = {'train': out.train, 'env': out.env_kwargs,
            'policy': out.policy, 'rnn': out.rnn}[section]
        target[name] = value
    if 'device' in out.train:
        out.train['device'] = torch_device(out.train['device'])
    return out, env_module, creator


def _torch_dtype(name):
    import torch
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f'unknown dtype {name!r}')
    return dtype


def _takes(cls, name):
    return name in inspect.signature(cls).parameters


def make_policy(vecenv, env_module, args):
    """The policy for a vecenv (reference demo.py:101-110): the env
    package's Policy if it has one, else Default; inside
    RecurrentPolicy(LSTMWrapper) with use_rnn, else Policy. The weights
    are drawn from a generator seeded by train.seed."""
    import torch
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, Policy, RecurrentPolicy)

    obs_shape = vecenv.single_observation_space.shape
    atn_space = vecenv.single_action_space
    generator = torch.Generator().manual_seed(
        int(dict(args.train).get('seed', 1)))

    policy_kwargs = dict(args.policy)
    if isinstance(policy_kwargs.get('dtype'), str):
        policy_kwargs['dtype'] = _torch_dtype(policy_kwargs['dtype'])

    rnn_kwargs = {}
    if args.use_rnn:
        # the LSTM kwargs: the env package's Recurrent dict (reference
        # demo.py:103-108), then config.yaml's rnn section / --rnn.x flags
        rnn_kwargs = dict(getattr(env_module, 'Recurrent', None) or {})
        rnn_kwargs.update(dict(args.rnn))
        if isinstance(rnn_kwargs.get('dtype'), str):
            rnn_kwargs['dtype'] = _torch_dtype(rnn_kwargs['dtype'])
    hidden = rnn_kwargs.pop('hidden_size',
        policy_kwargs.get('hidden_size', 128))

    policy_cls = getattr(env_module, 'Policy', None)
    if policy_cls is not None:
        if _takes(policy_cls, 'emulated') and 'emulated' not in policy_kwargs:
            policy_kwargs['emulated'] = getattr(vecenv, 'emulated', None)
    else:
        policy_cls = Default
        policy_kwargs.setdefault('emulated', getattr(
            vecenv, 'emulated', None))
        if args.use_rnn:
            # the head reads the LSTM's output (the JAX head infers it)
            policy_kwargs.setdefault('decoder_input_size', hidden)
    if _takes(policy_cls, 'generator'):
        policy_kwargs.setdefault('generator', generator)
    module = policy_cls(obs_shape=obs_shape, action_space=atn_space,
        **policy_kwargs)

    if args.use_rnn:
        rnn_kwargs.setdefault('input_size', hidden)
        rnn_kwargs.setdefault('generator', generator)
        module = LSTMWrapper(policy=module, obs_shape=obs_shape,
            hidden_size=hidden, **rnn_kwargs)
        return RecurrentPolicy(module)
    return Policy(module)
