"""Nocturne binding (counterpart of
pufferlib_tpu/environments/nocturne/__init__.py; reference
pufferlib/environments/nocturne/environment.py:19-45): BaseEnv from a
yaml config, truncated to one scenario file, PettingZoo-ified with
float32 obs, multi-agent episode stats. make needs nocturne, which is
not installed here: it raises.
"""
import functools
import os

import numpy as np


class NocturneWrapper:
    """Dict-API Nocturne BaseEnv -> pettingzoo ParallelEnv (reference
    NocturneWrapper, nocturne/environment.py:35-76)."""

    def __init__(self, env):
        self.env = env
        obs = env.reset()
        self.possible_agents = list(obs.keys())
        self.agents = list(obs.keys())
        self.render_mode = None

    def observation_space(self, agent):
        return self.env.observation_space

    def action_space(self, agent):
        return self.env.action_space

    def reset(self, seed=None):
        obs = self.env.reset()
        self.agents = list(obs.keys())
        obs = {k: np.asarray(v, np.float32) for k, v in obs.items()}
        return obs, {a: {} for a in self.agents}

    def step(self, actions):
        obs, rewards, dones, infos = self.env.step(actions)
        obs = {k: np.asarray(v, np.float32) for k, v in obs.items()}
        truncs = {a: False for a in dones}
        self.agents = [a for a, d in dones.items() if not d]
        return obs, rewards, dones, truncs, infos

    def close(self):
        self.env.close()


def env_creator(name='nocturne'):
    return functools.partial(make, name)


def wrap(env):
    """The binding's stack over a BaseEnv: its scenarios truncated to the
    first file, NocturneWrapper, MultiagentEpisodeStats, MeanOverAgents,
    PettingZooPufferEnv."""
    from pufferlib_tpu_torch.host_env import PettingZooPufferEnv
    from pufferlib_tpu_torch.postprocess import (
        MeanOverAgents, MultiagentEpisodeStats)
    env.files = env.files[:1]
    env = NocturneWrapper(env)
    env = MultiagentEpisodeStats(env)
    env = MeanOverAgents(env)
    return PettingZooPufferEnv(env=env)


def make(name='nocturne', config_path=None, render_mode=None):
    try:
        from nocturne.envs.base_env import BaseEnv
    except ImportError as e:
        raise ImportError('nocturne is not installed in this image') from e
    config_path = config_path or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'env_config.yaml')
    if os.path.exists(config_path):
        import yaml
        with open(config_path) as f:
            env_config = yaml.safe_load(f)
    else:
        # nocturne installs ship scenario paths; without a user config
        # fall back to the library defaults
        env_config = {}
    return wrap(BaseEnv(config=env_config))
