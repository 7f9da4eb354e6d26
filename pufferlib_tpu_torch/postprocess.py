"""Host-env info postprocessing wrappers (counterpart of
pufferlib_tpu/postprocess.py).

Parity: reference pufferlib/postprocess.py — EpisodeStats (:8-54,
accumulate infos + episode_return/length, emit only at terminal),
PettingZooWrapper base (:56), MeanOverAgents (:103),
MultiagentEpisodeStats (:133). These wrap raw host envs; the batched
analog is environment.EpisodeStats.
"""
from collections import defaultdict

import numpy as np


class EpisodeStats:
    """Gymnasium wrapper: accumulate per-episode return/length and emit
    aggregated infos only when the episode ends — the key IPC-bandwidth
    optimization (empty infos are pruned before the pipe)."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.render_mode = getattr(env, 'render_mode', None)
        self.reset_stats()

    def reset_stats(self):
        self.info = defaultdict(list)
        self.episode_return = 0.0
        self.episode_length = 0

    def reset(self, seed=None, options=None):
        self.reset_stats()
        try:
            return self.env.reset(seed=seed)
        except TypeError:
            return self.env.reset()

    def step(self, action):
        observation, reward, terminated, truncated, info = \
            self.env.step(action)
        for k, v in info.items():
            try:
                self.info[k].append(float(v))
            except (TypeError, ValueError):
                self.info[k] = v
        self.episode_return += reward
        self.episode_length += 1

        out = {}
        if terminated or truncated:
            for k, v in self.info.items():
                out[k] = np.mean(v) if isinstance(v, list) else v
            out['episode_return'] = self.episode_return
            out['episode_length'] = self.episode_length
        return observation, reward, terminated, truncated, out

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


class PettingZooWrapper:
    """Base pass-through ParallelEnv wrapper."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def observation_space(self, agent):
        return self.env.observation_space(agent)

    def action_space(self, agent):
        return self.env.action_space(agent)


class MeanOverAgents(PettingZooWrapper):
    """Average per-agent infos into a single dict."""

    def _mean(self, infos):
        list_infos = defaultdict(list)
        for agent, info in infos.items():
            for k, v in info.items():
                try:
                    list_infos[k].append(float(v))
                except (TypeError, ValueError):
                    list_infos[k] = v
        return {k: np.mean(v) if isinstance(v, list) else v
            for k, v in list_infos.items()}

    def reset(self, seed=None):
        obs, infos = self.env.reset(seed=seed)
        return obs, self._mean(infos)

    def step(self, actions):
        obs, rewards, terminations, truncations, infos = \
            self.env.step(actions)
        return obs, rewards, terminations, truncations, self._mean(infos)


class MultiagentEpisodeStats(PettingZooWrapper):
    """Per-agent episode return/length, emitted at each agent's end."""

    def reset(self, seed=None):
        result = self.env.reset(seed=seed)
        self.returns = {a: 0.0 for a in self.env.possible_agents}
        self.lengths = {a: 0 for a in self.env.possible_agents}
        self.infos = {a: defaultdict(list) for a in self.env.possible_agents}
        return result

    def step(self, actions):
        obs, rewards, terminations, truncations, infos = \
            self.env.step(actions)
        out_infos = {}
        for agent in rewards:
            self.returns[agent] += rewards[agent]
            self.lengths[agent] += 1
            for k, v in infos.get(agent, {}).items():
                try:
                    self.infos[agent][k].append(float(v))
                except (TypeError, ValueError):
                    self.infos[agent][k] = v
            out = {}
            if terminations.get(agent) or truncations.get(agent):
                for k, v in self.infos[agent].items():
                    out[k] = np.mean(v) if isinstance(v, list) else v
                out['episode_return'] = self.returns[agent]
                out['episode_length'] = self.lengths[agent]
            out_infos[agent] = out
        return obs, rewards, terminations, truncations, out_infos
