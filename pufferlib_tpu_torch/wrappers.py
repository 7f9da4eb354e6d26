"""Host-env compat wrappers (counterpart of pufferlib_tpu/wrappers.py).

Parity: reference pufferlib/wrappers.py (GymToGymnasium 4-tuple ->
5-tuple :3-22, PettingZooTruncatedWrapper :24-57).
"""


class GymToGymnasium:
    """Old gym (4-tuple step, seed method) -> gymnasium (5-tuple)."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.render_mode = getattr(env, 'render_mode', None)
        self.metadata = getattr(env, 'metadata', {})

    def reset(self, seed=None, options=None):
        if seed is not None and hasattr(self.env, 'seed'):
            self.env.seed(seed)
        result = self.env.reset()
        if isinstance(result, tuple) and len(result) == 2:
            return result
        return result, {}

    def step(self, action):
        result = self.env.step(action)
        if len(result) == 4:
            obs, reward, done, info = result
            return obs, reward, done, False, info
        return result

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


class PettingZooTruncatedWrapper:
    """Normalize pettingzoo step outputs to 5-dict form with
    truncations."""

    def __init__(self, env):
        self.env = env
        self.possible_agents = env.possible_agents
        self.render_mode = getattr(env, 'render_mode', None)

    @property
    def agents(self):
        return self.env.agents

    def observation_space(self, agent):
        return self.env.observation_space(agent)

    def action_space(self, agent):
        return self.env.action_space(agent)

    def reset(self, seed=None):
        try:
            result = self.env.reset(seed=seed)
        except TypeError:
            result = self.env.reset()
        if isinstance(result, tuple):
            return result
        return result, {a: {} for a in self.env.agents}

    def step(self, actions):
        result = self.env.step(actions)
        if len(result) == 4:
            obs, rewards, dones, infos = result
            truncs = {k: False for k in dones}
            return obs, rewards, dones, truncs, infos
        return result

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()
