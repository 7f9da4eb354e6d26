"""Host-side env wrappers: external gymnasium/pettingzoo envs -> flat
Puffer interface (counterpart of pufferlib_tpu/host_env.py).

Parity: reference pufferlib/emulation.py:124-426 (GymnasiumPufferEnv /
PettingZooPufferEnv): emulated flat obs/action spaces, shared-buffer
writes, one-time space checks, reset-before-step and no-step-after-done
errors, PettingZoo fixed-agent padding + masks. These envs run on the
host CPU; the vector_host backends batch them and the host trainer
copies batches to the card. Neither torch nor gymnasium is imported
here (gymnasium only inside GymnasiumAdapter): envpool workers import
this module.
"""
import numpy as np

from pufferlib_tpu_torch import emulation, spaces
from pufferlib_tpu_torch.exceptions import APIUsageError, InvalidAgentError
from pufferlib_tpu_torch.namespace import namespace


def _seed_and_reset(env, seed):
    if seed is None:
        return env.reset()
    try:
        return env.reset(seed=seed)
    except TypeError:
        try:
            env.seed(seed)
        except AttributeError:
            pass
        return env.reset()


def check_space(data, space):
    try:
        if not isinstance(data, (dict, tuple, list)):
            data = np.asarray(data)
        contains = space.contains(data)
    except Exception:
        raise APIUsageError(
            f'Error checking space {space} with sample:\n{data}')
    if not contains:
        raise APIUsageError(f'Data:\n{data}\n not in space:\n{space}')
    return True


class GymnasiumPufferEnv:
    """Flatten a gymnasium env's nested spaces into flat arrays."""

    def __init__(self, env=None, env_creator=None, env_args=(),
            env_kwargs=None, buf=None):
        if (env is None) == (env_creator is None):
            raise ValueError('Provide exactly one of env / env_creator')
        self.env = env if env is not None else env_creator(
            *env_args, **(env_kwargs or {}))

        self.initialized = False
        self.done = True
        self.is_observation_checked = False
        self.is_action_checked = False

        obs_space = spaces.from_gymnasium(self.env.observation_space)
        atn_space = spaces.from_gymnasium(self.env.action_space)
        self.observation_space, self.obs_dtype = \
            emulation.emulate_observation_space(obs_space)
        self.action_space, self.atn_dtype = \
            emulation.emulate_action_space(atn_space)
        self.native_observation_space = obs_space
        self.native_action_space = atn_space
        self.single_observation_space = self.observation_space
        self.single_action_space = self.action_space
        self.num_agents = 1

        self.is_obs_emulated = self.observation_space is not obs_space
        self.is_atn_emulated = self.action_space is not atn_space
        self.emulated = namespace(
            observation_dtype=np.dtype(self.observation_space.dtype),
            emulated_observation_dtype=self.obs_dtype,
        )

        self.buf = buf  # injected shared-memory views
        self.obs, self.obs_struct = emulation.make_buffer(
            self.observation_space.dtype, self.obs_dtype)

    @property
    def render_mode(self):
        return getattr(self.env, 'render_mode', None)

    def _emulate(self, ob):
        if self.is_obs_emulated:
            emulation.emulate(self.obs_struct[0], ob)
        elif self.buf is not None:
            # injected rows may be flat OR native-shaped; reshape the
            # raveled byte view to whichever the slab uses
            self.obs[:] = np.asarray(ob).ravel().view(
                self.obs.dtype).reshape(self.obs.shape)
        else:
            self.obs = np.asarray(ob).reshape(
                self.observation_space.shape)

    def reset(self, seed=None):
        if not self.initialized and self.buf is not None:
            self.obs = self.buf.observations[0]
            if self.is_obs_emulated:
                self.obs_struct = self.obs.view(self.obs_dtype)
        self.initialized = True
        self.done = False

        ob, info = _seed_and_reset(self.env, seed)
        self._emulate(ob)

        if not self.is_observation_checked:
            self.is_observation_checked = check_space(
                self.obs, self.observation_space)

        if self.buf is not None:
            self.buf.rewards[0] = 0
            self.buf.terminals[0] = False
            self.buf.truncations[0] = False
            self.buf.masks[0] = True
        return self.obs, info

    def step(self, action):
        if not self.initialized:
            raise APIUsageError('step() called before reset()')
        if self.done:
            raise APIUsageError('step() called after environment is done')

        if self.is_atn_emulated:
            action = emulation.nativize_multidiscrete(
                action, self.native_action_space)
        elif isinstance(action, np.ndarray):
            action = action.ravel()
            if isinstance(self.action_space, spaces.Discrete):
                action = action[0]

        if not self.is_action_checked:
            self.is_action_checked = check_space(
                action, self.native_action_space)

        ob, reward, done, truncated, info = self.env.step(action)
        self._emulate(ob)

        if self.buf is not None:
            self.buf.rewards[0] = reward
            self.buf.terminals[0] = done
            self.buf.truncations[0] = truncated
            self.buf.masks[0] = True

        self.done = done or truncated
        return self.obs, reward, done, truncated, info

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


#: the real gymnasium.Env subclass backing GymnasiumAdapter; created on
#: first use (gymnasium imports stay lazy for worker spawn speed) and
#: cached at module scope so instances pickle (SB3 SubprocVecEnv) and
#: isinstance(x, GymnasiumAdapter) holds.
_gymnasium_adapter_cls = None


def _make_gymnasium_adapter_cls():
    global _gymnasium_adapter_cls
    if _gymnasium_adapter_cls is not None:
        return _gymnasium_adapter_cls
    import gymnasium

    class GymnasiumAdapterImpl(gymnasium.Env):
        metadata = {'render_modes': []}

        def __init__(self, inner):
            self._inner = inner
            self.observation_space = spaces.to_gymnasium(
                inner.single_observation_space)
            self.action_space = spaces.to_gymnasium(
                inner.single_action_space)
            self.render_mode = getattr(inner, 'render_mode', None)

        def reset(self, seed=None, options=None):
            super().reset(seed=seed)
            return self._inner.reset(seed=seed)

        def step(self, action):
            return self._inner.step(np.asarray(action))

        def render(self):
            return self._inner.render()

        def close(self):
            return self._inner.close()

    # register under a stable module-level name so pickle round-trips
    GymnasiumAdapterImpl.__qualname__ = 'GymnasiumAdapterImpl'
    globals()['GymnasiumAdapterImpl'] = GymnasiumAdapterImpl
    _gymnasium_adapter_cls = GymnasiumAdapterImpl
    return GymnasiumAdapterImpl


def __getattr__(name):
    # PEP 562: an UNPICKLING process imports this module fresh and asks
    # for GymnasiumAdapterImpl before the factory ever ran there (SB3
    # SubprocVecEnv under spawn); build the class on demand
    if name == 'GymnasiumAdapterImpl':
        return _make_gymnasium_adapter_cls()
    raise AttributeError(name)


class _GymnasiumAdapterMeta(type):
    def __instancecheck__(cls, obj):
        return (_gymnasium_adapter_cls is not None
            and isinstance(obj, _gymnasium_adapter_cls))

    def __call__(cls, puffer_env):
        return _make_gymnasium_adapter_cls()(puffer_env)


class GymnasiumAdapter(metaclass=_GymnasiumAdapterMeta):
    """Present a puffer host env as a REAL gymnasium.Env (gymnasium
    base class, gymnasium space objects, metadata) for third-party
    consumers that isinstance-check the contract — SB3, RLlib,
    gymnasium's own env checker. The puffer wrappers themselves stay
    duck-typed for speed; this is the boundary adapter.

    Calling GymnasiumAdapter(env) returns an instance of the cached
    module-level gymnasium.Env subclass, so instances are picklable
    and isinstance(x, GymnasiumAdapter) is True for them."""


class NativePufferEnv:
    """Adapter for reference-style NATIVE PufferEnv implementations —
    envs that already produce flat per-agent arrays (obs shape
    (num_agents, *space.shape), rewards/terminals (num_agents,)) and
    skip emulation entirely, e.g. nmmo3's PuffEnv (reference
    environments/nmmo3/environment.py:19-20; vector.py:652-655 accepts
    these directly). Presents the host-bridge surface (single_* spaces,
    buf injection, done flag) so HostSerial/HostMultiprocessing treat
    it like any bridged env."""

    def __init__(self, env=None, env_creator=None, env_args=(),
            env_kwargs=None, buf=None):
        if (env is None) == (env_creator is None):
            raise ValueError('Provide exactly one of env / env_creator')
        self.env = env if env is not None else env_creator(
            *env_args, **(env_kwargs or {}))
        obs_space = getattr(self.env, 'single_observation_space', None) \
            or self.env.observation_space
        atn_space = getattr(self.env, 'single_action_space', None) \
            or self.env.action_space
        self.single_observation_space = spaces.from_gymnasium(obs_space)
        self.single_action_space = spaces.from_gymnasium(atn_space)
        self.num_agents = int(self.env.num_agents)
        # native envs are pre-flattened: no emulation metadata
        self.emulated = None
        self.buf = buf
        self.done = True
        self.initialized = False

    @property
    def render_mode(self):
        return getattr(self.env, 'render_mode', None)

    def _write(self, obs, rewards, terminals, truncations):
        if self.buf is None:
            return
        self.buf.observations[:] = obs
        self.buf.rewards[:] = rewards
        self.buf.terminals[:] = terminals
        self.buf.truncations[:] = truncations
        self.buf.masks[:] = True

    def reset(self, seed=None):
        try:
            obs, info = self.env.reset(seed=seed)
        except TypeError:
            obs, info = self.env.reset()
        self.initialized = True
        self.done = False
        n = self.num_agents
        self._write(obs, np.zeros(n, np.float32), np.zeros(n, bool),
            np.zeros(n, bool))
        return obs, info

    def step(self, actions):
        if not self.initialized:
            raise APIUsageError('step() called before reset()')
        if self.done:
            raise APIUsageError('step() called after environment is done')
        obs, rewards, terminals, truncations, info = self.env.step(
            np.asarray(actions))
        self._write(obs, rewards, terminals, truncations)
        self.done = bool(np.all(terminals) or np.all(truncations))
        return obs, rewards, terminals, truncations, info

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


def pad_agent_data(data, agents, pad_value):
    return {agent: data[agent] if agent in data else pad_value
        for agent in agents}


class PettingZooPufferEnv:
    """Flatten a pettingzoo ParallelEnv: padded fixed agent set with
    per-agent masks, zero-padded missing agents (reference
    emulation.py:236-426)."""

    def __init__(self, env=None, env_creator=None, env_args=(),
            env_kwargs=None, buf=None):
        if (env is None) == (env_creator is None):
            raise ValueError('Provide exactly one of env / env_creator')
        self.env = env if env is not None else env_creator(
            *env_args, **(env_kwargs or {}))
        self.initialized = False
        self.all_done = True
        self.is_observation_checked = False
        self.is_action_checked = False

        single = self.possible_agents[0]
        obs_space = spaces.from_gymnasium(self.env.observation_space(single))
        atn_space = spaces.from_gymnasium(self.env.action_space(single))
        self.single_observation_space, self.obs_dtype = \
            emulation.emulate_observation_space(obs_space)
        self.single_action_space, self.atn_dtype = \
            emulation.emulate_action_space(atn_space)
        self.native_observation_space = obs_space
        self.native_action_space = atn_space
        self.is_obs_emulated = self.single_observation_space is not obs_space
        self.is_atn_emulated = self.single_action_space is not atn_space
        self.emulated = namespace(
            observation_dtype=np.dtype(self.single_observation_space.dtype),
            emulated_observation_dtype=self.obs_dtype,
        )
        self.num_agents = len(self.possible_agents)
        self.buf = buf
        self.obs, self.obs_struct = emulation.make_buffer(
            self.single_observation_space.dtype, self.obs_dtype,
            self.num_agents)
        if not self.is_obs_emulated:
            # non-emulated spaces keep their native row shape (a flat
            # row would fail the env's own space check for multi-dim
            # Box obs)
            self.obs = self.obs.reshape(
                self.num_agents, *self.single_observation_space.shape)

    @property
    def render_mode(self):
        return getattr(self.env, 'render_mode', None)

    @property
    def agents(self):
        return self.env.agents

    @property
    def possible_agents(self):
        return self.env.possible_agents

    @property
    def done(self):
        return len(self.agents) == 0 or self.all_done

    def observation_space(self, agent):
        if agent not in self.possible_agents:
            raise InvalidAgentError(agent, self.possible_agents)
        return self.single_observation_space

    def action_space(self, agent):
        if agent not in self.possible_agents:
            raise InvalidAgentError(agent, self.possible_agents)
        return self.single_action_space

    def _emulate(self, ob, i):
        if self.is_obs_emulated:
            emulation.emulate(self.obs_struct[i], ob)
        else:
            self.obs[i] = np.asarray(ob).ravel().view(
                self.obs.dtype).reshape(self.obs[i].shape)

    def reset(self, seed=None):
        if not self.initialized and self.buf is not None:
            self.obs = self.buf.observations
            if self.is_obs_emulated:
                self.obs_struct = self.obs.view(self.obs_dtype).reshape(
                    self.num_agents, -1)
        self.initialized = True
        self.all_done = False
        self.mask = {k: False for k in self.possible_agents}

        obs, info = _seed_and_reset(self.env, seed)
        for i, agent in enumerate(self.possible_agents):
            if agent not in obs:
                self.obs[i] = 0
                continue
            self._emulate(obs[agent], i)
            self.mask[agent] = True

        if not self.is_observation_checked:
            self.is_observation_checked = check_space(
                self.obs[0], self.single_observation_space)

        if self.buf is not None:
            self.buf.rewards[:] = 0
            self.buf.terminals[:] = False
            self.buf.truncations[:] = False
            self.buf.masks[:] = True
        return {agent: self.obs[i] for i, agent in
            enumerate(self.possible_agents)}, info

    def step(self, actions):
        if not self.initialized:
            raise APIUsageError('step() called before reset()')
        if self.done:
            raise APIUsageError('step() called after environment is done')

        if isinstance(actions, np.ndarray):
            if not self.is_action_checked and len(actions) != self.num_agents:
                raise APIUsageError(
                    f'Actions len {len(actions)} != {self.num_agents} agents')
            actions = {agent: actions[i]
                for i, agent in enumerate(self.possible_agents)}

        if not self.is_action_checked:
            for agent in actions:
                if agent not in self.possible_agents:
                    raise InvalidAgentError(agent, self.possible_agents)
            self.is_action_checked = check_space(
                next(iter(actions.values())), self.single_action_space)

        unpacked = {}
        for agent, atn in actions.items():
            if agent not in self.possible_agents:
                raise InvalidAgentError(agent, self.agents)
            if agent not in self.agents:
                continue
            if self.is_atn_emulated:
                # flat MultiDiscrete vector -> nested native action
                # (a structured-dtype cast would broadcast component 0
                # to every leaf)
                atn = emulation.nativize_multidiscrete(
                    atn, self.native_action_space)
            elif isinstance(self.single_action_space, spaces.Discrete):
                atn = int(np.asarray(atn).ravel()[0])
            unpacked[agent] = atn

        obs, rewards, dones, truncateds, infos = self.env.step(unpacked)

        self.mask = {k: False for k in self.possible_agents}
        for i, agent in enumerate(self.possible_agents):
            if agent not in obs:
                self.obs[i] = 0
                if self.buf is not None:
                    self.buf.rewards[i] = 0
                    self.buf.terminals[i] = True
                    self.buf.truncations[i] = False
                    self.buf.masks[i] = False
                continue
            self.mask[agent] = True
            self._emulate(obs[agent], i)
            if self.buf is not None:
                self.buf.rewards[i] = rewards[agent]
                self.buf.terminals[i] = dones[agent]
                self.buf.truncations[i] = truncateds[agent]
                self.buf.masks[i] = True

        self.all_done = all(dones.values()) if dones else True
        rewards = pad_agent_data(rewards, self.possible_agents, 0)
        dones = pad_agent_data(dones, self.possible_agents, True)
        truncateds = pad_agent_data(truncateds, self.possible_agents, False)
        dict_obs = {agent: self.obs[i]
            for i, agent in enumerate(self.possible_agents)}
        return dict_obs, rewards, dones, truncateds, infos

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()
