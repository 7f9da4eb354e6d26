"""Vectorization: many env lanes as batched tensors on one device.

Counterpart of pufferlib_tpu/vector.py. `Device` keeps the JAX package's
sync (reset/step) and async (async_reset/send/recv) protocol and its flag
state machine; its lanes are one batch of tensors instead of a vmap.
Optional batch_size < num_envs cycles contiguous lane groups, the
envpool's worker-block mode. Randomness comes from one torch.Generator on
the device, seeded by `async_reset(seed)`; reset draws can be injected
per call (`send(actions, reset_draws=...)`) so a test can replay another
implementation's draws.
"""
import numpy as np
import torch

from pufferlib_tpu_torch import emulation, resolve_device, spaces
from pufferlib_tpu_torch.environment import autoreset_step
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.namespace import namespace

RESET, STEP, SEND, RECV, CLOSE, MAIN, INFO = range(7)


def recv_precheck(vecenv):
    if vecenv.flag != RECV:
        raise APIUsageError('Call reset before stepping')
    vecenv.flag = SEND


def send_precheck(vecenv, actions):
    if vecenv.flag != SEND:
        raise APIUsageError('Call (async) reset + recv before sending')
    if not vecenv.initialized:
        vecenv.initialized = True
        if isinstance(actions, torch.Tensor):
            actions = actions.cpu().numpy()
        check_actions(np.asarray(actions), vecenv.single_action_space,
            vecenv.batch_agents)
    vecenv.flag = RECV


def check_actions(actions, single_space, batch):
    """One-time action validation (analog of joint-space contains)."""
    if isinstance(single_space, spaces.Discrete):
        ok = (actions.size == batch and np.all(actions >= 0)
            and np.all(actions < single_space.n))
    elif isinstance(single_space, spaces.MultiDiscrete):
        nvec = np.asarray(single_space.nvec)
        ok = (actions.shape == (batch, len(nvec))
            and np.all(actions >= 0) and np.all(actions < nvec))
    else:
        ok = actions.shape[:1] == (batch,)
    if not ok:
        raise APIUsageError('Actions do not match action space')


def nativize_actions(flat_actions, space):
    """Flat (B,) / (B, k) int actions -> the env's native actions."""
    if isinstance(space, spaces.Discrete):
        return flat_actions.reshape(flat_actions.shape[0])
    if isinstance(space, spaces.MultiDiscrete):
        return flat_actions.reshape(flat_actions.shape[0], len(space.nvec))
    raise NotImplementedError(
        f'nested action spaces are not ported yet, got {space}')


def make_env_ops(env, emulated):
    """Build the batched (reset_batch, step_batch) closures for an env
    (pufferlib_tpu/vector.py:146-194).

    reset_batch(draws)                -> (states, obs, dones)
    step_batch(states, done_prev, flat_actions, reset_draws)
        -> (states, done_next, obs, reward, done, trunc, infos)

    Used by both the Device vector backend and the fused trainer, so the
    step logic inside the trainer is the step API's. Draws come from
    env.sample_reset, or from the caller."""
    if env.num_agents != 1:
        raise NotImplementedError(
            'multi-agent envs are not ported yet (ROADMAP, queue 1)')
    if not isinstance(env.observation_space, spaces.Box):
        raise NotImplementedError(
            'structured observation spaces are not ported yet')

    def reset_batch(draws):
        states, obs = env.reset(draws)
        dones = torch.zeros(obs.shape[0], dtype=torch.bool,
            device=obs.device)
        return states, obs, dones

    def step_batch(states, done_prev, flat_actions, reset_draws):
        native = nativize_actions(flat_actions, env.action_space)
        step, done_next = autoreset_step(env, states, done_prev, native,
            reset_draws)
        return (step.state, done_next, step.obs, step.reward, step.done,
            step.truncated, step.info)

    return reset_batch, step_batch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_copy_into(full, part, lo):
    """full[lo:lo+len(part)] = part, leaf by leaf, in place."""
    if isinstance(full, dict):
        for k in full:
            _tree_copy_into(full[k], part[k], lo)
        return
    full[lo:lo + part.shape[0]].copy_(part)


class Device:
    """All env lanes as one batch of tensors on one device.

    num_envs lanes; optional batch_size < num_envs cycles contiguous lane
    groups round-robin. Results stay on the device as tensors."""

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, batch_size=None, seed=42, device='cuda', **kwargs):
        creator = env_creators[0] if isinstance(env_creators, (list, tuple)) \
            else env_creators
        args = (env_args[0] if env_args and isinstance(env_args[0],
            (list, tuple)) else env_args) or []
        kw = (env_kwargs[0] if isinstance(env_kwargs, (list, tuple))
            else env_kwargs) or {}
        self.env = creator(*args, **kw) if callable(creator) else creator
        self.device = resolve_device(device)

        if batch_size is None:
            batch_size = num_envs
        if num_envs % batch_size != 0:
            raise APIUsageError('num_envs must be divisible by batch_size')
        self.num_envs_total = num_envs
        self.batch_envs = batch_size
        self.num_groups = num_envs // batch_size

        env = self.env
        self.agents_per_env = env.num_agents
        self.num_agents = num_envs * env.num_agents
        self.batch_agents = batch_size * env.num_agents

        self.single_observation_space, self.obs_dtype = \
            emulation.emulate_observation_space(env.observation_space)
        self.single_action_space, self.atn_dtype = \
            emulation.emulate_action_space(env.action_space)
        self.emulated = namespace(
            observation_dtype=np.dtype(self.single_observation_space.dtype),
            emulated_observation_dtype=self.obs_dtype,
        )
        self.agent_ids = np.arange(self.num_agents)
        self.initialized = False
        self.flag = RESET
        self._reset_batch, self._step_batch = make_env_ops(
            self.env, self.emulated)

        self.generator = None
        self._state = None
        self._pending = None
        self._group = 0

    # ---- async protocol ----------------------------------------------
    def async_reset(self, seed=42, reset_draws=None):
        self.flag = RECV
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if reset_draws is None:
            reset_draws = self.env.sample_reset(self.num_envs_total,
                self.device, self.generator)
        states, obs, dones = self._reset_batch(
            torch.as_tensor(reset_draws, device=self.device))
        self._state = namespace(env=states, done=dones)

        agents = self.batch_agents
        zero_r = torch.zeros(agents, dtype=torch.float32, device=self.device)
        zero_b = torch.zeros(agents, dtype=torch.bool, device=self.device)
        self._pending = [
            (obs[g * agents:(g + 1) * agents], zero_r, zero_b, zero_b, {})
            for g in range(self.num_groups)]
        self._group = 0

    def send(self, actions, reset_draws=None):
        send_precheck(self, actions)
        actions = torch.as_tensor(actions, device=self.device)
        g = self._group
        B = self.batch_envs
        lo = g * B
        if reset_draws is None:
            reset_draws = self.env.sample_reset(B, self.device,
                self.generator)

        states = _tree_map(lambda x: x[lo:lo + B], self._state.env)
        done = self._state.done[lo:lo + B]
        (new_states, done_next, obs, rew, dn, tr, infos) = self._step_batch(
            states, done, actions,
            torch.as_tensor(reset_draws, device=self.device))

        if self.num_groups == 1:
            self._state.env = new_states
            self._state.done = done_next
        else:
            _tree_copy_into(self._state.env, new_states, lo)
            self._state.done[lo:lo + B] = done_next
        self._pending[g] = (obs, rew, dn, tr, infos)
        self._group = (g + 1) % self.num_groups

    def recv(self):
        recv_precheck(self)
        g = self._group
        obs, rew, dn, tr, infos = self._pending[g]
        agents = self.batch_agents
        ids = self.agent_ids[g * agents:(g + 1) * agents]
        mask = np.ones(agents, dtype=bool)
        return obs, rew, dn, tr, infos, ids, mask

    # ---- sync API ------------------------------------------------------
    def reset(self, seed=42, reset_draws=None):
        self.async_reset(seed, reset_draws)
        obs, _, _, _, infos, _, _ = self.recv()
        return obs, infos

    def step(self, actions, reset_draws=None):
        self.send(actions, reset_draws)
        obs, rew, dn, tr, infos, _, _ = self.recv()
        return obs, rew, dn, tr, infos

    def close(self):
        self._state = None

    @property
    def num_envs(self):
        return self.batch_agents


def make(env_creator, env_args=None, env_kwargs=None, backend=Device,
        num_envs=1, num_workers=None, batch_size=None, seed=42,
        device='cuda', **kwargs):
    """Vector engine factory (pufferlib_tpu/vector.py:499). Runs on
    `device`, CUDA unless the caller asks for the CPU. num_workers is
    accepted for API compatibility; lanes are batched tensors."""
    if num_envs < 1 or int(num_envs) != num_envs:
        raise APIUsageError('num_envs must be a positive integer')
    if batch_size is not None and num_envs % batch_size != 0:
        raise APIUsageError('num_envs must be divisible by batch_size')
    if backend is not Device:
        raise NotImplementedError(
            'only the Device backend is ported (ROADMAP, queue 1)')
    return Device(env_creator, env_args, env_kwargs, num_envs=num_envs,
        batch_size=batch_size, seed=seed, device=device, **kwargs)
