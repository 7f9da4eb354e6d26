"""Vectorization: many env lanes as batched tensors on one device.

Counterpart of pufferlib_tpu/vector.py. Two backends keep the JAX
package's sync (reset/step) and async (async_reset/send/recv) protocol and
its flag state machine:

- Device: all lanes as one batch of tensors (the JAX package's vmap).
  Optional batch_size < num_envs cycles contiguous lane groups, the
  envpool's worker-block mode.
- Serial: a loop over single-lane batches of the same step logic, which
  exists to hold Device bit-exact.

Observations leave the engine flattened per the emulation layer (a Box
passes through with its shape; a nested space becomes (B, numel) of its
flat dtype); actions arrive flat and are nativized on the device. A
multi-agent env's rows are agent-major within a lane: lane i's agents are
rows i*A .. i*A+A-1. Randomness comes from one torch.Generator on the
device, seeded by `async_reset(seed)`, in a fixed order each step: the
reset draws, then the step draws. Both can be injected per call
(`send(actions, reset_draws=..., step_draws=...)`) so that a test can
replay another implementation's draws.
"""
import numpy as np
import torch

from pufferlib_tpu_torch import emulation, resolve_device, spaces
from pufferlib_tpu_torch.environment import autoreset_step, tree_map
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


def make_seeds(seed, num_envs):
    """Per-lane seeds: seed + i for an int, else the list as given."""
    if isinstance(seed, int):
        return [seed + i for i in range(num_envs)]
    if len(seed) != num_envs:
        raise APIUsageError('Seed list length must equal num_envs')
    return list(seed)


def nativize_actions(flat_actions, space):
    """Flat (B,) / (B, k) int actions -> the env's native actions.

    Inverse of emulation.emulate_action_space: a nested space with
    Discrete leaves takes one column per leaf, depth-first."""
    if isinstance(space, spaces.Discrete):
        return flat_actions.reshape(flat_actions.shape[0])
    if isinstance(space, spaces.MultiDiscrete):
        return flat_actions.reshape(flat_actions.shape[0], len(space.nvec))

    flat_actions = flat_actions.reshape(flat_actions.shape[0], -1)
    col = [0]

    def build(sp):
        if isinstance(sp, spaces.Discrete):
            col[0] += 1
            return flat_actions[:, col[0] - 1]
        if isinstance(sp, spaces.Dict):
            return {k: build(v) for k, v in sp.items()}
        if isinstance(sp, spaces.Tuple):
            return tuple(build(s) for s in sp)
        raise APIUsageError(
            f'Nested action spaces must have Discrete leaves, got {sp}')

    return build(space)


def obs_flattener(space, emulated):
    """flatten(obs): a structured obs tree of `space` (leaves (B, ...))
    -> flat (B, numel) per the emulation dtype spec, each leaf cast to its
    dtype and written at its offset (as bytes for a uint8 flat space). The
    spec and each leaf's path in the tree are worked out once, here. A Box
    passes through with its native shape."""
    if isinstance(space, spaces.Box):
        return lambda obs: obs

    def paths(sp, sp_spec, path):
        if isinstance(sp, spaces.Dict):
            return [p for k, v in sp.items()
                for p in paths(v, sp_spec[k], path + (k,))]
        if isinstance(sp, spaces.Tuple):
            return [p for i, v in enumerate(sp)
                for p in paths(v, sp_spec[f'f{i}'], path + (i,))]
        return [(path, sp_spec)]

    leaf_paths = paths(space, emulation.nativize_dtype(emulated), ())
    specs = [spec for _, spec in leaf_paths]
    sample_dtype = np.dtype(emulated.observation_dtype)
    numel = (np.dtype(emulated.emulated_observation_dtype).itemsize
        // sample_dtype.itemsize)

    def flatten(obs):
        leaves = []
        for path, _ in leaf_paths:
            leaf = obs
            for k in path:
                leaf = leaf[k]
            leaves.append(leaf)
        return emulation.write_leaves(leaves, specs, sample_dtype, numel)
    return flatten


def flatten_obs_batch(obs, space, emulated):
    """Structured obs tree (leaves (B, ...)) -> flat (B, numel): one call
    of obs_flattener(space, emulated)."""
    return obs_flattener(space, emulated)(obs)


def make_env_ops(env, emulated):
    """The batched (reset_batch, step_batch) closures of an env
    (pufferlib_tpu/vector.py:146-194).

    reset_batch(reset_draws)          -> (states, flat_obs, dones)
    step_batch(states, done_prev, flat_actions, reset_draws,
            step_draws=None)
        -> (states, done_next, flat_obs, reward, done, trunc, infos)

    flat obs, reward, done and trunc are agent-major (lanes*agents, ...);
    dones are (lanes,) or, multi-agent, (lanes, agents); info leaves are
    flattened the same way, so a per-lane leaf stays (lanes,). Used by
    the vector backends and the fused trainer alike, so the step logic
    inside the trainer is the step API's. Draws come from
    env.sample_reset / env.sample_step, or from the caller."""
    A = env.num_agents

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:])) if A > 1 else x

    flatten_native = obs_flattener(env.observation_space, emulated)

    def flatten(obs):
        return flatten_native(tree_map(flat, obs) if A > 1 else obs)

    def reset_batch(reset_draws):
        states, obs = env.reset(reset_draws)
        n = reset_draws.shape[0]
        dones = torch.zeros((n,) if A == 1 else (n, A), dtype=torch.bool,
            device=reset_draws.device)
        return states, flatten(obs), dones

    def step_batch(states, done_prev, flat_actions, reset_draws,
            step_draws=None):
        n = done_prev.shape[0]
        native = nativize_actions(flat_actions.reshape(n * A, -1),
            env.action_space)
        if A > 1:
            native = tree_map(
                lambda a: a.reshape((n, A) + tuple(a.shape[1:])), native)
        step, done_next = autoreset_step(env, states, done_prev, native,
            reset_draws, step_draws)
        return (step.state, done_next, flatten(step.obs), flat(step.reward),
            flat(step.done), flat(step.truncated), tree_map(flat, step.info))

    return reset_batch, step_batch


def make_mask_fn(env):
    """Batched agent-validity mask (pufferlib_tpu/vector.py:197-212): an
    env with a variable count of live agents defines
    `agent_mask(states) -> (lanes, agents) bool`; the rows of dead agents
    are left out of the PPO loss. Returns mask(states) -> (lanes*agents,)
    float32, agent-major, or None for a fixed-agent env (no cost on the
    hot path)."""
    if not hasattr(env, 'agent_mask'):
        return None

    def mask_batch(states):
        return env.agent_mask(states).reshape(-1).float()
    return mask_batch


class _Vector:
    """What both backends share: the env, its emulated spaces, the device,
    the flag state machine and the sync API over the async one."""

    def __init__(self, env_creators, env_args, env_kwargs, num_envs,
            batch_size, device):
        creator = env_creators[0] if isinstance(env_creators, (list, tuple)) \
            else env_creators
        args = (env_args[0] if env_args and isinstance(env_args[0],
            (list, tuple)) else env_args) or []
        kw = (env_kwargs[0] if isinstance(env_kwargs, (list, tuple))
            else env_kwargs) or {}
        self.env = creator(*args, **kw) if callable(creator) else creator
        self.driver_env = self
        self.device = resolve_device(device)

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

    def _seed(self, seed):
        """A fresh generator on the device, seeded by the first lane's
        seed: every lane draws from this one stream."""
        seeds = make_seeds(seed, self.num_envs_total)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seeds[0])

    def _draws(self, n, reset_draws, step_draws):
        """This step's (reset draws, step draws) for n lanes: the
        caller's, else the generator's, reset first."""
        if reset_draws is None:
            reset_draws = self.env.sample_reset(n, self.device,
                self.generator)
        if step_draws is None:
            step_draws = self.env.sample_step(n, self.device,
                self.generator)
        reset_draws = torch.as_tensor(reset_draws, device=self.device)
        if step_draws is not None:
            step_draws = torch.as_tensor(step_draws, device=self.device)
        return reset_draws, step_draws

    def _zero_pending(self, obs):
        agents = self.batch_agents
        zero_r = torch.zeros(agents, dtype=torch.float32, device=self.device)
        zero_b = torch.zeros(agents, dtype=torch.bool, device=self.device)
        return [(obs[g * agents:(g + 1) * agents], zero_r, zero_b, zero_b, {})
            for g in range(self.num_groups)]

    def reset(self, seed=42, reset_draws=None):
        self.async_reset(seed, reset_draws)
        obs, _, _, _, infos, _, _ = self.recv()
        return obs, infos

    def step(self, actions, reset_draws=None, step_draws=None):
        self.send(actions, reset_draws, step_draws)
        obs, rew, dn, tr, infos, _, _ = self.recv()
        return obs, rew, dn, tr, infos

    def close(self):
        self._state = None

    def nativize(self, flat_obs_batch):
        """Flat obs batch -> structured tree (for policies)."""
        return emulation.nativize_tensor(flat_obs_batch,
            emulation.nativize_dtype(self.emulated))

    @property
    def num_envs(self):
        return self.batch_agents


class Device(_Vector):
    """All env lanes as one batch of tensors on one device.

    num_envs lanes; optional batch_size < num_envs cycles contiguous lane
    groups round-robin. Results stay on the device as tensors."""

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, batch_size=None, seed=42, device='cuda', **kwargs):
        super().__init__(env_creators, env_args, env_kwargs, num_envs,
            num_envs if batch_size is None else batch_size, device)
        self._group = 0

    def async_reset(self, seed=42, reset_draws=None):
        self.flag = RECV
        self._seed(seed)
        if reset_draws is None:
            reset_draws = self.env.sample_reset(self.num_envs_total,
                self.device, self.generator)
        states, obs, dones = self._reset_batch(
            torch.as_tensor(reset_draws, device=self.device))
        self._state = namespace(env=states, done=dones)
        self._pending = self._zero_pending(obs)
        self._group = 0

    def send(self, actions, reset_draws=None, step_draws=None):
        send_precheck(self, actions)
        actions = torch.as_tensor(actions, device=self.device)
        g = self._group
        B = self.batch_envs
        lo = g * B
        reset_draws, step_draws = self._draws(B, reset_draws, step_draws)

        states = tree_map(lambda x: x[lo:lo + B], self._state.env)
        done = self._state.done[lo:lo + B]
        (new_states, done_next, obs, rew, dn, tr, infos) = self._step_batch(
            states, done, actions, reset_draws, step_draws)

        if self.num_groups == 1:
            self._state.env = new_states
            self._state.done = done_next
        else:
            tree_map(lambda full, part: full[lo:lo + B].copy_(part),
                self._state.env, new_states)
            self._state.done[lo:lo + B] = done_next
        self._pending[g] = (obs, rew, dn, tr, infos)
        self._group = (g + 1) % self.num_groups

    def recv(self):
        recv_precheck(self)
        g = self._group
        obs, rew, dn, tr, infos = self._pending[g]
        agents = self.batch_agents
        ids = self.agent_ids[g * agents:(g + 1) * agents]
        if hasattr(self.env, 'agent_mask'):
            B = self.batch_envs
            states = tree_map(lambda x: x[g * B:(g + 1) * B],
                self._state.env)
            mask = self.env.agent_mask(states).reshape(-1).cpu().numpy()
        else:
            mask = np.ones(agents, dtype=bool)
        return obs, rew, dn, tr, infos, ids, mask


class Serial(_Vector):
    """A loop over single-lane batches of the same step logic as Device
    (pufferlib_tpu/vector.py:374-497). Exists to hold Device bit-exact:
    the same draws give the same results, lane by lane; sampled draws
    come from the generator in Device's order, for all lanes at once."""

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, seed=42, device='cuda', **kwargs):
        super().__init__(env_creators, env_args, env_kwargs, num_envs,
            num_envs, device)

    def async_reset(self, seed=42, reset_draws=None):
        self.flag = RECV
        self._seed(seed)
        if reset_draws is None:
            reset_draws = self.env.sample_reset(self.num_envs_total,
                self.device, self.generator)
        reset_draws = torch.as_tensor(reset_draws, device=self.device)
        self._states, self._done, obs = [], [], []
        for i in range(self.num_envs_total):
            state, ob, done = self._reset_batch(reset_draws[i:i + 1])
            self._states.append(state)
            self._done.append(done)
            obs.append(ob)
        self._pending = self._zero_pending(torch.cat(obs))[0]

    def send(self, actions, reset_draws=None, step_draws=None):
        send_precheck(self, actions)
        actions = torch.as_tensor(actions, device=self.device)
        A = self.agents_per_env
        reset_draws, step_draws = self._draws(self.num_envs_total,
            reset_draws, step_draws)
        results = []
        for i in range(self.num_envs_total):
            out = self._step_batch(self._states[i], self._done[i],
                actions[i * A:(i + 1) * A], reset_draws[i:i + 1],
                None if step_draws is None else step_draws[i:i + 1])
            self._states[i], self._done[i] = out[0], out[1]
            results.append(out[2:])
        obs, rew, dn, tr, infos = (tree_map(lambda *x: torch.cat(x), *parts)
            for parts in zip(*results))
        self._pending = (obs, rew, dn, tr, infos)

    def recv(self):
        recv_precheck(self)
        obs, rew, dn, tr, infos = self._pending
        if hasattr(self.env, 'agent_mask'):
            mask = torch.cat([self.env.agent_mask(s).reshape(-1)
                for s in self._states]).cpu().numpy()
        else:
            mask = np.ones(self.num_agents, dtype=bool)
        return obs, rew, dn, tr, infos, self.agent_ids, mask


def make(env_creator, env_args=None, env_kwargs=None, backend=Device,
        num_envs=1, num_workers=None, batch_size=None, seed=42,
        device='cuda', **kwargs):
    """Vector engine factory (pufferlib_tpu/vector.py:499). Runs on
    `device`, CUDA unless the caller asks for the CPU. num_workers is
    accepted for API compatibility; lanes are batched tensors. Any other
    backend class is built as the reference builds it, with num_envs,
    batch_size, seed and device."""
    if num_envs < 1 or int(num_envs) != num_envs:
        raise APIUsageError('num_envs must be a positive integer')
    if batch_size is not None and num_envs % batch_size != 0:
        raise APIUsageError('num_envs must be divisible by batch_size')
    if backend is Serial:
        if batch_size is not None and batch_size != num_envs:
            raise APIUsageError(
                'Serial steps all envs together; batch_size < num_envs '
                '(async env-pool mode) requires the Device backend')
        return Serial(env_creator, env_args, env_kwargs, num_envs=num_envs,
            seed=seed, device=device, **kwargs)
    return backend(env_creator, env_args, env_kwargs, num_envs=num_envs,
        batch_size=batch_size, seed=seed, device=device, **kwargs)
