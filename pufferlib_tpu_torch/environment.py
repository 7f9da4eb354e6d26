"""Batched environment protocol.

Counterpart of pufferlib_tpu/environment.py:22-159. The JAX envs are pure
functions of one lane, vmapped over lanes. Here an env is written once
over a batch of lanes: every state leaf, observation, reward and flag is
a tensor whose leading dimension is the lane.

    reset_draws         = env.sample_reset(n, device, generator)
    state, obs          = env.reset(reset_draws)
    step_draws          = env.sample_step(n, device, generator)  # or None
    Step(...)           = env.step(state, action, step_draws)

The randomness is tensors of per-lane draws, so a caller (a parity test)
can inject the draws another implementation made. An env with no reset
randomness draws an empty (n, 0) tensor; one with no step randomness
draws None. A multi-agent env (num_agents > 1) gives obs (N, A, ...) and
reward, done and truncated (N, A).

Auto-reset (`autoreset_step`) keeps the JAX package's semantics: a lane
whose agents were all done at the previous step resets instead of
stepping; every agent done at the previous step reports reward=0,
done=False, truncated=False, and a reset lane's info is zeroed.
"""
from typing import Any, NamedTuple

import torch


class Step(NamedTuple):
    """Result of one batched env step; every field is lane-leading."""
    state: Any
    obs: Any
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    info: dict


class PufferEnv:
    """Base batched env. Subclasses set observation_space/action_space
    (pufferlib_tpu_torch.spaces) and implement reset/step, and
    sample_reset / sample_step where they draw random numbers."""
    observation_space = None
    action_space = None
    num_agents = 1

    def sample_reset(self, num_lanes, device, generator=None):
        """Per-lane random draws that `reset` consumes; (n, 0) for an env
        whose reset draws nothing."""
        return torch.empty((num_lanes, 0), device=device)

    def sample_step(self, num_lanes, device, generator=None):
        """Per-lane random draws that `step` consumes; None for an env
        whose step draws nothing."""
        return None

    def reset(self, draws):
        raise NotImplementedError

    def step(self, state, action, draws=None):
        raise NotImplementedError

    def render(self, state):
        """Optional ANSI render of one lane's state (host side)."""
        raise NotImplementedError


def _lane_where(pred, a, b):
    """torch.where with a (N,) predicate broadcast over trailing dims."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts and tuples of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree, sort_keys=False, is_leaf=None):
    """Depth-first leaves of nested dicts, tuples and lists; with
    sort_keys each dict's keys in sorted order, the order of
    jax.tree.leaves. A node for which is_leaf(node) holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        return [leaf for k in keys
            for leaf in tree_leaves(tree[k], sort_keys, is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree
            for leaf in tree_leaves(v, sort_keys, is_leaf)]
    return [tree]


def select_tree(pred, on_true, on_false):
    """Lane-wise select over nested dicts of lane-leading tensors."""
    return tree_map(lambda a, b: _lane_where(pred, a, b), on_true, on_false)


def lane_done(done):
    """(N,) flag of lanes whose agents are all done; done is (N,) or, for
    a multi-agent env, (N, A)."""
    return done if done.dim() == 1 else done.all(dim=1)


def autoreset_step(env, state, done_prev, action, reset_draws,
        step_draws=None):
    """Step every lane, with the JAX package's auto-reset semantics
    (pufferlib_tpu/environment.py:79-109): lanes whose agents all ended
    at the previous step are reset from `reset_draws` instead, returning
    the reset obs and a zeroed info; reward, done and truncated are
    zeroed for every agent that ended at the previous step.

    Both branches are computed for every lane and selected, as the JAX
    version does: no host sync, no data-dependent shapes.
    Returns (Step, done_next) where done_next feeds the next call."""
    reset_state, reset_obs = env.reset(reset_draws)
    stepped = env.step(state, action, step_draws)
    reset_lane = lane_done(done_prev)

    new_state = select_tree(reset_lane, reset_state, stepped.state)
    obs = select_tree(reset_lane, reset_obs, stepped.obs)
    reward = stepped.reward.masked_fill(done_prev, 0)
    done = stepped.done & ~done_prev
    truncated = stepped.truncated & ~done_prev
    info = tree_map(lambda v: _lane_where(reset_lane, torch.zeros_like(v), v),
        stepped.info)
    step = Step(new_state, obs, reward, done, truncated, info)
    return step, done | truncated


class EpisodeStats(PufferEnv):
    """Wrapper accumulating episode return/length, emitted only at episode
    end (pufferlib_tpu/environment.py:112-159). Adds the per-lane info
    fields episode_return (the sum over agents), episode_length and
    `_valid`, the flag of lanes whose episode ended at this step: all
    agents done, or all truncated. Forwards the env's `agent_mask`."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.num_agents = env.num_agents
        if hasattr(env, 'agent_mask'):
            self.agent_mask = lambda state: env.agent_mask(state['env'])

    def sample_reset(self, num_lanes, device, generator=None):
        return self.env.sample_reset(num_lanes, device, generator)

    def sample_step(self, num_lanes, device, generator=None):
        return self.env.sample_step(num_lanes, device, generator)

    def reset(self, draws):
        state, obs = self.env.reset(draws)
        n = draws.shape[0]
        wrapped = dict(
            env=state,
            episode_return=torch.zeros(n, dtype=torch.float32,
                device=draws.device),
            episode_length=torch.zeros(n, dtype=torch.int32,
                device=draws.device),
        )
        return wrapped, obs

    def step(self, state, action, draws=None):
        s = self.env.step(state['env'], action, draws)
        reward = s.reward if s.reward.dim() == 1 else s.reward.sum(dim=1)
        ep_ret = state['episode_return'] + reward
        ep_len = state['episode_length'] + 1
        ended = lane_done(s.done) | lane_done(s.truncated)
        info = dict(s.info)
        info['episode_return'] = ep_ret.masked_fill(~ended, 0)
        info['episode_length'] = ep_len.masked_fill(~ended, 0)
        info['_valid'] = ended
        new_state = dict(env=s.state, episode_return=ep_ret,
            episode_length=ep_len)
        return Step(new_state, s.obs, s.reward, s.done, s.truncated, info)

    def render(self, state):
        return self.env.render(state['env'])
