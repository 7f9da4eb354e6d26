"""Batched environment protocol.

Counterpart of pufferlib_tpu/environment.py:22-159. The JAX envs are pure
functions of one lane, vmapped over lanes. Here an env is written once
over a batch of lanes: every state leaf, observation, reward and flag is
a tensor whose leading dimension is the lane.

    draws               = env.sample_reset(n, device, generator)
    state, obs          = env.reset(draws)
    Step(...)           = env.step(state, action)

The reset's randomness is a tensor of per-lane draws, so a caller (a
parity test) can inject the draws another implementation made. Auto-reset
(`autoreset_step`) keeps the JAX package's semantics: lanes done at the
previous step reset instead of stepping, and report reward=0, done=False,
truncated=False and a zeroed info.
"""
from typing import Any, NamedTuple

import torch


class Step(NamedTuple):
    """Result of one batched env step; every field is lane-leading."""
    state: Any
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    info: dict


class PufferEnv:
    """Base batched env. Subclasses set observation_space/action_space
    (pufferlib_tpu_torch.spaces) and implement sample_reset/reset/step.
    Single-agent only in this slice: reward/done/truncated are (N,)."""
    observation_space = None
    action_space = None
    num_agents = 1

    def sample_reset(self, num_lanes, device, generator=None):
        """Per-lane random draws that `reset` consumes."""
        raise NotImplementedError

    def reset(self, draws):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError


def _lane_where(pred, a, b):
    """torch.where with a (N,) predicate broadcast over trailing dims."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


def select_tree(pred, on_true, on_false):
    """Lane-wise select over nested dicts of lane-leading tensors."""
    if isinstance(on_true, dict):
        return {k: select_tree(pred, on_true[k], on_false[k])
            for k in on_true}
    return _lane_where(pred, on_true, on_false)


def autoreset_step(env, state, done_prev, action, reset_draws):
    """Step every lane, with the JAX package's auto-reset semantics
    (pufferlib_tpu/environment.py:79-109): lanes whose previous step
    ended are reset from `reset_draws` instead, returning the reset obs
    with reward, done, truncated and info zeroed.

    Both branches are computed for every lane and selected, as the JAX
    version does: no host sync, no data-dependent shapes.
    Returns (Step, done_next) where done_next feeds the next call."""
    reset_state, reset_obs = env.reset(reset_draws)
    stepped = env.step(state, action)

    new_state = select_tree(done_prev, reset_state, stepped.state)
    obs = _lane_where(done_prev, reset_obs, stepped.obs)
    reward = stepped.reward.masked_fill(done_prev, 0)
    done = stepped.done & ~done_prev
    truncated = stepped.truncated & ~done_prev
    info = {k: v.masked_fill(done_prev, 0) for k, v in stepped.info.items()}
    step = Step(new_state, obs, reward, done, truncated, info)
    return step, done | truncated


class EpisodeStats(PufferEnv):
    """Wrapper accumulating episode return/length, emitted only at episode
    end (pufferlib_tpu/environment.py:112-159). Adds the info fields
    episode_return, episode_length and `_valid`, the flag of lanes whose
    episode ended at this step."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.num_agents = env.num_agents

    def sample_reset(self, num_lanes, device, generator=None):
        return self.env.sample_reset(num_lanes, device, generator)

    def reset(self, draws):
        state, obs = self.env.reset(draws)
        n = obs.shape[0]
        wrapped = dict(
            env=state,
            episode_return=torch.zeros(n, dtype=torch.float32,
                device=obs.device),
            episode_length=torch.zeros(n, dtype=torch.int32,
                device=obs.device),
        )
        return wrapped, obs

    def step(self, state, action):
        s = self.env.step(state['env'], action)
        ep_ret = state['episode_return'] + s.reward
        ep_len = state['episode_length'] + 1
        ended = s.done | s.truncated
        info = dict(s.info)
        info['episode_return'] = ep_ret.masked_fill(~ended, 0)
        info['episode_length'] = ep_len.masked_fill(~ended, 0)
        info['_valid'] = ended
        new_state = dict(env=s.state, episode_return=ep_ret,
            episode_length=ep_len)
        return Step(new_state, s.obs, s.reward, s.done, s.truncated, info)
