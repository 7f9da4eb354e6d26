"""Generalized Advantage Estimation, plain PyTorch.

Counterpart of pufferlib_tpu/ops/gae.py:
- compute_gae: the per-env formulation over (T, E) rollouts with a
  bootstrap value, what the trainer uses. It is also the plain version
  that the CUDA kernel (ops/cuda/gae.py) is held against.
- compute_gae_flat: the reference Cython kernel's semantics over a flat
  env-major array, with no bootstrap across segment bounds.

The expressions keep the JAX version's operation order, so that every
intermediate rounds as it does there.
"""
import torch


def compute_gae(rewards, values, dones, last_value, gamma, gae_lambda):
    """Per-env GAE with bootstrap.

    rewards/values/dones: (T, E) where row t holds the results of action
    a_t (reward r_t, done d_t) and v_t = V(s_t). last_value: (E,)
    V(s_T) bootstraps the final step. Returns advantages (T, E) float32.
    """
    rewards = rewards.float()
    values = values.float()
    nonterminal = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_value.float()[None]], dim=0)

    advantages = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = (rewards[t] + gamma * next_values[t] * nonterminal[t]
            - values[t])
        carry = delta + gamma * gae_lambda * nonterminal[t] * carry
        advantages[t] = carry
    return advantages


def compute_gae_flat(dones, values, rewards, gamma, gae_lambda):
    """The reference Cython GAE over a flat env-major, time-sorted batch:

        nextnonterminal = 1 - dones[t+1]
        delta = rewards[t+1] + gamma*values[t+1]*nextnonterminal - values[t]
        adv[t] = delta + gamma*lambda*nextnonterminal*adv[t+1]

    with adv[N-1] = 0 (no bootstrap across the batch end or segment
    bounds)."""
    dones = dones.float()
    values = values.float()
    rewards = rewards.float()

    nextnonterminal = 1.0 - dones[1:]
    delta = rewards[1:] + gamma * values[1:] * nextnonterminal - values[:-1]
    decay = gamma * gae_lambda * nextnonterminal

    advantages = torch.zeros_like(values)
    carry = torch.zeros((), dtype=torch.float32, device=values.device)
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + decay[t] * carry
        advantages[t] = carry
    return advantages
