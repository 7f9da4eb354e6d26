"""CleanRL-style policy wrappers (pufferlib_tpu/models/policy.py:14-75).

In JAX the policy is (module, params) and params pass explicitly; here the
wrapper is an nn.Module that owns its module's parameters.
"""
import torch
from torch import nn

from pufferlib_tpu_torch.models.distributions import sample_logits


def count_params(module):
    return sum(p.numel() for p in module.parameters())


class Policy(nn.Module):
    """Wrap a non-recurrent module: forward -> (action, logprob, entropy,
    value)."""
    lstm = None

    def __init__(self, module):
        super().__init__()
        self.module = module

    def get_value(self, x):
        _, value = self.module(x)
        return value

    def get_action_and_value(self, x, action=None, generator=None, u=None):
        logits, value = self.module(x)
        action, logprob, entropy = sample_logits(logits, action, generator,
            u)
        return action, logprob, entropy, value

    def forward(self, x, action=None, generator=None, u=None):
        return self.get_action_and_value(x, action, generator, u)


class RecurrentPolicy(nn.Module):
    """Wrap an LSTMWrapper: forward(x, state) -> (action, logprob,
    entropy, value, state) (pufferlib_tpu/models/policy.py:42-75)."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    @property
    def lstm(self):
        return self.module

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        return self.module.initial_state(batch_size, dtype, device)

    def get_value(self, x, state=None):
        _, value, _ = self.module(x, state)
        return value

    def get_action_and_value(self, x, state=None, action=None, generator=None,
            u=None, time_major=False):
        logits, value, state = self.module(x, state, time_major=time_major)
        action, logprob, entropy = sample_logits(logits, action, generator,
            u)
        return action, logprob, entropy, value, state

    def forward(self, x, state=None, action=None, generator=None, u=None,
            time_major=False):
        return self.get_action_and_value(x, state, action, generator, u,
            time_major)
