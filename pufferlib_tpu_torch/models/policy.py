"""CleanRL-style policy wrapper (pufferlib_tpu/models/policy.py:14-39).

In JAX the policy is (module, params) and params pass explicitly; here the
wrapper is an nn.Module that owns its module's parameters.
"""
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
