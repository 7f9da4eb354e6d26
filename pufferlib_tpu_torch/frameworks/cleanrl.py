"""CleanRL bridge: the reference import path of the policy wrappers and
the sampling functions (pufferlib_tpu/frameworks/cleanrl.py:8-13;
reference pufferlib/frameworks/cleanrl.py), so that
`from pufferlib_tpu_torch.frameworks import cleanrl` works the same way.
The implementations live in pufferlib_tpu_torch.models.
"""
from pufferlib_tpu_torch.models.distributions import (  # noqa: F401
    entropy, log_prob, sample_logits,
)
from pufferlib_tpu_torch.models.policy import (  # noqa: F401
    Policy, RecurrentPolicy,
)
