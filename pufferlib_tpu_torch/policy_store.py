"""Directory of checkpointed policies for self-play opponents.

Counterpart of pufferlib_tpu/policy_store.py: a policy is the
`model_{epoch:06d}.pt` file that training/checkpoint.py writes, the
policy's state_dict, read with torch.load(weights_only=True). A
reference PufferLib `.pt` (a pickled module, or another layout) is not
such a state_dict and is refused: reading one needs the reference's
layout map (ROADMAP queue 1 item 6, frameworks), which the port has not
yet.
"""
import os

import torch

from pufferlib_tpu_torch.exceptions import APIUsageError


class PolicyStore:
    def __init__(self, path):
        self.path = path

    def policy_names(self):
        return sorted(file[:-len('.pt')] for file in os.listdir(self.path)
            if file.startswith('model_') and file.endswith('.pt'))

    def get_policy(self, name):
        """The state_dict saved as `name`.pt, its tensors on the CPU."""
        path = os.path.join(self.path, name + '.pt')
        refusal = (f'{path} is not a state_dict of pufferlib_tpu_torch '
            '(model_*.pt as training/checkpoint.py writes it); a reference '
            'PufferLib .pt needs its layout map, ROADMAP queue 1 item 6 '
            '(frameworks), which the port has not yet')
        try:
            state_dict = torch.load(path, map_location='cpu',
                weights_only=True)
        except FileNotFoundError:
            raise
        except Exception as e:
            # weights_only refuses a pickled module or any other object
            raise APIUsageError(f'{refusal}: {e}') from e
        if not (isinstance(state_dict, dict) and state_dict and all(
                isinstance(k, str) and torch.is_tensor(v)
                for k, v in state_dict.items())):
            raise APIUsageError(refusal)
        return state_dict
