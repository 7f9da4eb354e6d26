"""Mock env suite (pufferlib_tpu/environments/test/)."""
from pufferlib_tpu_torch.environments.test.environment import (
    MOCK_ACTION_SPACES, MOCK_OBSERVATION_SPACES, MockEnv, env_creator,
    sample_space)

__all__ = ['MOCK_OBSERVATION_SPACES', 'MOCK_ACTION_SPACES', 'MockEnv',
    'env_creator', 'sample_space']
