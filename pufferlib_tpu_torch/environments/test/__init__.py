"""Mock env suite (pufferlib_tpu/environments/test/). Lazy re-exports
(PEP 562): the batched mock envs pull in torch, but envpool worker
processes unpickle the torch-free host fixtures (host_fixtures) from this
package and must not pay the torch import."""

__all__ = ['MOCK_OBSERVATION_SPACES', 'MOCK_ACTION_SPACES', 'MockEnv',
    'env_creator', 'sample_space']


def __getattr__(name):
    if name in __all__:
        from pufferlib_tpu_torch.environments.test import environment
        return getattr(environment, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
