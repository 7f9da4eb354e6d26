from pufferlib_tpu_torch.config.cli import load_config, make_policy

__all__ = ['load_config', 'make_policy']
