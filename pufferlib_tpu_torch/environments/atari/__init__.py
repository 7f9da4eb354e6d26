"""Atari binding with the SB3-style wrapper stack (counterpart of
pufferlib_tpu/environments/atari/__init__.py; reference
pufferlib/environments/atari/environment.py:17-59): NoopReset,
MaxAndSkip, EpisodicLife, FireReset, ClipReward, 84x84 grayscale,
framestack. Requires ale-py, which is not installed here: make raises.

Policy: NatureCNN + LSTM (reference atari/torch.py), the port's
Convolutional, resolved lazily (PEP 562) so that envpool workers, which
import this package for its wrappers, do not import torch.
"""
import functools


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.models import Convolutional
        return Convolutional
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='BreakoutNoFrameskip-v4'):
    return functools.partial(make, name)


def make(name='BreakoutNoFrameskip-v4', framestack=1, render_mode=None):
    import gymnasium
    try:
        import ale_py  # noqa: F401
        gymnasium.register_envs(ale_py)
    except ImportError as e:
        raise ImportError('Atari requires ale-py, which is not installed') \
            from e
    from gymnasium.wrappers import (
        AtariPreprocessing, FrameStackObservation)
    from pufferlib_tpu_torch.environments.atari.wrappers import (
        ClipRewardEnv, EpisodicLifeEnv, FireResetEnv, needs_fire_reset)
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats

    env = gymnasium.make(name, render_mode=render_mode)
    # AtariPreprocessing supplies noop reset, frame skip w/ max-pool,
    # 84x84 grayscale; EpisodicLife/FireReset/sign-ClipReward are ours
    # (reference SB3 stack, atari/environment.py:17-41)
    env = AtariPreprocessing(env, noop_max=30, frame_skip=4,
        screen_size=84, terminal_on_life_loss=False, grayscale_obs=True)
    env = EpisodicLifeEnv(env)
    if needs_fire_reset(env):
        env = FireResetEnv(env)
    env = ClipRewardEnv(env)
    if framestack > 1:
        env = FrameStackObservation(env, framestack)
    env = EpisodeStats(env)
    return GymnasiumPufferEnv(env=env)
