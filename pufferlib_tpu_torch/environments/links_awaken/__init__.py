"""Link's Awakening binding (counterpart of
pufferlib_tpu/environments/links_awaken/__init__.py; reference
pufferlib/environments/links_awaken/environment.py, which targets a
pre-1.0 emulation API; this is the working 1.0-style equivalent: resize
to 72x80 with gymnasium's ResizeObservation and bridge through
GymnasiumPufferEnv). make needs links_awaken, which is not installed
here: it raises; wrap needs gymnasium.

Policy: channels-last NatureCNN (the port's Convolutional), same family
as pokemon_red; its import of the models waits for the call, so that
envpool workers, which import this package for wrap, do not import
torch. Weights carry from the JAX module through
convert.convolutional_layers.
"""
import functools


def Policy(obs_shape, action_space, hidden_size=512, framestack=4,
        flat_size=None, generator=None, **kw):
    """The JAX module infers the input channels and fc's width from the
    frames; here they come from obs_shape (H, W, C) where it is given
    (C = 3 for the binding's RGB frames, whatever framestack says), else
    framestack and 64 * 5 * 6, that of 72 x 80 frames."""
    from pufferlib_tpu_torch.environments.pokemon_red import conv_flat_size
    from pufferlib_tpu_torch.models import Convolutional
    if obs_shape is not None:
        framestack = obs_shape[-1]
    if flat_size is None:
        flat_size = 64 * 5 * 6 if obs_shape is None else \
            conv_flat_size(obs_shape)
    return Convolutional(action_space=action_space, framestack=framestack,
        flat_size=flat_size, obs_shape=obs_shape, hidden_size=hidden_size,
        channels_last=True, generator=generator, **kw)


def env_creator(name='links_awaken'):
    return functools.partial(make, name)


def wrap(env):
    """ResizeObservation to 72 x 80, EpisodeStats, GymnasiumPufferEnv."""
    import gymnasium
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    env = gymnasium.wrappers.ResizeObservation(env, shape=(72, 80))
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='links_awaken', headless=True, state_path=None,
        render_mode=None):
    try:
        from links_awaken import LinksAwakenV1
    except ImportError as e:
        raise ImportError('links_awaken env package not installed') from e
    return wrap(LinksAwakenV1(headless=headless, state_path=state_path))
