"""Pokemon Red binding (counterpart of
pufferlib_tpu/environments/pokemon_red/__init__.py; reference
pufferlib/environments/pokemon_red/environment.py:15-31). make needs
pokegym, which is not installed here: it raises.

Policy: NatureCNN channels-last (reference pokemon_red/torch.py:13-26),
the port's Convolutional; fc's input width is worked out from obs_shape
where it is given (the JAX module infers it), else 64 * 5 * 6, that of
pokegym's 72 x 80 screens.
"""
import functools

Recurrent = dict(input_size=512, hidden_size=512, num_layers=1)


def conv_flat_size(obs_shape, framestack=4):
    """Convolutional's flattened feature width for channels-last frames
    (H, W, framestack): 8x8/4, 4x4/2, 3x3/1, VALID, 64 channels."""
    height, width = obs_shape[:2]
    for k, s in ((8, 4), (4, 2), (3, 1)):
        height, width = (height - k) // s + 1, (width - k) // s + 1
    return 64 * height * width


def Policy(obs_shape, action_space, hidden_size=512, framestack=4,
        flat_size=None, generator=None, **kw):
    from pufferlib_tpu_torch.models import Convolutional
    if flat_size is None:
        flat_size = 64 * 5 * 6 if obs_shape is None else \
            conv_flat_size(obs_shape, framestack)
    return Convolutional(action_space=action_space, framestack=framestack,
        flat_size=flat_size, obs_shape=obs_shape, hidden_size=hidden_size,
        channels_last=True, generator=generator, **kw)


def env_creator(name='pokemon_red'):
    return functools.partial(make, name)


def wrap(env):
    """EpisodeStats, then GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='pokemon_red', headless=True, state_path=None,
        render_mode=None):
    try:
        from pokegym import Environment
    except ImportError as e:
        raise ImportError('pokegym is not installed in this image') from e
    return wrap(Environment(headless=headless, state_path=state_path))
