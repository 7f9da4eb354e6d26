"""MiniGrid binding (counterpart of pufferlib_tpu/environments/minigrid/
__init__.py; reference pufferlib/environments/minigrid): minigrid's
ImgObsWrapper keeps the 7 x 7 x 3 uint8 image of its Dict observation,
then EpisodeStats and GymnasiumPufferEnv. make needs minigrid, which is
not installed here: it raises. config.yaml's section trains Default
inside LSTMWrapper(128, 128), which on the card runs enc5's streamed
design (147 features).
"""
import functools


def env_creator(name='MiniGrid-Empty-8x8-v0'):
    return functools.partial(make, name)


def wrap(env):
    """EpisodeStats, then GymnasiumPufferEnv, over an env whose
    observation is the image (ImgObsWrapper's output)."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='MiniGrid-Empty-8x8-v0', render_mode=None):
    try:
        import minigrid  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'minigrid is not installed in this image') from e
    import gymnasium
    from minigrid.wrappers import ImgObsWrapper
    return wrap(ImgObsWrapper(gymnasium.make(name, render_mode=render_mode)))
