"""Stable-Baselines3 bridge: SB3 vec envs over puffer env creators, and
PPO on them (counterpart of pufferlib_tpu/frameworks/sb3.py; shared by
demo_torch.py --backend sb3 and sb3_demo_torch.py; reference
demo.py:203-218 / sb3_demo.py). SB3 isinstance-checks the gymnasium
contract, so each env is wrapped in host_env.GymnasiumAdapter.
stable_baselines3 is imported inside train_sb3: it is not installed here.
"""


def make_sb3_env_fn(creator, env_kwargs=None):
    """Creator closure producing gymnasium-conformant envs for SB3."""
    from pufferlib_tpu_torch.host_env import (
        GymnasiumAdapter, GymnasiumPufferEnv, PettingZooPufferEnv)

    kwargs = dict(env_kwargs or {})

    def make():
        env = creator(**kwargs)
        if isinstance(env, PettingZooPufferEnv):
            raise TypeError(
                'SB3 is single-agent; use the native trainer for '
                'pettingzoo envs')
        if not isinstance(env, GymnasiumPufferEnv):
            raise TypeError(
                'the sb3 backend supports host (gymnasium) envs; '
                f'{type(env).__name__} is a device-native env — use the '
                'native trainer (--backend native)')
        return GymnasiumAdapter(env)

    return make


def train_sb3(creator, env_kwargs=None, n_envs=4, seed=0,
        total_timesteps=10_000, update_epochs=4, gamma=0.99,
        policy='MlpPolicy', verbose=1):
    """Train SB3 PPO on a puffer env creator; returns the model."""
    try:
        from stable_baselines3 import PPO
        from stable_baselines3.common.env_util import make_vec_env
        from stable_baselines3.common.vec_env import DummyVecEnv
    except ImportError as e:
        raise ImportError(
            'stable_baselines3 is not installed in this image') from e

    envs = make_vec_env(make_sb3_env_fn(creator, env_kwargs),
        n_envs=n_envs, seed=seed, vec_env_cls=DummyVecEnv)
    model = PPO(policy, envs, verbose=verbose, n_epochs=update_epochs,
        gamma=gamma)
    model.learn(total_timesteps=total_timesteps)
    return model
