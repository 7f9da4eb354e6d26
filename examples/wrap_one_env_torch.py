"""Wrap any gymnasium env in one line (examples/wrap_one_env.py on
pufferlib_tpu_torch; the reference's puffer_ppo_minihack.py:93 UX bar:
`env = GymnasiumPufferEnv(env)`). Steps on the host only: no device, no
torch.

Run: python examples/wrap_one_env_torch.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import gymnasium
import numpy as np

from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv

env = GymnasiumPufferEnv(env=gymnasium.make('CartPole-v1'))  # <- the line

obs, info = env.reset(seed=0)
print('flat observation space:', env.observation_space)
print('flat action space:     ', env.action_space)
obs, reward, done, truncated, info = env.step(np.array([1]))
print('step ->', obs.shape, reward, done)
