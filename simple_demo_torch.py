"""Smallest end-to-end training script of the PyTorch port (simple_demo.py
on the card).

python simple_demo_torch.py      # trains PPO on squared, prints score
PUFFER_DEVICE=cpu python simple_demo_torch.py   # the same on the CPU
"""
import os

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch.models import Default, Policy
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.training import ppo

device = os.environ.get('PUFFER_DEVICE', 'cuda')
vecenv = vector.make(env_creator('squared'), backend=vector.Device,
    num_envs=256, device=device)
policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
    action_space=vecenv.single_action_space, hidden_size=128))
config = ppo.default_config(env='squared', batch_size=16384,
    minibatch_size=4096, bptt_horizon=8, total_timesteps=16384 * 15,
    learning_rate=0.017, device=device)
data = ppo.create(config, vecenv, policy)
while data.global_step < config.total_timesteps:
    ppo.step(data)
print('score:', float(data.stats['score']))
ppo.close(data)
