"""Train over an N-card mesh with the PyTorch port: the full trainer, two
extra lines.

Run: torchrun --nproc-per-node N examples/train_sharded_torch.py
(one process a card, NCCL; each steps its own 512 / N of the lanes).
PUFFER_DEVICE=cpu runs gloo ranks on the CPU instead.
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch.models import Default, Policy
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.parallel import make_mesh    # <- line 1
from pufferlib_tpu_torch.training import ppo

device = os.environ.get('PUFFER_DEVICE', 'cuda')
mesh = make_mesh(device=device)                       # <- line 2
vecenv = vector.make(env_creator('squared'), num_envs=512, device=device)
policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
    action_space=vecenv.single_action_space, hidden_size=64,
    generator=torch.Generator().manual_seed(0)))
config = ppo.default_config(env='squared', batch_size=32768,
    minibatch_size=8192, bptt_horizon=8, total_timesteps=32768 * 10,
    learning_rate=0.017, data_dir='experiments/puffer_sharded',
    device=device)
data = ppo.create(config, vecenv, policy, mesh=mesh)  # <- mesh=

while data.global_step < config.total_timesteps:
    ppo.step(data)
if data.rank == 0:
    print('final stats:', data.stats)
