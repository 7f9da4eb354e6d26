"""Checkpoint/resume: policy and optimizer state_dicts + trainer counters.

Counterpart of pufferlib_tpu/training/checkpoint.py, torch-native:
model_{epoch:06d}.pt holds the policy's state_dict, trainer_state.pt the
optimizer's state_dict and the counters, each written to a temporary
file and renamed, under {data_dir}/{exp_id}.
"""
import os

import torch


def _atomic_save(obj, path):
    torch.save(obj, path + '.tmp')
    os.replace(path + '.tmp', path)


def save_checkpoint(data):
    """Write model_{epoch}.pt + trainer_state.pt atomically."""
    config = data.config
    path = os.path.join(config.data_dir, config.exp_id)
    os.makedirs(path, exist_ok=True)

    model_name = f'model_{data.epoch:06d}.pt'
    model_path = os.path.join(path, model_name)
    _atomic_save(data.policy.state_dict(), model_path)

    state = dict(
        optimizer=data.optimizer.state_dict(),
        global_step=data.global_step,
        agent_step=data.global_step,
        update=data.epoch,
        model_name=model_name,
        exp_id=config.exp_id,
    )
    _atomic_save(state, os.path.join(path, 'trainer_state.pt'))
    return model_path


def try_load_checkpoint(data):
    """Restore policy/optimizer state and counters if a checkpoint
    exists."""
    config = data.config
    path = os.path.join(config.data_dir, config.exp_id)
    trainer_path = os.path.join(path, 'trainer_state.pt')
    if not os.path.exists(trainer_path):
        print('No checkpoints found. Assuming new experiment')
        return False

    device = data.device
    state = torch.load(trainer_path, map_location=device, weights_only=True)
    data.global_step = state['global_step']
    data.epoch = state['update']
    data.policy.load_state_dict(torch.load(
        os.path.join(path, state['model_name']), map_location=device,
        weights_only=True))
    data.optimizer.load_state_dict(state['optimizer'])
    print(f'Loaded checkpoint {state["model_name"]}')
    return True
