"""Checkpoint/resume: policy and optimizer state_dicts + trainer counters.

Counterpart of pufferlib_tpu/training/checkpoint.py, torch-native:
model_{epoch:06d}.pt holds the policy's state_dict, trainer_state.pt the
optimizer's state_dict and the counters, each written to a temporary
file and renamed, under {data_dir}/{exp_id}.

Under a mesh (training/ppo.py) rank 0 writes the files and every rank
loads them. Params sharded over a model axis, and their Adam moments,
are saved whole (every rank gathers them: call save_checkpoint on every
rank) and loaded back into each rank's shards, so a checkpoint written
under a model axis loads with none, and the other way round.

save_pytree / load_pytree are the JAX package's format (a pickle of a
nested dict of numpy arrays, written atomically), which needs neither
JAX nor torch to read: convert.py turns such a params tree into a
state_dict.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_pytree(tree, path):
    """Pickle `tree` (nested dicts, lists and tuples of arrays or
    tensors, each saved as a numpy array) to path, atomically."""
    with open(path + '.tmp', 'wb') as f:
        pickle.dump(_to_numpy(tree), f)
    os.replace(path + '.tmp', path)


def load_pytree(path):
    """The tree save_pytree (this package's or the JAX package's)
    wrote."""
    with open(path, 'rb') as f:
        return pickle.load(f)


def _atomic_save(obj, path):
    torch.save(obj, path + '.tmp')
    os.replace(path + '.tmp', path)


def _dtensor():
    """torch.distributed.tensor where a DTensor can exist (the module is
    imported), else None."""
    return sys.modules.get('torch.distributed.tensor')


def _whole(obj):
    """obj (a state_dict tree) with every DTensor gathered whole; obj
    itself where it holds none."""
    dtensor = _dtensor()
    if dtensor is None:
        return obj
    if isinstance(obj, dtensor.DTensor):
        from pufferlib_tpu_torch.parallel.mesh import full
        return full(obj)
    if isinstance(obj, dict):
        out = {k: _whole(v) for k, v in obj.items()}
    elif isinstance(obj, (list, tuple)):
        out = dict(enumerate(_whole(v) for v in obj))
    else:
        return obj
    items = obj.items() if isinstance(obj, dict) else enumerate(obj)
    if all(out[k] is v for k, v in items):
        return obj
    return out if isinstance(obj, dict) else type(obj)(out.values())


def _shard_like(value, like):
    """A whole tensor laid out as `like` (a DTensor: this rank's shard,
    with no communication); else as it is."""
    dtensor = _dtensor()
    if dtensor is None or not isinstance(like, dtensor.DTensor):
        return value
    from pufferlib_tpu_torch.parallel.mesh import shard, split_of
    return shard(value.to(like.dtype), like.device_mesh, split_of(like)[3])


def save_checkpoint(data):
    """Write model_{epoch}.pt + trainer_state.pt atomically (rank 0 under
    a mesh; every rank returns the model's path)."""
    config = data.config
    path = os.path.join(config.data_dir, config.exp_id)
    model_name = f'model_{data.epoch:06d}.pt'
    model_path = os.path.join(path, model_name)
    model = _whole(data.policy.state_dict())
    optimizer = _whole(data.optimizer.state_dict())
    if data.get('rank', 0) == 0:
        _write(data, path, model_name, model, optimizer)
    if data.get('mesh') is not None:
        # every rank returns once the files are there to load
        torch.distributed.barrier()
    return model_path


def _write(data, path, model_name, model, optimizer):
    config = data.config
    model_path = os.path.join(path, model_name)
    os.makedirs(path, exist_ok=True)
    _atomic_save(model, model_path)

    state = dict(
        optimizer=optimizer,
        global_step=data.global_step,
        agent_step=data.global_step,
        update=data.epoch,
        model_name=model_name,
        exp_id=config.exp_id,
    )
    _atomic_save(state, os.path.join(path, 'trainer_state.pt'))


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
    model = torch.load(os.path.join(path, state['model_name']),
        map_location=device, weights_only=True)
    current = data.policy.state_dict()
    data.policy.load_state_dict({k: _shard_like(v, current[k])
        for k, v in model.items()})
    data.optimizer.load_state_dict(state['optimizer'])
    for param, slots in data.optimizer.state.items():
        for k, v in slots.items():
            if torch.is_tensor(v) and v.shape == param.shape:
                slots[k] = _shard_like(v, param)
    print(f'Loaded checkpoint {state["model_name"]}')
    return True
