"""The ranks of the port's multi-device tests (tests/test_torch_parallel.py):
each trains a small squared trainer on the CPU as one rank of a gloo mesh.

    python tests/torch_mesh_worker.py SPEC.json

SPEC holds `world` (the process count), `mesh` ([k] for make_mesh,
[n_env, n_model] for make_mesh_2d), the trainer (`build`'s keys) and
`out`: where the launcher writes rank 0's params (`out`.npz) and every
rank's result (`out`.json). With `refusals` each rank only asks
ppo.create for what it must refuse. The children import the port only;
the JAX side of a test is computed in the test's own process, which
also imports `build` to run the same trainer with no mesh.
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build(spec, mesh=None):
    """The trainer of `spec` on the CPU: spec['env'] (squared by default)
    at spec['num_envs'] lanes (env_kwargs optional), Default(hidden) as
    Policy, or with
    policy='lstm' inside LSTMWrapper(hidden, hidden), with
    policy='transformer' inside TransformerWrapper(hidden, hidden,
    spec['window'], 4 heads); policy='conv' is Convolutional(framestack
    2, flat 64, hidden) on the visual env; use_kernel on the
    module that takes it; weights from spec['weights'] (a state_dict
    npz) else a seeded init; config overrides in spec['config']."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Convolutional, Default, LSTMWrapper, Policy, RecurrentPolicy,
        TransformerPolicy, TransformerWrapper)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo
    torch.set_num_threads(1)
    conv = spec.get('policy') == 'conv'
    vecenv = vector.make(env_creator('visual' if conv else
        spec.get('env', 'squared')), env_kwargs=spec.get('env_kwargs', {}),
        num_envs=spec['num_envs'], device='cpu')
    shape = vecenv.single_observation_space.shape
    hidden = spec.get('hidden', 32)
    lstm = spec.get('policy') == 'lstm'
    transformer = spec.get('policy') == 'transformer'
    generator = torch.Generator().manual_seed(spec.get('init_seed', 0))
    if conv:
        module = Convolutional(vecenv.single_action_space, 2, 64,
            hidden_size=hidden, generator=generator)
    else:
        module = Default(obs_shape=shape,
            action_space=vecenv.single_action_space, hidden_size=hidden,
            emulated=vecenv.emulated,
            use_kernel=False if lstm or transformer
                else spec.get('use_kernel', False), generator=generator)
    if lstm:
        module = LSTMWrapper(module, obs_shape=shape, input_size=hidden,
            hidden_size=hidden, use_kernel=spec.get('use_kernel', False),
            generator=torch.Generator().manual_seed(
                spec.get('init_seed', 0) + 1))
    if transformer:
        module = TransformerWrapper(module, obs_shape=shape,
            input_size=hidden, hidden_size=hidden, window=spec['window'],
            num_heads=4, generator=torch.Generator().manual_seed(
                spec.get('init_seed', 0) + 1))
    if spec.get('weights'):
        with np.load(spec['weights']) as f:
            module.load_state_dict({k: torch.from_numpy(f[k].copy())
                for k in f.files})
    policy = (RecurrentPolicy(module) if lstm else TransformerPolicy(module)
        if transformer else Policy(module))
    config = ppo.default_config(device='cpu', verbose=False,
        data_dir=spec.get('data_dir', 'experiments'),
        checkpoint_interval=10 ** 6, **spec['config'])
    return ppo.create(config, vecenv, policy, mesh=mesh)


def _draws(spec):
    """spec['draws'] (an npz of u (T, N), reset (T, L, ...) and init (L,
    ...)) as torch tensors, or None."""
    import torch
    if not spec.get('draws'):
        return None
    with np.load(spec['draws']) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


def train(spec, mesh=None):
    """build(spec), then spec['epochs'] x (evaluate + train), the first
    rollout with spec's draws (initial env state included). Returns the
    losses of each epoch, the params whole (every rank gathers them), the
    names of the >= 2-D params this rank holds only a block of, and this
    rank's lanes."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.training import checkpoint, ppo
    data = build(spec, mesh)
    lanes = slice(0, spec['num_envs'])
    if mesh is not None:
        from pufferlib_tpu_torch.parallel.mesh import env_axis
        axis = env_axis(mesh)
        n = spec['num_envs'] // axis.k
        lanes = slice(axis.r * n, (axis.r + 1) * n)
    draws = _draws(spec)
    if draws is not None:
        reset_batch, _ = vector.make_env_ops(data.vecenv.env,
            data.vecenv.emulated)
        states, obs, dones = reset_batch(draws['init'][lanes])
        lstm = data.carry['lstm']
        data.carry = dict(env=states, done=dones, obs=obs,
            lstm=None if lstm is None else tuple(torch.zeros_like(s)
                for s in lstm))
    losses = []
    for epoch in range(spec.get('epochs', 1)):
        ppo.evaluate(data, draws if epoch == 0 else None)
        ppo.train(data)
        losses.append(dict(data.losses))
    result = dict(losses=losses, stats=dict(data.stats),
        lanes=[lanes.start, lanes.stop], params=_whole_params(data),
        sharded=_sharded(data))
    if spec.get('checkpoint'):
        path = checkpoint.save_checkpoint(data)
        again = build(dict(spec, weights=None, init_seed=99), mesh)
        again.config.exp_id = data.config.exp_id
        loaded = checkpoint.try_load_checkpoint(again)
        same = _whole_params(again)
        result['checkpoint'] = dict(loaded=loaded, path=path,
            files=sorted(os.listdir(os.path.dirname(path)))
                if os.path.isdir(os.path.dirname(path)) else [],
            equal=all(np.array_equal(same[k], result['params'][k])
                for k in same),
            adam_steps=int(again.optimizer.state_dict()['state'][0]['step']))
    if spec.get('resume'):
        # another trainer's checkpoint (written with no mesh), loaded
        # into this mesh's shards
        resume = spec['resume']
        again = build(dict(spec, weights=None, init_seed=99,
            data_dir=resume['data_dir']), mesh)
        again.config.exp_id = resume['exp_id']
        loaded = checkpoint.try_load_checkpoint(again)
        with np.load(resume['params']) as f:
            differ = max(float(np.abs(v - f[k]).max())
                for k, v in _whole_params(again).items())
        result['resumed'] = dict(loaded=loaded, differ=differ,
            adam_steps=int(again.optimizer.state_dict()['state'][0]['step']))
    return result


def _whole_params(data):
    from pufferlib_tpu_torch.parallel.mesh import full
    return {k: full(v).detach().cpu().numpy()
        for k, v in data.policy.state_dict().items()}


def _sharded(data):
    dtensor = sys.modules.get('torch.distributed.tensor')
    if dtensor is None:
        return []
    return [k for k, v in data.policy.state_dict().items()
        if isinstance(v, dtensor.DTensor) and v.ndim >= 2
        and tuple(v.to_local().shape) != tuple(v.shape)]


def refusals(spec):
    """What ppo.create must refuse on this rank, each as the error's
    text: the kernels under a model axis, lanes and minibatch segments
    that do not divide over the env axis."""
    from pufferlib_tpu_torch.exceptions import APIUsageError
    from pufferlib_tpu_torch.parallel import make_mesh, make_mesh_2d
    mesh = make_mesh(device='cpu')
    mesh2 = make_mesh_2d(1, 2, device='cpu')
    base = dict(num_envs=16, config=dict(batch_size=512,
        minibatch_size=256, bptt_horizon=8))
    cases = {
        'default_use_kernel': (dict(base, use_kernel=True), mesh2),
        'lstm_use_kernel_none': (dict(base, policy='lstm',
            use_kernel=None), mesh2),
        'lstm_use_kernel_true': (dict(base, policy='lstm',
            use_kernel=True), mesh2),
        'lanes': (dict(base, num_envs=15, config=dict(batch_size=480,
            minibatch_size=240, bptt_horizon=8)), mesh),
        'seg_rows': (dict(base, config=dict(batch_size=512,
            minibatch_size=8, bptt_horizon=8)), mesh),
    }
    out = {}
    for name, (case, m) in cases.items():
        try:
            build(case, m)
            out[name] = None
        except APIUsageError as e:
            out[name] = str(e)
    # and what it takes: the plain paths under the model axis
    build(dict(base, policy='lstm', use_kernel=False), mesh2)
    out['lstm_use_kernel_false'] = 'built'
    return out


def run_rank(spec):
    from pufferlib_tpu_torch.parallel import make_mesh, make_mesh_2d
    if spec.get('refusals'):
        return refusals(spec)
    shape = spec['mesh']
    mesh = make_mesh(shape[0], device='cpu') if len(shape) == 1 \
        else make_mesh_2d(*shape, device='cpu')
    return train(spec, mesh)


def main(path):
    from pufferlib_tpu_torch.parallel.multihost import spawn
    with open(path) as f:
        spec = json.load(f)
    results = spawn(run_rank, spec['world'], args=(spec,), device='cpu',
        timeout=spec.get('timeout', 240))
    if not spec.get('refusals'):
        params = results[0]['params']
        for r in results:
            # every rank holds the same params after each step
            r['params_differ'] = max(float(np.abs(v - params[k]).max())
                for k, v in r.pop('params').items())
        np.savez(spec['out'] + '.npz', **params)
    with open(spec['out'] + '.json', 'w') as f:
        json.dump(results, f)


if __name__ == '__main__':
    main(sys.argv[1])
