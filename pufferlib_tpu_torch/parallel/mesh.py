"""Device meshes: env lanes over a data axis, params over a model axis.

Counterpart of pufferlib_tpu/parallel/mesh.py on torch.distributed. The
JAX package shards the env lanes (and so the rollout batch) over a mesh
axis 'env', replicates the params, and lets GSPMD insert the gradient
psum; an optional 'model' axis shards the params (tensor parallelism).

Here one process runs each rank (NCCL on the card, gloo where the caller
asks for the CPU), and the trainer (training/ppo.py) does what GSPMD did:
each rank steps its own block of lanes and launches its own kernels, and
one all-reduce over the env axis's group sums the gradient. The model
axis is a `parallelize_module` plan (param_shardings): the sharded
weights are DTensors, and `sharded_linear` runs a layer on them with its
input and output whole on every rank of the axis.

The placement helpers (replicated, env_sharded, carry_shardings,
batch_shardings) return what JAX's NamedShardings say, as DTensor
placements with the block this rank holds.
"""
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

from pufferlib_tpu_torch import resolve_device
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.namespace import namespace


def _world(device):
    """World size of the default process group on `device`'s type,
    joining it from torchrun's variables (init_distributed) when none
    exists; raises when there is none to join."""
    from pufferlib_tpu_torch.parallel.multihost import (
        init_distributed, local_rank)
    init_distributed(device=device)
    if not dist.is_initialized():
        raise APIUsageError('a mesh needs a process group: launch with '
            'torchrun, or call parallel.init_distributed(address, '
            'num_processes, process_id) on every process first')
    if device.type == 'cuda':
        torch.cuda.set_device(local_rank())
    return dist.get_world_size()


def make_mesh(n_devices=None, axis='env', device=None):
    """1-D mesh over the env/data axis: one rank per process, every
    process of the group (n_devices, when given, must be the world size).
    device: 'cuda' (the default; each rank on cuda:{local rank}) or
    'cpu'."""
    device = resolve_device('cuda' if device is None else device)
    world = _world(device)
    n = world if n_devices is None else n_devices
    if n != world:
        raise APIUsageError(f'make_mesh({n}) in a group of {world} '
            'processes: the mesh spans every process')
    return DeviceMesh(device.type, list(range(n)), mesh_dim_names=(axis,))


def make_mesh_2d(n_env, n_model, axes=('env', 'model'), device=None):
    """2-D mesh: env/data parallelism on one axis, tensor (model)
    parallelism on the other, the model axis minor, as the JAX package
    keeps it (its collectives are per-matmul): ranks r * n_model ..
    (r + 1) * n_model - 1 share env block r."""
    device = resolve_device('cuda' if device is None else device)
    world = _world(device)
    if n_env * n_model != world:
        raise APIUsageError(f'make_mesh_2d({n_env}, {n_model}) in a group '
            f'of {world} processes: the mesh spans every process')
    ranks = torch.arange(world).reshape(n_env, n_model)
    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axes))


def axis_size(mesh, axis):
    """Size of `axis` of the mesh, 1 where it has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def param_shardings(mesh, module, axis='model'):
    """Tensor-parallel plan for `module`, the JAX rule (a flax kernel
    (in, out) is torch's nn.Linear.weight (out, in)): each nn.Linear
    shards its outputs over `axis` where they divide (ColwiseParallel),
    else its inputs (RowwiseParallel), else replicates (no entry); 1-D
    leaves (biases) follow their layer's style, other parameters
    replicate. Every style takes its input whole and gives its output
    whole, so a layer's neighbours see plain tensors. A mesh with no
    `axis`, or an axis of 1, replicates everything: the plan is empty.
    Apply it with torch.distributed.tensor.parallel.parallelize_module(
    module, mesh[axis], plan)."""
    k = axis_size(mesh, axis)
    if k == 1:
        return {}
    plan = {}
    for name, layer in module.named_modules():
        if not isinstance(layer, nn.Linear):
            continue
        out_features, in_features = layer.weight.shape
        if out_features % k == 0 and out_features >= k:
            plan[name] = ColwiseParallel(output_layouts=Replicate())
        elif in_features % k == 0 and in_features >= k:
            plan[name] = RowwiseParallel(input_layouts=Replicate())
    return plan


def sharded_linear(x, weight, bias):
    """F.linear on a weight that param_shardings' plan sharded (a
    DTensor): x whole on every rank of the model axis, the output whole
    too (a column-parallel layer gathers its outputs, a row-parallel one
    sums its partial products), differentiable."""
    mesh = weight.device_mesh
    x = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    if weight.placements[0] == Shard(1):
        # row-parallel: each rank multiplies its slice of the inputs
        x = x.redistribute(mesh, [Shard(-1)])
    out = F.linear(x, weight, bias)
    return out.redistribute(mesh, [Replicate()]).to_local()


def local(tensor):
    """This rank's block of a DTensor; a plain tensor as it is."""
    return tensor.to_local() if isinstance(tensor, DTensor) else tensor


def full(tensor):
    """The whole of a DTensor on every rank of its mesh (a collective:
    every rank calls it); a plain tensor as it is."""
    return tensor.full_tensor() if isinstance(tensor, DTensor) else tensor


def env_axis(mesh, axis='env'):
    """What the trainer needs of a mesh: the env axis's process group,
    its size `k` and this rank's index `r` on it (it owns lane block r of
    k), and `model`, the model axis's submesh where the params shard,
    else None."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise APIUsageError(f'the mesh has no {axis!r} axis: {names}')
    sub = mesh[axis] if len(names) > 1 else mesh
    model = mesh['model'] if axis_size(mesh, 'model') > 1 else None
    return namespace(group=sub.get_group(), k=sub.size(),
        r=sub.get_local_rank(), model=model)


def replicated(mesh):
    """Placements of a tensor held whole on every rank."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def _block(x, mesh, axis, dim):
    """(placements, this rank's block of x along dim) for x sharded on
    `dim` over `axis` (replicated over any other axis)."""
    names = mesh.mesh_dim_names
    placements = tuple(Shard(dim) if name == axis else Replicate()
        for name in names)
    k = axis_size(mesh, axis)
    r = mesh.get_local_rank(names.index(axis)) if axis in names else 0
    n = x.shape[dim] // k
    return placements, x.narrow(dim, r * n, n)


def env_sharded(mesh, tree, axis='env', dim=0):
    """Shard every leaf of `tree` (a tensor, or a dict / tuple / list of
    them) along `dim` over the mesh axis: the same structure of
    (placements, this rank's block) pairs."""
    if isinstance(tree, dict):
        return {k: env_sharded(mesh, v, axis, dim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(env_sharded(mesh, v, axis, dim) for v in tree)
    return _block(tree, mesh, axis, dim)


def carry_shardings(mesh, carry, axis='env'):
    """Placements and blocks of the trainer's rollout carry: env states,
    done flags and obs on dim 0 (lanes / agent rows), the LSTM state
    (layers, rows, H) on dim 1."""
    out = {k: env_sharded(mesh, carry[k], axis, dim=0)
        for k in ('env', 'done', 'obs')}
    lstm = carry.get('lstm')
    out['lstm'] = None if lstm is None else env_sharded(mesh, lstm, axis,
        dim=1)
    return out


def batch_shardings(mesh, recurrent, axis='env'):
    """Placement factory for the rollout batch dict, as the JAX one:
    leaves (T, N, ...) on the agent axis (dim 1), last_value (N,) on dim
    0, lstm0 (n_seg, layers, N, H) on dim 2. `recurrent` is taken for
    the JAX signature; the batch's own keys decide."""
    def build(batch):
        out = {}
        for k, v in batch.items():
            dim = {'last_value': 0, 'lstm0': 2}.get(k, 1)
            out[k] = env_sharded(mesh, v, axis, dim=dim)
        return out
    return build
