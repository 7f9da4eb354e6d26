"""Device meshes: env lanes over a data axis, params over a model axis.

Counterpart of pufferlib_tpu/parallel/mesh.py on torch.distributed. The
JAX package shards the env lanes (and so the rollout batch) over a mesh
axis 'env', replicates the params, and lets GSPMD insert the gradient
psum; an optional 'model' axis shards the params (tensor parallelism).

Here one process runs each rank (NCCL on the card, gloo where the caller
asks for the CPU, or for ranks that share a card), and the trainer
(training/ppo.py) does what GSPMD did: each rank steps its own block of
lanes and launches its own kernels, and one all-reduce over the env
axis's group sums the gradient. On the model axis param_shardings is the
JAX rule, every parameter of two or more dims in its JAX layout:
shard_params makes each one it splits a DTensor of this rank's block,
and the layers use them through sharded_linear, sharded_matmul,
sharded_conv2d, sharded_embedding and whole, which take their
activations whole on every rank of the axis and give them whole. Their
collectives are dist.all_reduce alone (the GSPMD activation collectives
of the JAX package).

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


class ShardingPlan(dict):
    """What param_shardings gives: `dims`, {parameter name: the torch dim
    it splits on over the model axis}, for every parameter the JAX rule
    shards; and, as a dict, {name of an nn.Linear whose weight is among
    them: its style}, in torch.distributed.tensor.parallel's words for
    what sharded_linear does (ColwiseParallel: the weight split on its
    outputs, the output gathered whole; RowwiseParallel: split on its
    inputs, the input taken whole). shard_params applies it."""

    def __init__(self, styles=(), dims=None):
        super().__init__(styles)
        self.dims = dict(dims or {})


def _jax_dims(layer, name, param):
    """(the JAX layout's last dim, its first) of a parameter, as torch
    dims (convert.py's layouts): an nn.Linear weight (out, in) is flax's
    (in, out); a convolution's (out, in, kh[, kw]) is (kh[, kw], in,
    out); every other parameter (an nn.Embedding's (n, d), the LSTM's
    and the attention's matrices) is stored in the JAX layout."""
    if name == 'weight' and isinstance(layer, nn.Linear):
        return 0, 1
    if name == 'weight' and isinstance(layer, nn.modules.conv._ConvNd):
        return 0, 2
    return param.ndim - 1, 0


def param_shardings(mesh, module, axis='model'):
    """Tensor-parallel plan for `module`, the JAX rule
    (pufferlib_tpu/parallel/mesh.py:41-69) read in each parameter's JAX
    layout: a parameter of two or more dims shards over `axis` on the
    JAX last dim where it divides (>= k), else on the first, else
    replicates; 1-D and 0-D parameters (biases, LayerNorm) replicate. A
    mesh with no `axis`, or an axis of 1, replicates everything: the plan
    is empty. Returns a ShardingPlan; apply it with shard_params(module,
    plan, mesh[axis]). Adam's moments then take each parameter's
    placement, as JAX's param_shardings(mesh, opt_state) gives them."""
    k = axis_size(mesh, axis)
    if k == 1:
        return ShardingPlan()
    styles, dims = {}, {}
    for prefix, layer in module.named_modules():
        for name, param in layer.named_parameters(recurse=False):
            if param.ndim < 2:
                continue
            for dim in _jax_dims(layer, name, param):
                if param.shape[dim] % k == 0 and param.shape[dim] >= k:
                    dims[f'{prefix}.{name}' if prefix else name] = dim
                    break
            else:
                continue
            if name == 'weight' and isinstance(layer, nn.Linear):
                styles[prefix] = ColwiseParallel(
                    output_layouts=Replicate()) if dim == 0 else \
                    RowwiseParallel(input_layouts=Replicate())
    return ShardingPlan(styles, dims)


def shard(tensor, mesh, dim):
    """This rank's block of `tensor` (whole on every rank) along `dim` of
    the 1-D mesh, as a DTensor placed Shard(dim): no communication."""
    k, r = mesh.size(), mesh.get_local_rank()
    n = tensor.shape[dim] // k
    return DTensor.from_local(tensor.narrow(dim, r * n, n).contiguous(),
        mesh, [Shard(dim)], run_check=False)


def shard_params(module, plan, mesh):
    """Replace each parameter of plan.dims by its block on `mesh` (the
    model axis's 1-D submesh), a DTensor Parameter. Every rank must hold
    the same whole parameters first (ppo.create checks it)."""
    for name, dim in plan.dims.items():
        owner, _, attr = name.rpartition('.')
        layer = module.get_submodule(owner)
        param = getattr(layer, attr)
        setattr(layer, attr, nn.Parameter(shard(param.detach(), mesh, dim),
            requires_grad=param.requires_grad))


# The model axis's collectives. Every sharded weight is used through the
# helpers below: each takes its activations whole on every rank of the
# axis and gives them whole, and compute runs on the rank's own block.
# They are the four conjugate pairs of Megatron-style tensor parallelism,
# on dist.all_reduce alone (a gather is each rank's bytes written into
# zeros and summed), so the same code runs over NCCL and over gloo on
# CUDA tensors (two ranks that share a card).

def split_of(weight):
    """(group, k, r, dim) of a parameter that shard_params split: the
    model axis's process group, its size, this rank's index and the dim;
    None for a plain tensor."""
    if not isinstance(weight, DTensor):
        return None
    mesh = weight.device_mesh
    (placement,) = weight.placements
    return mesh.get_group(), mesh.size(), mesh.get_local_rank(), \
        placement.dim


def gather_blocks(x, dim, group, k, r):
    """Every rank's block of x along dim, concatenated in rank order, on
    every rank: one all-reduce of a zero-padded byte buffer, so the bits
    are each rank's own (not differentiable; see gather)."""
    part = x.movedim(dim, 0).contiguous()
    raw = part.reshape(-1).view(torch.uint8)
    buf = torch.zeros((k, raw.numel()), dtype=torch.uint8, device=x.device)
    buf[r] = raw
    dist.all_reduce(buf, group=group)
    return buf.view(x.dtype).reshape((k * part.shape[0],)
        + tuple(part.shape[1:])).movedim(0, dim)


def _own_block(x, dim, k, r):
    n = x.shape[dim] // k
    return x.narrow(dim, r * n, n)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis backward (each
    rank's block gives only its part of dx)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        # summed in f32 (a bf16 dx is rounded once, as one GEMM's is)
        total = grad.float().contiguous()
        if total is grad:
            total = total.clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _Sum(torch.autograd.Function):
    """The ranks' partial results summed forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """The blocks along dim gathered forward; this rank's block of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group, k, r):
        ctx.split = dim, k, r
        return gather_blocks(x, dim, group, k, r)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, *ctx.split), None, None, None, None


class _Slice(torch.autograd.Function):
    """This rank's block along dim forward; the gradient's blocks gathered
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group, k, r):
        ctx.split = dim, group, k, r
        return _own_block(x, dim, k, r)

    @staticmethod
    def backward(ctx, grad):
        return gather_blocks(grad, *ctx.split), None, None, None, None


def enter(x, group):
    return _Enter.apply(x, group)


def reduce_sum(x, group):
    return _Sum.apply(x, group)


def gather(x, dim, group, k, r):
    return _Gather.apply(x, dim % x.ndim, group, k, r)


def slice_block(x, dim, group, k, r):
    return _Slice.apply(x, dim % x.ndim, group, k, r)


def whole(weight):
    """A parameter whole on every rank, differentiable (each rank's
    gradient lands on its block); a plain tensor as it is."""
    split = split_of(weight)
    if split is None:
        return weight
    group, k, r, dim = split
    return gather(weight.to_local(), dim, group, k, r)


def split_columns(*weights):
    """(group, k, r) where every weight of (in, out) layout shards on its
    last dim (its columns: the JAX rule's column-parallel case), else
    None."""
    splits = [split_of(w) for w in weights]
    if any(s is None or s[3] != w.ndim - 1 for s, w in zip(splits,
            weights)):
        return None
    return splits[0][:3]


def column_product(weights):
    """(w, enter_fn, gather_fn) for a product x @ cat(weights) (rows
    stacked) of (in, out) weights (the LSTM's, the attention's), x whole
    on every rank of the model axis: where every weight splits on its
    last dim (the JAX rule's column-parallel case), w is this rank's
    column blocks stacked, enter_fn(x) enters x into the axis and
    gather_fn(y) gathers the product's columns whole; otherwise w is the
    whole weights stacked and both are the identity. Any elementwise
    rounding of w, or cast of the product before gather_fn, gives the
    bits it gives the whole product."""
    split = split_columns(*weights)
    if split is None:
        w = [whole(w) for w in weights]
        return (torch.cat(w) if len(w) > 1 else w[0]), _same, _same
    group, k, r = split
    w = [w.to_local() for w in weights]
    return (torch.cat(w) if len(w) > 1 else w[0]), \
        (lambda x: enter(x, group)), (lambda y: gather(y, -1, group, k, r))


def _same(x):
    return x


def sharded_linear(x, weight, bias):
    """F.linear in x's dtype on a weight that shard_params split (a
    DTensor): x whole on every rank of the model axis, the output whole
    too, differentiable. Column-parallel (outputs split): each rank its
    outputs with its block of the bias, then gathered. Row-parallel
    (inputs split): each rank's partial product of its inputs in f32,
    summed, plus the bias, rounded to x's dtype once."""
    group, k, r, dim = split_of(weight)
    w = weight.to_local().to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if dim == 0:
        if b is not None:
            b = slice_block(b, 0, group, k, r)
        return gather(F.linear(enter(x, group), w, b), -1, group, k, r)
    part = F.linear(slice_block(x, -1, group, k, r).float(), w.float())
    out = reduce_sum(part, group)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def sharded_conv2d(x, weight, bias, stride, padding):
    """F.conv2d in x's dtype on a weight that shard_params split: on out
    channels, each rank its channels with its block of the bias, then
    the channels gathered; on kh, the weight gathered whole at use."""
    group, k, r, dim = split_of(weight)
    b = None if bias is None else bias.to(x.dtype)
    if dim != 0:
        return F.conv2d(x, whole(weight).to(x.dtype), b, stride=stride,
            padding=padding)
    if b is not None:
        b = slice_block(b, 0, group, k, r)
    out = F.conv2d(enter(x, group), weight.to_local().to(x.dtype), b,
        stride=stride, padding=padding)
    return gather(out, 1, group, k, r)


def sharded_embedding(index, weight):
    """F.embedding on a table that shard_params split: on its features,
    each rank looks up its columns, then they are gathered; on its rows,
    each rank looks up the indices it holds (zeros elsewhere), and the
    lookups are summed."""
    group, k, r, dim = split_of(weight)
    table = weight.to_local()
    if dim == 1:
        return gather(F.embedding(index, table), -1, group, k, r)
    n = table.shape[0]
    held = (index >= r * n) & (index < (r + 1) * n)
    rows = F.embedding((index - r * n).clamp(0, n - 1), table)
    return reduce_sum(torch.where(held[..., None], rows, 0.0), group)


def local(tensor):
    """This rank's block of a DTensor; a plain tensor as it is."""
    return tensor.to_local() if isinstance(tensor, DTensor) else tensor


def full(tensor):
    """The whole of a DTensor on every rank of its mesh (a collective:
    every rank calls it; a split parameter's blocks by gather_blocks, bit
    for bit); a plain tensor as it is."""
    if not isinstance(tensor, DTensor):
        return tensor
    split = split_of(tensor) if len(tensor.placements) == 1 and \
        tensor.placements[0].is_shard() else None
    if split is None:
        return tensor.full_tensor()
    return gather_blocks(tensor.to_local(), split[3], *split[:3])


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
