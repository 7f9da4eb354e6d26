"""Multi-process training: joining the group, and each process's rows.

Counterpart of pufferlib_tpu/parallel/multihost.py on torch.distributed.
Every process runs the same program, one rank each (torchrun, or
`spawn` below), and the trainer shards the env lanes over the mesh's
'env' axis: rank r of k steps lanes [r * L / k, (r + 1) * L / k) of the
vecenv's L and launches its own kernels on them.

- `init_distributed()` joins the default process group: NCCL on the card
  (each rank on cuda:{local rank}), gloo where the caller asks for the
  CPU. Nothing falls back: a group that cannot form raises.
- `host_sharded_batch(local, mesh)` is a host-env batch as the mesh holds
  it: each process keeps its own rows, on its own device.
"""
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from pufferlib_tpu_torch import resolve_device
from pufferlib_tpu_torch.exceptions import APIUsageError


def local_rank():
    """This process's card index on its host: torchrun's LOCAL_RANK, else
    the rank modulo the host's card count."""
    if 'LOCAL_RANK' in os.environ:
        return int(os.environ['LOCAL_RANK'])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def init_distributed(coordinator_address=None, num_processes=None,
        process_id=None, device=None, backend=None, timeout=None):
    """Join the default process group (init_process_group).

    coordinator_address: 'host:port' (TCP), or an init URL ('tcp://...',
    'file://...', 'env://'); None takes torchrun's MASTER_ADDR /
    MASTER_PORT / RANK / WORLD_SIZE. num_processes and process_id default
    to WORLD_SIZE and RANK. device ('cuda' by default) picks the backend:
    NCCL on the card, gloo on the CPU; `backend` names another (gloo
    for ranks that share one card: NCCL refuses two ranks on a device).
    timeout: seconds a collective may wait (torch's default when None).

    A no-op when a group exists, and in a single process with no
    coordinator (neither arguments nor torchrun's variables): nothing to
    join. Any other failure raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if 'MASTER_ADDR' not in env or 'MASTER_PORT' not in env:
            if (num_processes or int(env.get('WORLD_SIZE', 1))) > 1:
                raise APIUsageError(f'{num_processes or env["WORLD_SIZE"]} '
                    'processes but no coordinator: pass '
                    'coordinator_address or set MASTER_ADDR / MASTER_PORT')
            return
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    world = int(env.get('WORLD_SIZE', 1)) if num_processes is None \
        else num_processes
    rank = int(env.get('RANK', 0)) if process_id is None else process_id
    device = resolve_device('cuda' if device is None else device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(int(env['LOCAL_RANK']) if 'LOCAL_RANK' in env
            else rank % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
        world_size=world, rank=rank, **kwargs)


def global_mesh(axis='env', device=None):
    """1-D mesh over every process of the group (make_mesh)."""
    from pufferlib_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(axis=axis, device=device)


def host_sharded_batch(local_batch, mesh, axis='env'):
    """A host-env batch as the mesh holds it: local_batch is a tree (dict
    / tuple / list) of arrays or tensors whose leading dim is this
    process's share of the global batch; each leaf goes to this rank's
    device as it is, with no copy across processes (each rank consumes
    its own rows, as the trainer's lanes)."""
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == 'cuda' else torch.device('cpu')

    def build(x):
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        return torch.as_tensor(x).to(device)
    return build(local_batch)


def process_local_slice(global_size, axis_size=None):
    """(start, stop) rows of the global batch owned by this process; the
    last process takes any remainder."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    idx = dist.get_rank() if dist.is_initialized() else 0
    per = global_size // n
    return idx * per, (idx + 1) * per if idx < n - 1 else global_size


def _rank_main(rank, fn, nprocs, init_method, device, backend, timeout,
        args, queue):
    init_distributed(init_method, nprocs, rank, device=device,
        backend=backend, timeout=timeout)
    try:
        queue.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs, args=(), device='cuda', backend=None, timeout=900):
    """Run fn(*args) in `nprocs` new processes joined as one group
    (init_distributed through a file store in a temporary directory;
    device and backend as there) and return fn's values by rank. fn must
    be importable by the children: a module's function, or a script's
    under `if __name__ == '__main__'`. A rank that raises stops the
    others and raises here; so does a run past `timeout` seconds, which
    also bounds each collective's wait."""
    import torch.multiprocessing as mp
    queue = mp.get_context('spawn').SimpleQueue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = 'file://' + os.path.join(tmp, 'rendezvous')
        context = mp.start_processes(_rank_main, args=(fn, nprocs,
            init_method, device, backend, timeout, args, queue),
            nprocs=nprocs, join=False, start_method='spawn')
        deadline = time.monotonic() + timeout
        done = False
        while not done:
            done = context.join(timeout=1)
            while not queue.empty():
                rank, value = queue.get()
                results[rank] = value
            if not done and time.monotonic() > deadline:
                for process in context.processes:
                    process.kill()
                raise TimeoutError(f'{nprocs} ranks ran past {timeout} s')
    return [results[r] for r in range(nprocs)]
