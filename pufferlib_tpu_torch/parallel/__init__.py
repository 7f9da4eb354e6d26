"""Multi-device training on torch.distributed (pufferlib_tpu/parallel):
meshes, the tensor-parallel plan and the multi-process helpers."""
from pufferlib_tpu_torch.parallel.mesh import (
    make_mesh, make_mesh_2d, param_shardings, replicated, env_sharded,
    carry_shardings, batch_shardings,
)
from pufferlib_tpu_torch.parallel.multihost import (
    global_mesh, host_sharded_batch, init_distributed,
    process_local_slice,
)

__all__ = ['make_mesh', 'make_mesh_2d', 'param_shardings', 'replicated',
    'env_sharded', 'carry_shardings', 'batch_shardings', 'global_mesh',
    'host_sharded_batch', 'init_distributed', 'process_local_slice']
