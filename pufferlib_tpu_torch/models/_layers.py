"""The Linear layer helpers that the model families share."""
import sys

import torch
import torch.nn.functional as F
from torch import nn


def _linear(layer, x, dtype):
    """nn.Linear `layer` on x in the compute dtype, as flax
    Dense(dtype=cdt): input, weight and bias cast. A layer sharded over a
    model axis (parallel.param_shardings: its weight a DTensor) takes x
    whole and gives its output whole (parallel.mesh.sharded_linear)."""
    weight, bias = layer.weight.to(dtype), layer.bias.to(dtype)
    dtensor = sys.modules.get('torch.distributed.tensor')
    if dtensor is not None and isinstance(weight, dtensor.DTensor):
        from pufferlib_tpu_torch.parallel.mesh import sharded_linear
        return sharded_linear(x.to(dtype), weight, bias)
    return F.linear(x.to(dtype), weight, bias)


def _orthogonal_dense(in_features, out_features, std, generator):
    """nn.Linear with an orthogonal weight of gain std and a zero bias
    (the JAX layer_init_dense)."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, std, generator=generator)
        layer.bias.zero_()
    return layer
