"""The layer helpers that the model families and the zoo policies share.

A flax layer with dtype=cdt, param_dtype=f32 casts its input, weight and
bias to cdt; nn.Embed looks its f32 table up. The initialisers draw from
an explicit torch.Generator: orthogonal Dense and (gain sqrt 2)
convolutions, as the JAX layer_init helpers; lecun-normal Dense layers
and normal embeddings, as flax's defaults. The JAX draws themselves are
not reproduced: tests carry the weights through convert.py.
"""
import math
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


def _orthogonal_conv(cin, cout, k, stride, generator):
    """VALID nn.Conv2d with an orthogonal weight of gain sqrt 2 and a zero
    bias (the JAX layer_init)."""
    layer = nn.Conv2d(cin, cout, k, stride=stride)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, math.sqrt(2), generator=generator)
        layer.bias.zero_()
    return layer


def _conv_relu(layer, x, dtype):
    """relu of the convolution `layer` on x (NCHW) in the compute dtype."""
    return torch.relu(F.conv2d(x.to(dtype), layer.weight.to(dtype),
        layer.bias.to(dtype), stride=layer.stride))


def _lecun_dense(in_features, out_features, generator):
    """nn.Linear as flax's default Dense: lecun normal (a normal truncated
    at two standard deviations, scaled to variance 1 / in_features), zero
    bias."""
    layer = nn.Linear(in_features, out_features)
    # the standard deviation of a unit normal truncated to (-2, 2)
    std = 1.0 / math.sqrt(in_features) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
            generator=generator)
        layer.bias.zero_()
    return layer


def _embedding(num, features, generator):
    """nn.Embedding as flax's default Embed: normal, std
    1 / sqrt(features)."""
    layer = nn.Embedding(num, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, 1.0 / math.sqrt(features),
            generator=generator)
    return layer
