"""The layer helpers that the model families and the zoo policies share.

A flax layer with dtype=cdt, param_dtype=f32 casts its input, weight and
bias to cdt; nn.Embed looks its f32 table up. The initialisers draw from
an explicit torch.Generator: orthogonal Dense and (gain sqrt 2)
convolutions, as the JAX layer_init helpers; lecun-normal Dense layers
and normal embeddings, as flax's defaults. The JAX draws themselves are
not reproduced: tests carry the weights through convert.py.

Every use of a layer's weight goes through _linear, _conv or _embed: a
weight that a model axis split (parallel.param_shardings, a DTensor)
runs through parallel/mesh.py's helpers, its input and output whole on
every rank of the axis.
"""
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn


def _is_split(weight):
    """Whether a model axis split this weight (a DTensor; the module
    exists only where one can)."""
    dtensor = sys.modules.get('torch.distributed.tensor')
    return dtensor is not None and isinstance(weight, dtensor.DTensor)


def _linear(layer, x, dtype):
    """nn.Linear `layer` on x in the compute dtype, as flax
    Dense(dtype=cdt): input, weight and bias cast (a split weight through
    parallel.mesh.sharded_linear)."""
    if _is_split(layer.weight):
        from pufferlib_tpu_torch.parallel.mesh import sharded_linear
        return sharded_linear(x.to(dtype), layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype),
        layer.bias.to(dtype))


def _conv(layer, x, dtype):
    """The convolution `layer` (nn.Conv2d: its stride and padding) on x
    (NCHW) in the compute dtype (a split weight through
    parallel.mesh.sharded_conv2d)."""
    if _is_split(layer.weight):
        from pufferlib_tpu_torch.parallel.mesh import sharded_conv2d
        return sharded_conv2d(x.to(dtype), layer.weight, layer.bias,
            layer.stride, layer.padding)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
        layer.bias.to(dtype), stride=layer.stride, padding=layer.padding)


def _embed(layer, index):
    """The nn.Embedding `layer`'s rows at index, f32 (a split table
    through parallel.mesh.sharded_embedding)."""
    if _is_split(layer.weight):
        from pufferlib_tpu_torch.parallel.mesh import sharded_embedding
        return sharded_embedding(index, layer.weight)
    return F.embedding(index, layer.weight)


def _columns(*weights):
    """(w, enter_fn, gather_fn) for x @ cat(weights) (rows stacked) of
    (in, out) weights: parallel.mesh.column_product where a model axis
    split one; else the stacked weight and the identity twice."""
    if any(_is_split(w) for w in weights):
        from pufferlib_tpu_torch.parallel.mesh import column_product
        return column_product(weights)
    return (torch.cat(weights) if len(weights) > 1 else weights[0]), \
        _same, _same


def _same(x):
    return x


def _whole(weight):
    """A parameter whole (gathered where a model axis split it)."""
    if _is_split(weight):
        from pufferlib_tpu_torch.parallel.mesh import whole
        return whole(weight)
    return weight


def orthogonal_init(std=math.sqrt(2)):
    """An initialiser (tensor, generator=None) -> tensor: orthogonal of
    gain std, in place (the JAX orthogonal_init, flax's
    initializers.orthogonal(scale=std)). torch draws the orthogonal matrix
    for an (out, in) weight; the JAX draws are not reproduced."""
    def init(tensor, generator=None):
        with torch.no_grad():
            return nn.init.orthogonal_(tensor, std, generator=generator)
    return init


def layer_init_dense(in_features, out_features, std=math.sqrt(2),
        generator=None):
    """CleanRL's layer_init, the JAX layer_init_dense: nn.Linear with an
    orthogonal weight of gain std and a zero bias. torch needs
    in_features, which flax infers; the compute dtype is the caller's
    (_linear's dtype), params stay float32."""
    layer = nn.Linear(in_features, out_features)
    orthogonal_init(std)(layer.weight, generator)
    with torch.no_grad():
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
    return torch.relu(_conv(layer, x, dtype))


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
