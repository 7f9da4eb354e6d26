"""Carry `Default` weights between the JAX package and this one.

The JAX `Policy(Default)` params are a pytree
{'params': {'encoder': {'kernel', 'bias'}, 'head': {'kernel', 'bias'}}}
of flax Dense layers. A Dense kernel is (in, out); an nn.Linear weight
is (out, in), so each kernel transposes. The fused head keeps its column
order, [decoder_0 | ... | decoder_k | value], as a row order.
Only numpy crosses between the two: pass the JAX params through
np.asarray (jax.tree.map) first.
"""
import numpy as np
import torch


def default_state_dict(params):
    """JAX Default params (numpy pytree) -> the port's Default
    state_dict (float32 CPU tensors)."""
    p = params['params'] if 'params' in params else params
    out = {}
    for layer in ('encoder', 'head'):
        kernel = np.asarray(p[layer]['kernel'], np.float32)
        bias = np.asarray(p[layer]['bias'], np.float32)
        out[f'{layer}.weight'] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        out[f'{layer}.bias'] = torch.from_numpy(bias.copy())
    return out


def default_params(state_dict):
    """The port's Default state_dict -> JAX Default params (numpy)."""
    params = {}
    for layer in ('encoder', 'head'):
        weight = state_dict[f'{layer}.weight'].detach().cpu().float().numpy()
        bias = state_dict[f'{layer}.bias'].detach().cpu().float().numpy()
        params[layer] = {'kernel': np.ascontiguousarray(weight.T),
            'bias': bias.copy()}
    return {'params': params}
