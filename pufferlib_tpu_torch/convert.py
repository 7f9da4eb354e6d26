"""Carry `Default`, `Convolutional`, `ProcgenResnet` and `LSTMWrapper`
weights between the JAX package and this one.

The JAX `Policy(Default)` params are a pytree
{'params': {'encoder': {'kernel', 'bias'}, 'head': {'kernel', 'bias'}}}
of flax Dense layers. A Dense kernel is (in, out); an nn.Linear weight
is (out, in), so each kernel transposes. The fused head keeps its column
order, [decoder_0 | ... | decoder_k | value], as a row order.
A flax Conv kernel is (kh, kw, in, out) (HWIO); an nn.Conv2d weight is
(out, in, kh, kw) (OIHW). The conv policies flatten their features in
the JAX modules' NHWC order, so fc's kernel only transposes.
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


def _heads(nvec, value_name):
    """(flax path, torch name, kind) of the conv policies' decoders and
    value head."""
    return [((f'actor_{i}',), f'heads.actors.{i}', 'dense')
        for i in range(len(nvec))] + [((value_name,), 'heads.value', 'dense')]


def convolutional_layers(nvec):
    """Layer map of Convolutional with len(nvec) decoders."""
    return [((f'conv{i + 1}',), f'convs.{i}', 'conv') for i in range(3)] + [
        (('fc',), 'fc', 'dense')] + _heads(nvec, 'value_fn')


def procgen_layers(nvec):
    """Layer map of ProcgenResnet with len(nvec) decoders."""
    layers = []
    for i in range(3):
        layers.append(((f'seq_{i}', 'Conv_0'), f'sequences.{i}.conv', 'conv'))
        for j in range(2):
            for k in range(2):
                layers.append(((f'seq_{i}', f'_ResidualBlock_{j}',
                    f'Conv_{k}'), f'sequences.{i}.res.{j}.conv{k}', 'conv'))
    return layers + [(('fc',), 'fc', 'dense')] + _heads(nvec, 'value')


def _kernel_to_torch(kernel, kind):
    return kernel.transpose(3, 2, 0, 1) if kind == 'conv' else kernel.T


def _kernel_to_flax(weight, kind):
    return weight.transpose(2, 3, 1, 0) if kind == 'conv' else weight.T


def layers_state_dict(params, layers):
    """JAX params (numpy pytree) -> the port's state_dict, by a layer map
    (convolutional_layers, procgen_layers)."""
    p = params['params'] if 'params' in params else params
    out = {}
    for path, name, kind in layers:
        node = p
        for key in path:
            node = node[key]
        kernel = np.asarray(node['kernel'], np.float32)
        out[f'{name}.weight'] = torch.from_numpy(np.array(
            _kernel_to_torch(kernel, kind), order='C'))
        out[f'{name}.bias'] = torch.from_numpy(np.array(node['bias'],
            np.float32))
    return out


def layers_params(state_dict, layers):
    """The port's state_dict -> JAX params (numpy), by a layer map."""
    params = {}
    for path, name, kind in layers:
        node = params
        for key in path:
            node = node.setdefault(key, {})
        weight = state_dict[f'{name}.weight'].detach().cpu().float().numpy()
        node['kernel'] = np.ascontiguousarray(_kernel_to_flax(weight, kind))
        node['bias'] = state_dict[f'{name}.bias'].detach().cpu().float(
            ).numpy().copy()
    return {'params': params}


def lstm_state_dict(params, policy_state_dict=default_state_dict):
    """JAX LSTMWrapper params (numpy pytree) -> the port's LSTMWrapper
    state_dict. The nested policy's layers go through policy_state_dict
    (Default's by default; a conv policy's: functools.partial of
    layers_state_dict with its layer map); the LSTM weights keep the
    (in, out) layout of both packages and copy as they are."""
    p = params['params'] if 'params' in params else params
    out = {f'policy.{k}': v for k, v in policy_state_dict(
        p['policy']).items()}
    for k, v in p.items():
        if k != 'policy':
            out[k] = torch.from_numpy(np.array(v, np.float32))
    return out


def lstm_params(state_dict):
    """The port's LSTMWrapper state_dict -> JAX LSTMWrapper(Default)
    params (numpy)."""
    inner = {k[len('policy.'):]: v for k, v in state_dict.items()
        if k.startswith('policy.')}
    params = {'policy': default_params(inner)['params']}
    for k, v in state_dict.items():
        if not k.startswith('policy.'):
            params[k] = v.detach().cpu().float().numpy().copy()
    return {'params': params}
