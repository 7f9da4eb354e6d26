"""Carry `Default`, `Convolutional`, `ProcgenResnet`, `LSTMWrapper`,
`TransformerWrapper` and the zoo policies' (nethack, nmmo, nmmo3) weights
between the JAX package and this one.

The JAX `Policy(Default)` params are a pytree
{'params': {'encoder': {'kernel', 'bias'}, 'head': {'kernel', 'bias'}}}
of flax Dense layers. A Dense kernel is (in, out); an nn.Linear weight
is (out, in), so each kernel transposes. The fused head keeps its column
order, [decoder_0 | ... | decoder_k | value], as a row order.
A flax Conv kernel is (kh, kw, in, out) (HWIO); an nn.Conv2d weight is
(out, in, kh, kw) (OIHW). The conv policies flatten their features in
the JAX modules' NHWC order, so fc's kernel only transposes. A flax
Embed's `embedding` (num, features) is an nn.Embedding's `weight` as it is.
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


def _heads(n, value_name, actor_name='actor_'):
    """(flax path, torch name, kind) of the n decoders and the value head
    of a policy with _Heads (the conv and zoo policies)."""
    return [((f'{actor_name}{i}',), f'heads.actors.{i}', 'dense')
        for i in range(n)] + [((value_name,), 'heads.value', 'dense')]


def convolutional_layers(nvec):
    """Layer map of Convolutional with len(nvec) decoders."""
    return [((f'conv{i + 1}',), f'convs.{i}', 'conv') for i in range(3)] + [
        (('fc',), 'fc', 'dense')] + _heads(len(nvec), 'value_fn')


def procgen_layers(nvec):
    """Layer map of ProcgenResnet with len(nvec) decoders."""
    layers = []
    for i in range(3):
        layers.append(((f'seq_{i}', 'Conv_0'), f'sequences.{i}.conv', 'conv'))
        for j in range(2):
            for k in range(2):
                layers.append(((f'seq_{i}', f'_ResidualBlock_{j}',
                    f'Conv_{k}'), f'sequences.{i}.res.{j}.conv{k}', 'conv'))
    return layers + [(('fc',), 'fc', 'dense')] + _heads(len(nvec), 'value')


def _kernel_to_torch(kernel, kind):
    return kernel.transpose(3, 2, 0, 1) if kind == 'conv' else kernel.T


def _kernel_to_flax(weight, kind):
    return weight.transpose(2, 3, 1, 0) if kind == 'conv' else weight.T


def layers_state_dict(params, layers):
    """JAX params (numpy pytree) -> the port's state_dict, by a layer map
    (convolutional_layers, procgen_layers, zoo_layers)."""
    p = params['params'] if 'params' in params else params
    out = {}
    for path, name, kind in layers:
        node = p
        for key in path:
            node = node[key]
        if kind == 'embed':
            out[f'{name}.weight'] = torch.from_numpy(np.array(
                node['embedding'], np.float32))
            continue
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
        if kind == 'embed':
            node['embedding'] = weight.copy()
            continue
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


def lstm_params(state_dict, policy_params=default_params):
    """The port's LSTMWrapper state_dict -> JAX LSTMWrapper params
    (numpy); the nested policy's through policy_params (Default's by
    default)."""
    inner = {k[len('policy.'):]: v for k, v in state_dict.items()
        if k.startswith('policy.')}
    params = {'policy': policy_params(inner)['params']}
    for k, v in state_dict.items():
        if not k.startswith('policy.'):
            params[k] = v.detach().cpu().float().numpy().copy()
    return {'params': params}


# The zoo policies: (flax path, torch name, kind) of their fixed layers,
# and the flax names of their decoders and value head (torch: _Heads')
_ZOO = {
    'nethack': ([(('blstats_embed',), 'blstats_embed', 'embed'),
        (('char_embed',), 'char_embed', 'embed')] + [((f'conv{i}',),
        f'conv{i}', 'conv') for i in (1, 2, 3)] + [(('proj',), 'proj',
        'dense')], 'actor_', 'critic'),
    'nmmo': ([(('embedding',), 'embedding', 'embed'),
        (('tile_conv_1',), 'tile_conv_1', 'conv'),
        (('tile_conv_2',), 'tile_conv_2', 'conv')] + [((name,), name,
        'dense') for name in ('tile_fc', 'entity_fc', 'proj_fc')],
        'decoder_', 'value_head'),
    'nmmo3': ([(('map_conv_1',), 'map_conv_1', 'conv'),
        (('map_conv_2',), 'map_conv_2', 'conv'),
        (('map_fc',), 'map_fc', 'dense'),
        (('player_embed',), 'player_embed', 'embed'),
        (('player_fc',), 'player_fc', 'dense'),
        (('proj',), 'proj', 'dense')], 'actor_', 'critic'),
}


def zoo_layers(policy, n_actions):
    """Layer map of a zoo policy ('nethack', 'nmmo' or 'nmmo3') with
    n_actions decoders."""
    fixed, flax_actor, flax_value = _ZOO[policy]
    return fixed + _heads(n_actions, flax_value, flax_actor)


def _zoo_state_dict(policy, params):
    p = params['params'] if 'params' in params else params
    n = sum(1 for k in p if k.startswith(_ZOO[policy][1]))
    return layers_state_dict(p, zoo_layers(policy, n))


def _zoo_params(policy, state_dict):
    n = len({k.split('.')[2] for k in state_dict
        if k.startswith('heads.actors.')})
    return layers_params(state_dict, zoo_layers(policy, n))


def nethack_state_dict(params):
    """JAX nethack Policy params (numpy pytree) -> the port's state_dict
    (compose with lstm_state_dict(params, policy_state_dict=...) under
    LSTMWrapper)."""
    return _zoo_state_dict('nethack', params)


def nethack_params(state_dict):
    """The port's nethack Policy state_dict -> JAX params (numpy)."""
    return _zoo_params('nethack', state_dict)


def nmmo_state_dict(params):
    """JAX nmmo Policy params (numpy pytree) -> the port's state_dict."""
    return _zoo_state_dict('nmmo', params)


def nmmo_params(state_dict):
    """The port's nmmo Policy state_dict -> JAX params (numpy)."""
    return _zoo_params('nmmo', state_dict)


def nmmo3_state_dict(params):
    """JAX nmmo3 Policy params (numpy pytree) -> the port's state_dict."""
    return _zoo_state_dict('nmmo3', params)


def nmmo3_params(state_dict):
    """The port's nmmo3 Policy state_dict -> JAX params (numpy)."""
    return _zoo_params('nmmo3', state_dict)


# TransformerWrapper's FFN, flax Dense layers as nn.Linear
_FFN_LAYERS = [(('ffn_in',), 'ffn_in', 'dense'),
    (('ffn_out',), 'ffn_out', 'dense')]
_ATTENTION = ('wq', 'wk', 'wv', 'wo', 'rel_bias')


def transformer_state_dict(params, policy_state_dict=default_state_dict):
    """JAX TransformerWrapper params (numpy pytree) -> the port's
    TransformerWrapper state_dict. The nested policy goes through
    policy_state_dict (Default's by default); wq, wk, wv, wo (in, out in
    both packages) and rel_bias copy as they are; LayerNorm scale is
    weight; the FFN kernels transpose."""
    p = params['params'] if 'params' in params else params
    out = {f'policy.{k}': v for k, v in policy_state_dict(
        p['policy']).items()}
    for name in _ATTENTION:
        out[name] = torch.from_numpy(np.array(p[name], np.float32))
    for name in ('ln_kv', 'ln_ffn'):
        out[f'{name}.weight'] = torch.from_numpy(np.array(
            p[name]['scale'], np.float32))
        out[f'{name}.bias'] = torch.from_numpy(np.array(p[name]['bias'],
            np.float32))
    out.update(layers_state_dict(p, _FFN_LAYERS))
    return out


def transformer_params(state_dict):
    """The port's TransformerWrapper state_dict -> JAX
    TransformerWrapper(Default) params (numpy)."""
    def numpy(name):
        return state_dict[name].detach().cpu().float().numpy().copy()
    inner = {k[len('policy.'):]: v for k, v in state_dict.items()
        if k.startswith('policy.')}
    params = {'policy': default_params(inner)['params']}
    for name in _ATTENTION:
        params[name] = numpy(name)
    for name in ('ln_kv', 'ln_ffn'):
        params[name] = {'scale': numpy(f'{name}.weight'),
            'bias': numpy(f'{name}.bias')}
    params.update(layers_params(state_dict, _FFN_LAYERS)['params'])
    return {'params': params}
