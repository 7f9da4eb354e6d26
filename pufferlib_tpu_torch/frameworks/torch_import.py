"""Reference PufferLib policy checkpoints in the port's layout, and back
(counterpart of pufferlib_tpu/frameworks/torch_import.py).

The reference saves whole policy modules or their state_dicts
(`model_{epoch:06d}.pt`, reference clean_pufferl.py:509-530). Its
`Default` / `LSTMWrapper(Default)` (reference models.py:12-111) differ
from the port's in three places:
- the decoder head(s) and `value_head` are separate Linears; the port's
  `Default.head` is one Linear, `[logit blocks | value]`, row for row;
- torch's nn.LSTM keeps two biases and (4H, in) weights; the port's
  LSTMWrapper keeps one bias `b_l{k}` = bias_ih + bias_hh and (in, 4H)
  weights `w_ih_l{k}` / `w_hh_l{k}`, with the same i, f, g, o gate order;
- torch.compile's `_orig_mod.` prefix, and the reference cleanrl
  wrapper's `policy.` prefix, wrap the keys.
convert gives the keys of the port's Default or LSTMWrapper(Default)
(with wrapper=True those of Policy / RecurrentPolicy around them), so
that load_state_dict(strict=True) takes them; export goes back.
"""
import torch

_COMPILE_PREFIX = '_orig_mod.'
_WRAPPER_PREFIX = 'module.'


def _tensor(state_dict, key):
    """A state_dict entry as a float32 CPU tensor of its own."""
    return torch.as_tensor(state_dict[key]).detach().to('cpu',
        torch.float32).clone()


def _strip_compile_prefix(state_dict):
    """torch.compile wraps modules as _orig_mod.* (the reference saves the
    uncompiled module, but user code may not)."""
    return {k[len(_COMPILE_PREFIX):] if k.startswith(_COMPILE_PREFIX)
        else k: v for k, v in state_dict.items()}


def _unwrap(state_dict):
    """The keys without torch.compile's prefix and without the reference
    cleanrl (Recurrent)Policy's `policy.` level, which is there where no
    key starts with encoder. or recurrent."""
    sd = _strip_compile_prefix(dict(state_dict))
    if not any(k.startswith(('encoder.', 'recurrent.')) for k in sd):
        inner = {k[len('policy.'):]: v for k, v in sd.items()
            if k.startswith('policy.')}
        if inner:
            sd = inner
    return sd


def is_reference(state_dict):
    """Whether the keys are a reference Default or LSTMWrapper(Default)
    state_dict (an encoder beside a value_head, under `policy.` where
    there is a recurrent.* LSTM), in any of the wrappings convert takes.
    The port's own layouts have no value_head beside an encoder."""
    sd = _unwrap(state_dict)
    pre = 'policy.' if any(k.startswith('recurrent.') for k in sd) else ''
    return f'{pre}encoder.weight' in sd and f'{pre}value_head.weight' in sd


def convert_default(state_dict, prefix=''):
    """Reference `Default` state_dict (its keys under `prefix`) -> the
    port's Default state_dict (same hidden size and action space)."""
    sd = _strip_compile_prefix(dict(state_dict))
    # decoder: one Linear (Discrete) or a ModuleList (MultiDiscrete)
    if f'{prefix}decoder.weight' in sd:
        dec_ws = [_tensor(sd, f'{prefix}decoder.weight')]
        dec_bs = [_tensor(sd, f'{prefix}decoder.bias')]
    else:
        dec_ws, dec_bs = [], []
        i = 0
        while f'{prefix}decoder.{i}.weight' in sd:
            dec_ws.append(_tensor(sd, f'{prefix}decoder.{i}.weight'))
            dec_bs.append(_tensor(sd, f'{prefix}decoder.{i}.bias'))
            i += 1
        if not dec_ws:
            raise ValueError(
                f'no decoder weights under prefix {prefix!r}; keys: '
                f'{sorted(sd)[:10]}...')
    return {
        'encoder.weight': _tensor(sd, f'{prefix}encoder.weight'),
        'encoder.bias': _tensor(sd, f'{prefix}encoder.bias'),
        # (sum(nvec) + 1, H): the decoders' rows, then the value's
        'head.weight': torch.cat(dec_ws + [_tensor(sd,
            f'{prefix}value_head.weight')]),
        'head.bias': torch.cat(dec_bs + [_tensor(sd,
            f'{prefix}value_head.bias')]),
    }


def convert_lstm(state_dict):
    """Reference `LSTMWrapper(Default)` state_dict -> the port's
    LSTMWrapper(Default) state_dict."""
    sd = _strip_compile_prefix(dict(state_dict))
    out = {f'policy.{k}': v for k, v in
        convert_default(sd, prefix='policy.').items()}
    layer = 0
    while f'recurrent.weight_ih_l{layer}' in sd:
        out[f'w_ih_l{layer}'] = _tensor(sd,
            f'recurrent.weight_ih_l{layer}').t().contiguous()
        out[f'w_hh_l{layer}'] = _tensor(sd,
            f'recurrent.weight_hh_l{layer}').t().contiguous()
        out[f'b_l{layer}'] = (_tensor(sd, f'recurrent.bias_ih_l{layer}')
            + _tensor(sd, f'recurrent.bias_hh_l{layer}'))
        layer += 1
    if layer == 0:
        raise ValueError('no recurrent.* weights found: not an '
            'LSTMWrapper checkpoint (use convert_default)')
    return out


def convert(state_dict_or_module, wrapper=False):
    """A reference policy (module, cleanrl wrapper, or state_dict) -> the
    port's Default or LSTMWrapper(Default) state_dict, the layout told
    by the keys; wrapper=True gives the keys of the port's Policy /
    RecurrentPolicy around it (`module.`)."""
    sd = state_dict_or_module
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    sd = _unwrap(sd)
    out = convert_lstm(sd) if any(k.startswith('recurrent.') for k in sd) \
        else convert_default(sd)
    if wrapper:
        out = {_WRAPPER_PREFIX + k: v for k, v in out.items()}
    return out


def read(path):
    """The object a reference `model_*.pt` holds: a state_dict, or a
    pickled module, read with weights_only=False as the reference saves
    it (so it runs whatever the pickle says: only read files you trust).
    Unpickling a module needs the package that defined it, the reference
    `pufferlib`, importable: where it is not, the ImportError names it."""
    try:
        return torch.load(path, map_location='cpu', weights_only=False)
    except ModuleNotFoundError as e:
        raise ImportError(f'{path} holds a pickled module of package '
            f'{e.name!r}, which is not importable: reading it needs the '
            f'reference package that defined it', name=e.name) from e


def load_pt(path):
    """convert of a reference `model_*.pt` file (saved module or
    state_dict). A saved module is unpickled: only load files you
    trust."""
    return convert(read(path))


def export(state_dict, nvec=None):
    """The port's Default or LSTMWrapper(Default) state_dict (also as
    Policy / RecurrentPolicy hold it, under `module.`) -> a reference
    layout state_dict, so that policies trained here load into the
    reference torch modules (`module.load_state_dict(export(sd, nvec))`).

    nvec: per-head action counts for splitting the fused head back into
    the reference's decoder ModuleList; None or one entry emits the
    single `decoder.weight` layout."""
    p = {k[len(_WRAPPER_PREFIX):] if k.startswith(_WRAPPER_PREFIX) else k:
        torch.as_tensor(v).detach().to('cpu', torch.float32)
        for k, v in state_dict.items()}
    recurrent = any(k.startswith('w_ih_l') for k in p)
    pre = 'policy.' if recurrent else ''
    sd = {}
    sd[f'{pre}encoder.weight'] = p[f'{pre}encoder.weight']
    sd[f'{pre}encoder.bias'] = p[f'{pre}encoder.bias']
    head_w = p[f'{pre}head.weight']  # (sum(nvec) + 1, H)
    head_b = p[f'{pre}head.bias']
    if nvec is None:
        nvec = [head_w.shape[0] - 1]
    if sum(nvec) + 1 != head_w.shape[0]:
        raise ValueError(f'nvec {nvec} does not tile the fused head '
            f'({head_w.shape[0]} = sum(nvec) + 1 expected)')
    off = 0
    for i, n in enumerate(nvec):
        key = f'{pre}decoder.' + (f'{i}.' if len(nvec) > 1 else '')
        sd[key + 'weight'] = head_w[off:off + n]
        sd[key + 'bias'] = head_b[off:off + n]
        off += n
    sd[f'{pre}value_head.weight'] = head_w[-1:]
    sd[f'{pre}value_head.bias'] = head_b[-1:]
    layer = 0
    while recurrent and f'w_ih_l{layer}' in p:
        sd[f'recurrent.weight_ih_l{layer}'] = p[f'w_ih_l{layer}'].t()
        sd[f'recurrent.weight_hh_l{layer}'] = p[f'w_hh_l{layer}'].t()
        # torch keeps two bias vectors; their sum is what the cell adds
        sd[f'recurrent.bias_ih_l{layer}'] = p[f'b_l{layer}']
        sd[f'recurrent.bias_hh_l{layer}'] = torch.zeros_like(
            p[f'b_l{layer}'])
        layer += 1
    return {k: v.contiguous().clone() for k, v in sd.items()}
