"""Model zoo in torch.nn, counterpart of pufferlib_tpu/models/__init__.py.

This port has `Default` (models/__init__.py:118-233) and `LSTMWrapper`
(:236-445); the conv family follows (ROADMAP, queue 1). Params are
float32; `dtype` is the compute dtype, as flax
`Dense(dtype=cdt, param_dtype=f32)`: each layer casts its input, weight
and bias to `dtype`.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.models.distributions import sample_logits
from pufferlib_tpu_torch.models.policy import (
    Policy, RecurrentPolicy, count_params)
from pufferlib_tpu_torch.ops.cuda.lstm_cat import (
    gate_activations, lstm_scan_cat, round_to)
from pufferlib_tpu_torch.ops.cuda.lstm_enc import lstm_scan_enc5
from pufferlib_tpu_torch.ops.cuda.mlp import mlp_head

__all__ = ['Default', 'LSTMWrapper', 'sample_logits', 'Policy',
    'RecurrentPolicy', 'count_params']

LSTM_KERNELS = ('enc5', 'cat', 'off')


def _action_info(action_space):
    """(is_multidiscrete, nvec list) for a flat (emulated) action space."""
    if isinstance(action_space, spaces.MultiDiscrete):
        return True, [int(n) for n in action_space.nvec]
    if isinstance(action_space, spaces.Discrete):
        return False, [int(action_space.n)]
    raise ValueError(f'Policies take flat action spaces, got {action_space}')


def _uniform_(t, bound, generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Default(nn.Module):
    """Flatten-obs MLP with (multi)discrete decoders and a value head, as
    one fused head `[decoder_0 | ... | decoder_k | value]`.

    init_style: 'orthogonal' (CleanRL layer_init everywhere) or 'torch'
    (torch-default kaiming-uniform encoder and value column, orthogonal
    0.01 decoders), as the JAX module's two schemes.
    use_kernel: run encoder + relu + head as one CUDA kernel
    (ops/cuda/mlp.py), the counterpart of the JAX `use_pallas=True`.
    generator: torch.Generator for the init (CPU); None uses torch's
    global one."""

    def __init__(self, obs_shape, action_space, hidden_size=128,
            dtype=torch.float32, emulated=None, use_kernel=False,
            init_style='orthogonal', generator=None):
        super().__init__()
        if emulated is not None and np.dtype(
                emulated.emulated_observation_dtype).names is not None:
            raise NotImplementedError(
                'structured (nativized) observations are not ported yet')
        if init_style not in ('orthogonal', 'torch'):
            raise ValueError(f'unknown init_style {init_style!r}')
        self.obs_shape = tuple(obs_shape)
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.init_style = init_style
        self.is_multidiscrete, self.nvec = _action_info(action_space)
        in_features = int(np.prod(self.obs_shape))
        self.encoder = nn.Linear(in_features, hidden_size)
        self.head = nn.Linear(hidden_size, sum(self.nvec) + 1)
        self._init_params(generator)

    def _init_params(self, generator):
        enc, head = self.encoder, self.head
        with torch.no_grad():
            if self.init_style == 'torch':
                bound = 1.0 / math.sqrt(enc.in_features)
                _uniform_(enc.weight, bound, generator)
                _uniform_(enc.bias, bound, generator)
            else:
                nn.init.orthogonal_(enc.weight, math.sqrt(2),
                    generator=generator)
                enc.bias.zero_()
            # fused head, block by block: orthogonal std 0.01 for each
            # decoder, then the value row
            head.bias.zero_()
            off = 0
            for n in self.nvec:
                nn.init.orthogonal_(head.weight[off:off + n], 0.01,
                    generator=generator)
                off += n
            if self.init_style == 'torch':
                bound = 1.0 / math.sqrt(head.in_features)
                _uniform_(head.weight[off:], bound, generator)
                _uniform_(head.bias[off:], bound, generator)
            else:
                nn.init.orthogonal_(head.weight[off:], 1.0,
                    generator=generator)

    def encoder_features(self, observations):
        """Pre-encoder features: flatten + cast to the compute dtype.
        Fused-kernel contract: encode_observations(x) ==
        relu(encoder_features(x) @ k + b) with (k, b) = encoder_params()."""
        return observations.reshape(observations.shape[0], -1).to(self.dtype)

    def encoder_params(self):
        """(kernel, bias) of the encoder, kernel in the JAX (in, out)
        layout."""
        return self.encoder.weight.t(), self.encoder.bias

    def _dense(self, layer, x):
        # flax Dense(dtype=cdt) casts its input too: the LSTM hands the
        # head f32 hidden states
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
            layer.bias.to(self.dtype))

    def encode_observations(self, observations):
        x = self.encoder_features(observations)
        return torch.relu(self._dense(self.encoder, x)), None

    def _split_head_out(self, out):
        """(B, sum(nvec)+1) fused head output -> (logits, value)."""
        value = out[..., -1:]
        if self.is_multidiscrete:
            logits, off = [], 0
            for n in self.nvec:
                logits.append(out[..., off:off + n])
                off += n
            return logits, value
        return out[..., :-1], value

    def decode_actions(self, hidden, lookup=None):
        return self._split_head_out(self._dense(self.head, hidden).float())

    def forward(self, observations):
        if self.use_kernel:
            # observations are constants in RL training: the kernel's
            # zero x-gradient contract, made explicit by detach
            x = self.encoder_features(observations).detach()
            w1, b1 = self.encoder_params()
            out = mlp_head(x, w1.contiguous(), b1,
                self.head.weight.t().contiguous(), self.head.bias,
                self.dtype)
            return self._split_head_out(out)
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)


class LSTMWrapper(nn.Module):
    """LSTM between the policy's encode_observations and decode_actions
    (pufferlib_tpu/models/__init__.py:236-445).

    Input x: (B, *obs_shape) [one step, T = 1], (B, T, *obs_shape), or
    with time_major=True (T, B, *obs_shape); logits and value come back
    flattened in the input's row order. State (h, c): each
    (num_layers, B, hidden_size) float32. Gate order i, f, g, o; weights
    w_ih_l{k} (in, 4H) and w_hh_l{k} (H, 4H) in the JAX (in, out) layout,
    orthogonal init with gain 1, zero bias b_l{k} (4H,).

    kernel: 'enc5' (the default), 'cat' or 'off', the counterpart of the
    JAX PUFFER_LSTM_KERNEL. use_kernel (None, True or False), the
    counterpart of use_pallas: None runs the kernels when the input lies
    on CUDA and T > 1. With the kernels on, 'enc5' fuses the policy's
    encoder into the LSTM kernel (T > 1, one layer, a policy with the
    encoder_features / encoder_params contract); otherwise every layer
    runs the 'cat' kernel with the encoder outside. On the CPU the
    kernels' plain versions run. 'off' is the plain scan with the JAX
    package's own rounding points. T == 1 is always the plain
    combined-operand step."""

    def __init__(self, policy, obs_shape, input_size=128, hidden_size=128,
            num_layers=1, dtype=torch.float32, kernel='enc5', use_kernel=None,
            generator=None):
        super().__init__()
        if kernel not in LSTM_KERNELS:
            raise ValueError(
                f'kernel must be one of {LSTM_KERNELS}, got {kernel!r}')
        self.policy = policy
        self.obs_shape = tuple(obs_shape)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.kernel = kernel
        self.use_kernel = use_kernel
        H = hidden_size
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else H
            w_ih = nn.Parameter(torch.empty(in_size, 4 * H))
            w_hh = nn.Parameter(torch.empty(H, 4 * H))
            with torch.no_grad():
                nn.init.orthogonal_(w_ih, 1.0, generator=generator)
                nn.init.orthogonal_(w_hh, 1.0, generator=generator)
            setattr(self, f'w_ih_l{layer}', w_ih)
            setattr(self, f'w_hh_l{layer}', w_hh)
            setattr(self, f'b_l{layer}', nn.Parameter(torch.zeros(4 * H)))

    def layer_params(self, layer):
        return (getattr(self, f'w_ih_l{layer}'),
            getattr(self, f'w_hh_l{layer}'), getattr(self, f'b_l{layer}'))

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        shape = (self.num_layers, batch_size, self.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, x, state=None, time_major=False):
        space_n = len(self.obs_shape)
        x_shape = tuple(x.shape)
        if x_shape[-space_n:] != self.obs_shape:
            raise ValueError(f'Invalid input tensor shape {x_shape}')
        if len(x_shape) == space_n + 1:
            B, T = x_shape[0], 1
            time_major = False
        elif len(x_shape) == space_n + 2:
            T, B = x_shape[:2] if time_major else x_shape[1::-1]
        else:
            raise ValueError(f'Invalid input tensor shape {x_shape}')

        use_kernel = self.use_kernel
        if use_kernel is None:
            use_kernel = x.device.type == 'cuda' and T > 1
        kind = self.kernel if use_kernel else 'off'
        use_kernel = kind != 'off'
        fuse_enc = (kind == 'enc5' and T > 1 and self.num_layers == 1
            and hasattr(self.policy, 'encoder_features')
            and hasattr(self.policy, 'encoder_params'))

        lead = (T, B) if time_major else (B, T)
        x = x.reshape((B * T,) + self.obs_shape)
        if fuse_enc:
            # observations are constants in RL training: detach makes the
            # kernel's zero feats-gradient contract explicit
            feats = self.policy.encoder_features(x).detach()
            lookup = None
            hidden = feats.reshape(lead + (feats.shape[-1],))
        else:
            hidden, lookup = self.policy.encode_observations(x)
            if tuple(hidden.shape) != (B * T, self.input_size):
                raise ValueError(f'policy encoder emits {tuple(hidden.shape)}'
                    f', expected ({B * T}, {self.input_size})')
            hidden = hidden.reshape(lead + (self.input_size,))

        H, cdt = self.hidden_size, self.dtype
        if state is None:
            h0, c0 = self.initial_state(B, device=x.device)
        else:
            h0, c0 = state

        def to_tm(v):
            return v if time_major else v.transpose(0, 1)

        hs, cs = [], []
        layer_in = hidden
        for layer in range(self.num_layers):
            w_ih, w_hh, b = self.layer_params(layer)
            h_l, c_l = h0[layer].float(), c0[layer].float()
            if T == 1:
                h_fin, c_fin = self._step(
                    layer_in[0] if time_major else layer_in[:, 0],
                    h_l, c_l, w_ih, w_hh, b)
                layer_in = h_fin[None] if time_major else h_fin[:, None]
            elif use_kernel and fuse_enc and layer == 0:
                w_enc, b_enc = self.policy.encoder_params()
                if w_enc.shape[-1] != self.input_size:
                    raise ValueError(f'policy encoder emits {w_enc.shape[-1]}'
                        f' features but input_size={self.input_size}')
                outs, h_fin, c_fin = lstm_scan_enc5(
                    to_tm(layer_in).to(cdt).contiguous(), h_l.contiguous(),
                    c_l.contiguous(), w_enc.contiguous(), b_enc, w_ih, w_hh,
                    b, cdt)
                layer_in = to_tm(outs)
            elif use_kernel:
                outs, h_fin, c_fin = lstm_scan_cat(
                    to_tm(layer_in).to(cdt).contiguous(), h_l.contiguous(),
                    c_l.contiguous(), w_ih, w_hh, b, cdt)
                layer_in = to_tm(outs)
            else:
                outs, h_fin, c_fin = self._scan_off(to_tm(layer_in), h_l,
                    c_l, w_ih, w_hh, b)
                layer_in = to_tm(outs)
            hs.append(h_fin)
            cs.append(c_fin)

        new_state = (torch.stack(hs), torch.stack(cs))
        flat = layer_in.reshape(B * T, H)
        logits, value = self.policy.decode_actions(flat, lookup)
        return logits, value, new_state

    def _step(self, x, h, c, w_ih, w_hh, b):
        """One cell step, [x | h] @ [W_ih; W_hh] on cdt-rounded operands
        with f32 accumulation and f32 gates (models/__init__.py:354-379)."""
        cdt = self.dtype
        xh = torch.cat([round_to(x, cdt), round_to(h, cdt)], dim=-1)
        w_cat = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
        i, f, g, o = gate_activations(xh @ w_cat + b.float(),
            self.hidden_size)
        c = f * c + i * g
        return o * torch.tanh(c), c

    def _scan_off(self, x, h, c, w_ih, w_hh, b):
        """The plain scan over x (T, B, in) with the JAX 'off' rounding
        points (models/__init__.py:416-433): the input projection plus
        bias, and h @ W_hh, each rounded to cdt before the f32 add."""
        cdt, H = self.dtype, self.hidden_size
        xp = (round_to(x, cdt) @ round_to(w_ih, cdt)).to(cdt) + b.to(cdt)
        w_hh_c = round_to(w_hh, cdt)
        outs = []
        for t in range(x.shape[0]):
            gates = xp[t].float() + (round_to(h, cdt) @ w_hh_c).to(cdt).float()
            i, f, g, o = gate_activations(gates, H)
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), h, c
