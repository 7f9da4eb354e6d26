"""Model zoo in torch.nn, counterpart of pufferlib_tpu/models/__init__.py.

This slice ports `Default` (models/__init__.py:118-233); LSTMWrapper and
the conv family follow (ROADMAP, queue 1). Params are float32; `dtype`
is the compute dtype, as flax `Dense(dtype=cdt, param_dtype=f32)`: each
layer casts its input, weight and bias to `dtype`.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.models.distributions import sample_logits
from pufferlib_tpu_torch.models.policy import Policy, count_params
from pufferlib_tpu_torch.ops.cuda.mlp import mlp_head

__all__ = ['Default', 'sample_logits', 'Policy', 'count_params']


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
        return F.linear(x, layer.weight.to(self.dtype),
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
