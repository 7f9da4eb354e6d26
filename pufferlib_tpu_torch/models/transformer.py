"""Sliding-window causal self-attention policy wrapper, counterpart of
pufferlib_tpu/models/transformer.py.

`TransformerWrapper` has `LSTMWrapper`'s contract: inputs (B, *obs) [one
step, T = 1], (B, T, *obs) or with time_major=True (T, B, *obs), output
rows in the input's flattening order, a 2-tuple state, and the policy's
encode_observations / decode_actions around it. The state is a window of
the last `window` encodings, (window, B, H) ordered oldest to newest,
and an unused (1, B, H) slot (`aux`): the trainer stores the two as
`lstm0_h` / `lstm0_c` whatever their leading sizes. Episode ends do not
reset the window, as the LSTM's state is not reset.

A segment of T steps is one banded causal attention over
concat(window, encodings); query i sees its W window slots and itself,
with a learned per-head bias for each recency distance 0..W. So T calls
of one step and one call of T steps give the same outputs (the PPO
update recomputes the rollout's logprobs from stored windows):
tests/test_torch_transformer.py holds both to the JAX module.

The rounding points are the JAX module's (transformer.py:86-153):
LayerNorm (epsilon 1e-6, flax's) and the residual stream in f32; the q,
k, v and output products and the scores in the compute dtype, the
scores then in f32, scaled by 1 / sqrt(head width), biased, masked with
-inf and softmaxed in f32; the FFN's Linear layers as flax
Dense(dtype=cdt). The attention runs on plain torch ops (matmul,
softmax), as the JAX package runs it on XLA: there is no TPU kernel in
this family to port.

One difference, the port's side of the JAX module's state dtype fault:
the new window comes back in the dtype of the window that came in (the
JAX module returns it in the encoder's dtype, so a bf16 encoder turns
an f32 initial state into a bf16 one). bf16 to f32 is exact, so the
values are the JAX module's.
"""
import math

import torch
from torch import nn

from pufferlib_tpu_torch.models._layers import _linear, _orthogonal_dense
from pufferlib_tpu_torch.models.policy import RecurrentPolicy

__all__ = ['TransformerWrapper', 'TransformerPolicy']


class TransformerWrapper(nn.Module):
    """Windowed causal self-attention between the policy's
    encode_observations and decode_actions.

    Parameters in the JAX layout: wq, wk, wv, wo (H, H) as (in, out),
    orthogonal with gain 1; rel_bias (num_heads, window + 1), zeros;
    ln_kv and ln_ffn LayerNorm(H, eps=1e-6); ffn_in (H -> ffn_mult * H)
    and ffn_out Linear layers, orthogonal with gain sqrt(2), zero bias.
    dtype is the compute dtype; params are float32. generator: the
    init's torch.Generator (CPU); None uses torch's global one."""

    def __init__(self, policy, obs_shape, input_size=128, hidden_size=128,
            window=16, num_heads=4, ffn_mult=2, dtype=torch.float32,
            generator=None):
        super().__init__()
        if input_size != hidden_size:
            raise ValueError('TransformerWrapper needs input_size == '
                f'hidden_size (residual stream), got {input_size} and '
                f'{hidden_size}')
        if hidden_size % num_heads:
            raise ValueError(f'hidden_size {hidden_size} must divide into '
                f'num_heads {num_heads}')
        self.policy = policy
        self.obs_shape = tuple(obs_shape)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.window = window
        self.num_heads = num_heads
        self.ffn_mult = ffn_mult
        self.dtype = dtype
        H = hidden_size
        self.ln_kv = nn.LayerNorm(H, eps=1e-6)
        for name in ('wq', 'wk', 'wv', 'wo'):
            w = nn.Parameter(torch.empty(H, H))
            with torch.no_grad():
                nn.init.orthogonal_(w, 1.0, generator=generator)
            setattr(self, name, w)
        self.rel_bias = nn.Parameter(torch.zeros(num_heads, window + 1))
        self.ln_ffn = nn.LayerNorm(H, eps=1e-6)
        self.ffn_in = _orthogonal_dense(H, ffn_mult * H, math.sqrt(2),
            generator)
        self.ffn_out = _orthogonal_dense(ffn_mult * H, H, math.sqrt(2),
            generator)
        self._bands = {}

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        H = self.hidden_size
        return (torch.zeros((self.window, batch_size, H), dtype=dtype,
                device=device),
            torch.zeros((1, batch_size, H), dtype=dtype, device=device))

    def _band(self, T, device):
        """(recency index clip(d, 0, W), allowed 0 <= d <= W) of query i
        against concat position j, d = W + i - j: (T, W + T) each."""
        key = (T, str(device))
        if key not in self._bands:
            W = self.window
            d = (W + torch.arange(T, device=device)[:, None]
                - torch.arange(W + T, device=device)[None, :])
            self._bands[key] = (d.clamp(0, W), (d >= 0) & (d <= W))
        return self._bands[key]

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
        H, W, nh, cdt = (self.hidden_size, self.window, self.num_heads,
            self.dtype)
        dh = H // nh

        hidden, lookup = self.policy.encode_observations(
            x.reshape((B * T,) + self.obs_shape))
        if tuple(hidden.shape) != (B * T, H):
            raise ValueError(f'policy encoder emits {tuple(hidden.shape)}, '
                f'expected ({B * T}, {H})')
        # the internal layout is time-major (T, B, H)
        if time_major or T == 1:
            e = hidden.reshape(T, B, H)
        else:
            e = hidden.reshape(B, T, H).transpose(0, 1)

        if state is None:
            mem = e.new_zeros((W, B, H))
            aux = e.new_zeros((1, B, H))
        else:
            mem, aux = state
        state_dtype = mem.dtype

        kv_src = torch.cat([mem.to(e.dtype), e], dim=0)      # (W+T, B, H)
        normed = self.ln_kv(kv_src.float())

        def proj(v, w):
            return v.to(cdt) @ w.to(cdt)

        def heads(v):                                        # (B, nh, S, dh)
            return v.reshape(v.shape[0], B, nh, dh).permute(1, 2, 0, 3)

        q = heads(proj(normed[W:], self.wq))
        k = heads(proj(normed, self.wk))
        v = heads(proj(normed, self.wv))
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(dh)
        index, allowed = self._band(T, x.device)
        scores = scores + self.rel_bias[:, index][None]
        scores = scores.masked_fill(~allowed, -math.inf)
        attn = torch.softmax(scores, dim=-1)
        ctx = attn.to(cdt) @ v                               # (B, nh, T, dh)
        ctx = ctx.permute(2, 0, 1, 3).reshape(T, B, H)
        a = e.float() + proj(ctx, self.wo).float()
        ffn = torch.relu(_linear(self.ffn_in, self.ln_ffn(a), cdt))
        out = a + _linear(self.ffn_out, ffn, cdt).float()

        # the window keeps its slots oldest to newest: the last W rows of
        # concat(window, encodings), as T one-step shifts would leave it
        new_state = (kv_src[T:].to(state_dtype), torch.zeros_like(aux))

        if time_major or T == 1:
            flat = out.reshape(T * B, H)
        else:
            flat = out.transpose(0, 1).reshape(B * T, H)
        logits, value = self.policy.decode_actions(flat.to(cdt), lookup)
        return logits, value, new_state


class TransformerPolicy(RecurrentPolicy):
    """RecurrentPolicy around a TransformerWrapper: its initial_state is
    the module's (window, B, H) / (1, B, H) pair. `lstm` stays the module,
    so the trainers take it as a recurrent policy."""
