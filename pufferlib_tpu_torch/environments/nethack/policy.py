"""NetHack policy: char-embedding CNN + blstats embedding (counterpart of
pufferlib_tpu/environments/nethack/policy.py; reference
pufferlib/environments/nethack/torch.py:16-64).

blstats (27,) -> clip(blstats + 1, 0, 255) -> Embedding(256, 32), flat
864; chars (21, 79) -> Embedding(256, 32) -> conv 5x5 stride (2, 3), 5x5
stride (1, 3), 3x3 (32, 64, 64 channels, VALID, relu): 21 x 79 -> 9 x 25
-> 5 x 7 -> 3 x 5 x 64 = 960, flattened in NHWC order (the JAX module's,
so that proj's carried kernel reads the same features); [blstats | chars]
-> proj to hidden_size; actors and a critic. It has no encoder_features
contract, so LSTMWrapper runs it through cat.
"""
import torch
from torch import nn

from pufferlib_tpu_torch import emulation
from pufferlib_tpu_torch.models import _Heads, _nhwc_flat
from pufferlib_tpu_torch.models._layers import (
    _conv_relu, _embed, _embedding, _lecun_dense, _linear,
    _orthogonal_conv)

BLSTATS = 27
ROWS, COLS = 21, 79


class Policy(nn.Module):
    """obs_shape: the flat observation's shape; emulated: vecenv.emulated,
    whose Dict layout (blstats, chars) the encoder nativizes; None reads
    the mock layout, blstats (27,) then chars (21 * 79). dtype is the
    compute dtype of every layer; generator draws the init."""

    def __init__(self, obs_shape, action_space, emulated=None,
            hidden_size=256, dtype=torch.float32, generator=None):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.native_spec = None if emulated is None else \
            emulation.nativize_dtype(emulated)
        self.blstats_embed = _embedding(256, 32, generator)
        self.char_embed = _embedding(256, 32, generator)
        self.conv1 = _orthogonal_conv(32, 32, 5, (2, 3), generator)
        self.conv2 = _orthogonal_conv(32, 64, 5, (1, 3), generator)
        self.conv3 = _orthogonal_conv(64, 64, 3, (1, 1), generator)
        self.proj = _lecun_dense(BLSTATS * 32 + 3 * 5 * 64, hidden_size,
            generator)
        self.heads = _Heads(action_space, hidden_size, generator)

    def _dense(self, layer, x):
        return _linear(layer, x, self.dtype)

    def encode_observations(self, observations):
        batch = observations.shape[0]
        flat = observations.reshape(batch, -1)
        if self.native_spec is not None:
            x = emulation.nativize_tensor(flat, self.native_spec)
            blstats, chars = x['blstats'], x['chars']
        else:
            blstats = flat[:, :BLSTATS]
            chars = flat[:, BLSTATS:BLSTATS + ROWS * COLS].reshape(batch,
                ROWS, COLS)
        blstats = torch.clamp(blstats.to(torch.int64) + 1, 0, 255)
        bl_flat = _embed(self.blstats_embed, blstats).reshape(batch, -1)
        # (B, 21, 79, 32) NHWC -> NCHW
        ch = _embed(self.char_embed, chars.to(torch.int64)).permute(
            0, 3, 1, 2)
        for layer in (self.conv1, self.conv2, self.conv3):
            ch = _conv_relu(layer, ch, self.dtype)
        concat = torch.cat([bl_flat.to(self.dtype), _nhwc_flat(ch)], dim=1)
        return self._dense(self.proj, concat).float(), None

    def decode_actions(self, hidden, lookup=None):
        return self.heads(hidden, self._dense)

    def forward(self, observations):
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)
