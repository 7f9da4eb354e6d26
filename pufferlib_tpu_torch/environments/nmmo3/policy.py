"""NMMO3 policy: mixed-radix map decompressor + conv and embedding towers
(counterpart of pufferlib_tpu/environments/nmmo3/policy.py; reference
pufferlib/environments/nmmo3/torch.py).

Each of the 11 x 15 map codes unpacks into 10 one-hot factor blocks
(radices 4, 4, 16, 5, 3, 5, 5, 6, 7, 4: 59 channels, NHWC); conv 5x5
stride 3 and 3x3 (64 channels, VALID, relu): 11 x 15 -> 3 x 4 -> 1 x 2,
flattened in NHWC order (128) into map_fc; the 44 player features,
clipped to 0-127, embedded (128, 32) into player_fc; [map | player] ->
proj; actors and a critic.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from pufferlib_tpu_torch.models import _Heads, _nhwc_flat
from pufferlib_tpu_torch.models._layers import (
    _conv_relu, _embed, _embedding, _lecun_dense, _linear, _orthogonal_conv,
    layer_init_dense)

FACTORS = (4, 4, 16, 5, 3, 5, 5, 6, 7, 4)
N_CHANNELS = sum(FACTORS)  # 59
MAP_H, MAP_W = 11, 15
PLAYER_FEATS = 44


def decompress_map(codes):
    """(B, 11, 15) integer codes -> (B, 11, 15, 59) float32 one-hot factor
    planes: block k is one_hot((code // prod(FACTORS[:k])) % FACTORS[k])."""
    planes = []
    div = 1
    codes = codes.to(torch.int64)
    for mod in FACTORS:
        planes.append(F.one_hot((codes // div) % mod, mod).float())
        div *= mod
    return torch.cat(planes, dim=-1)


class Policy(nn.Module):
    """The flat observation: 165 map codes, then 44 player features.
    emulated is taken and unused: the env is a native PufferEnv."""

    def __init__(self, obs_shape, action_space, emulated=None,
            hidden_size=256, dtype=torch.float32, generator=None):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.hidden_size = hidden_size
        self.dtype = dtype
        half = hidden_size // 2
        self.map_conv_1 = _orthogonal_conv(N_CHANNELS, 64, 5, 3, generator)
        self.map_conv_2 = _orthogonal_conv(64, 64, 3, 1, generator)
        self.map_fc = layer_init_dense(1 * 2 * 64, half, math.sqrt(2),
            generator)
        self.player_embed = _embedding(128, 32, generator)
        self.player_fc = layer_init_dense(PLAYER_FEATS * 32, half,
            math.sqrt(2), generator)
        self.proj = _lecun_dense(2 * half, hidden_size, generator)
        self.heads = _Heads(action_space, hidden_size, generator)

    def _dense(self, layer, x):
        return _linear(layer, x, self.dtype)

    def encode_observations(self, observations):
        batch = observations.shape[0]
        flat = observations.reshape(batch, -1)
        codes = flat[:, :MAP_H * MAP_W].reshape(batch, MAP_H, MAP_W)
        player = flat[:, MAP_H * MAP_W:].to(torch.int64)

        ob_map = decompress_map(codes).permute(0, 3, 1, 2)
        ob_map = _conv_relu(self.map_conv_1, ob_map, self.dtype)
        ob_map = _conv_relu(self.map_conv_2, ob_map, self.dtype)
        ob_map = torch.relu(self._dense(self.map_fc, _nhwc_flat(ob_map)))

        ob_player = _embed(self.player_embed, torch.clamp(player, 0,
            127))
        ob_player = torch.relu(self._dense(self.player_fc,
            ob_player.reshape(batch, -1)))

        ob = torch.cat([ob_map, ob_player], dim=1)
        return self._dense(self.proj, ob).float(), None

    def decode_actions(self, hidden, lookup=None):
        return self.heads(hidden, self._dense)

    def forward(self, observations):
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)
