"""Neural MMO policy: tile-map embedding conv + own-entity row net
(counterpart of pufferlib_tpu/environments/nmmo/policy.py; reference
pufferlib/environments/nmmo/torch.py:20-110).

One attribute table Embedding(34 * 256, 32): attribute k of a tile or
entity row reads rows k * 256 + clip(value, 0, 255). The tile map (225,
3) is centred on the player (its x, y moved by 7 - the centre tile's),
embedded to (15, 15, 96) NHWC, conv 3x3 to 32 then 8 channels (VALID,
relu; 11 x 11 x 8 = 968, flattened in NHWC order) and tile_fc. The
player's own entity row is the first row whose id column equals AgentId
(and is not 0), a zero row where none does; its 31 attributes are
embedded and entity_fc'd. [tile | entity] -> proj_fc; decoders and a
value head. The JAX module takes the row as a one-hot contraction in the
compute dtype; here a gather of the same row, zeros where none matches:
after the clip to 0-255 both give the same integers (bf16 holds 0-256
exactly, and rounds larger values to larger values).
"""
import torch
from torch import nn

from pufferlib_tpu_torch import emulation
from pufferlib_tpu_torch.models import _Heads, _nhwc_flat
from pufferlib_tpu_torch.models._layers import (
    _conv_relu, _embedding, _lecun_dense, _linear, _orthogonal_conv)

NUM_ATTRS = 34
TILE_FEATS = 3
ENTITY_FEATS = 31


class Policy(nn.Module):
    """emulated: vecenv.emulated (its Dict of AgentId, Entity, Tile).
    input_size: the width of tile_fc, entity_fc and proj_fc;
    hidden_size: the width the decoders read (the LSTM's, input_size
    without one); entity_id_col: the id column of an entity row."""

    def __init__(self, obs_shape, action_space, emulated=None,
            input_size=256, hidden_size=256, entity_id_col=0,
            dtype=torch.float32, generator=None):
        super().__init__()
        if emulated is None:
            raise ValueError('the nmmo policy reads the emulated Dict '
                'layout: pass emulated=vecenv.emulated')
        self.obs_shape = tuple(obs_shape)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.entity_id_col = entity_id_col
        self.dtype = dtype
        self.native_spec = emulation.nativize_dtype(emulated)
        self.embedding = _embedding(NUM_ATTRS * 256, 32, generator)
        self.tile_conv_1 = _orthogonal_conv(TILE_FEATS * 32, 32, 3, 1,
            generator)
        self.tile_conv_2 = _orthogonal_conv(32, 8, 3, 1, generator)
        self.tile_fc = _lecun_dense(11 * 11 * 8, input_size, generator)
        self.entity_fc = _lecun_dense(ENTITY_FEATS * 32, input_size,
            generator)
        self.proj_fc = _lecun_dense(2 * input_size, input_size, generator)
        self.heads = _Heads(action_space, hidden_size, generator)

    def _dense(self, layer, x):
        return _linear(layer, x, self.dtype)

    def own_entity(self, entity, my_id):
        """(B, ENTITY_FEATS) int64: the first row of entity (B, rows,
        31) whose id column equals my_id (B,) and is not 0; zeros where
        none does."""
        ids = entity[:, :, self.entity_id_col]
        mask = (ids == my_id[:, None]) & (ids != 0)
        first = mask.to(torch.uint8).argmax(dim=1)
        row = torch.gather(entity, 1, first[:, None, None].expand(-1, 1,
            entity.shape[2]))[:, 0]
        return row * mask.any(dim=1, keepdim=True)

    def encode_observations(self, observations):
        batch = observations.shape[0]
        x = emulation.nativize_tensor(observations.reshape(batch, -1),
            self.native_spec)
        tile = x['Tile'].to(torch.int64)            # (B, 225, 3)
        entity = x['Entity'].to(torch.int64)        # (B, rows, 31)
        my_id = x['AgentId'].reshape(batch, -1)[:, 0].to(torch.int64)

        # centre the tile coordinates on the player (reference :57-59)
        center = tile[:, 112:113, :2]
        tile = torch.cat([tile[:, :, :2] + 7 - center, tile[:, :, 2:]],
            dim=2)
        offsets = torch.arange(TILE_FEATS, device=tile.device) * 256
        tile = self.embedding(torch.clamp(tile, 0, 255) + offsets)
        # (B, 225, 3, 32) -> (B, 15, 15, 96) NHWC -> NCHW
        tile = tile.reshape(batch, 15, 15, TILE_FEATS * 32).permute(
            0, 3, 1, 2)
        tile = _conv_relu(self.tile_conv_1, tile, self.dtype)
        tile = _conv_relu(self.tile_conv_2, tile, self.dtype)
        tile = torch.relu(self._dense(self.tile_fc, _nhwc_flat(tile)))

        ent = self.own_entity(entity, my_id)
        ent_offsets = (torch.arange(ENTITY_FEATS, device=ent.device)
            + TILE_FEATS) * 256
        ent = self.embedding(torch.clamp(ent, 0, 255) + ent_offsets)
        ent = torch.relu(self._dense(self.entity_fc, ent.reshape(batch,
            -1)))

        obs = torch.cat([tile, ent], dim=-1)
        return self._dense(self.proj_fc, obs).float(), None

    def decode_actions(self, hidden, lookup=None):
        return self.heads(hidden, self._dense)

    def forward(self, observations):
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)
