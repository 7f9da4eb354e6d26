"""Mock environment suite: episodes of observations drawn over a
cartesian product of observation x action spaces.

Counterpart of pufferlib_tpu/environments/test/environment.py (without
its host fixtures, host_fixtures.py, which come with the host path).
MOCK_OBSERVATION_SPACES x MOCK_ACTION_SPACES, NetHack- and NMMO-scale Dict
spaces among them, are the central fixture of the emulation tests.

An episode's observations come in as the reset draws: (N, L + 1, numel),
each lane's observations at ticks 0..L already flattened per the emulation
layer, so that a test can inject the observations another implementation
made. sample_space draws them.
"""
import numpy as np
import torch

from pufferlib_tpu_torch import emulation, spaces
from pufferlib_tpu_torch.environment import PufferEnv, Step


MOCK_OBSERVATION_SPACES = {
    'box_float': spaces.Box(low=-1, high=1, shape=(4,), dtype=np.float32),
    'image_u8': spaces.Box(low=0, high=255, shape=(3, 8, 8),
        dtype=np.uint8),
    'dict_uniform': spaces.Dict({
        'a': spaces.Box(low=0, high=1, shape=(3,), dtype=np.float32),
        'b': spaces.Box(low=0, high=1, shape=(2, 2), dtype=np.float32),
    }),
    'dict_mixed': spaces.Dict({
        'image': spaces.Box(low=0, high=255, shape=(4, 4), dtype=np.uint8),
        'flat': spaces.Box(low=-128, high=127, shape=(6,), dtype=np.int8),
        'deep': spaces.Dict({
            'x': spaces.Box(low=0, high=1, shape=(2,), dtype=np.float32),
        }),
    }),
    'tuple_nested': spaces.Tuple([
        spaces.Box(low=0, high=1, shape=(3,), dtype=np.float32),
        spaces.Tuple([
            spaces.Box(low=0, high=1, shape=(2,), dtype=np.float32),
            spaces.Box(low=0, high=255, shape=(2,), dtype=np.uint8),
        ]),
    ]),
    # nethack-like: chars/colors grids + stats vector
    'nethack_like': spaces.Dict({
        'blstats': spaces.Box(low=-2**15, high=2**15 - 1, shape=(27,),
            dtype=np.int32),
        'chars': spaces.Box(low=0, high=255, shape=(21, 79),
            dtype=np.uint8),
        'colors': spaces.Box(low=0, high=15, shape=(21, 79),
            dtype=np.uint8),
    }),
    # nmmo-like: tile map + entity rows
    'nmmo_like': spaces.Dict({
        'tile': spaces.Box(low=0, high=255, shape=(15, 15, 3),
            dtype=np.int16),
        'entity': spaces.Box(low=-2**15, high=2**15 - 1, shape=(10, 23),
            dtype=np.int16),
    }),
    # atari: framestacked screen (reference test/environment.py:23)
    'atari': spaces.Box(low=0, high=255, shape=(4, 84, 84),
        dtype=np.uint8),
    # bare Discrete observation (reference :88)
    'discrete_obs': spaces.Discrete(5),
    # full NetHack observation (reference :26-41)
    'nethack_full': spaces.Dict({
        'blstats': spaces.Box(low=-2**31, high=2**31 - 1, shape=(27,),
            dtype=np.int64),
        'chars': spaces.Box(low=0, high=255, shape=(21, 79),
            dtype=np.uint8),
        'colors': spaces.Box(low=0, high=15, shape=(21, 79),
            dtype=np.uint8),
        'glyphs': spaces.Box(low=0, high=5976, shape=(21, 79),
            dtype=np.int16),
        'inv_glyphs': spaces.Box(low=0, high=5976, shape=(55,),
            dtype=np.int16),
        'inv_letters': spaces.Box(low=0, high=127, shape=(55,),
            dtype=np.uint8),
        'inv_oclasses': spaces.Box(low=0, high=18, shape=(55,),
            dtype=np.uint8),
        'message': spaces.Box(low=0, high=255, shape=(256,),
            dtype=np.uint8),
        'tty_chars': spaces.Box(low=0, high=255, shape=(24, 80),
            dtype=np.uint8),
        'tty_colors': spaces.Box(low=0, high=31, shape=(24, 80),
            dtype=np.int8),
        'tty_cursor': spaces.Box(low=0, high=255, shape=(2,),
            dtype=np.uint8),
    }),
    # NMMO-scale: nested ActionTargets + Discrete + float16 leaves
    # (reference :44-86)
    'nmmo_full': spaces.Dict({
        'ActionTargets': spaces.Dict({
            'Attack': spaces.Dict({
                'Style': spaces.Box(low=0, high=1, shape=(3,),
                    dtype=np.int8),
                'Target': spaces.Box(low=0, high=1, shape=(100,),
                    dtype=np.int8),
            }),
            'Move': spaces.Dict({
                'Direction': spaces.Box(low=0, high=1, shape=(5,),
                    dtype=np.int8),
            }),
            'Sell': spaces.Dict({
                'InventoryItem': spaces.Box(low=0, high=1, shape=(12,),
                    dtype=np.int8),
                'Price': spaces.Box(low=0, high=1, shape=(99,),
                    dtype=np.int8),
            }),
        }),
        'AgentId': spaces.Discrete(129),
        'CurrentTick': spaces.Discrete(1025),
        'Entity': spaces.Box(low=-2**15, high=2**15 - 1, shape=(100, 23),
            dtype=np.int16),
        'Task': spaces.Box(low=-32770.0, high=32770.0, shape=(1024,),
            dtype=np.float16),
        'Tile': spaces.Box(low=-2**15, high=2**15 - 1, shape=(225, 3),
            dtype=np.int16),
    }),
    # Dict of Tuple / Dict mix (reference :107-116)
    'dict_of_tuple': spaces.Dict({
        'foo': spaces.Tuple([
            spaces.Box(low=-1, high=1, shape=(2,), dtype=np.float32),
            spaces.Discrete(3),
        ]),
        'bar': spaces.Dict({
            'baz': spaces.Discrete(2),
            'qux': spaces.Discrete(4),
        }),
    }),
}

MOCK_ACTION_SPACES = {
    'discrete': spaces.Discrete(5),
    'multidiscrete': spaces.MultiDiscrete([3, 4]),
    'dict_discrete': spaces.Dict({
        'move': spaces.Discrete(4),
        'attack': spaces.Discrete(3),
    }),
    'tuple_discrete': spaces.Tuple([
        spaces.Discrete(2), spaces.Discrete(6),
    ]),
    # NMMO-scale nested action dict (reference :121-152)
    'nmmo_actions': spaces.Dict({
        'Attack': spaces.Dict({
            'Style': spaces.Discrete(3),
            'Target': spaces.Discrete(100),
        }),
        'Buy': spaces.Dict({'MarketItem': spaces.Discrete(1024)}),
        'Move': spaces.Dict({'Direction': spaces.Discrete(5)}),
        'Sell': spaces.Dict({
            'InventoryItem': spaces.Discrete(12),
            'Price': spaces.Discrete(99),
        }),
    }),
    # deep Tuple(Dict) nesting (reference :159-166)
    'tuple_dict': spaces.Tuple([
        spaces.Discrete(4),
        spaces.Dict({
            'baz': spaces.Discrete(2),
            'qux': spaces.Discrete(2),
        }),
    ]),
}


def sample_space(space, num_lanes, device, generator=None):
    """A tree of (num_lanes, ...) tensors of samples of `space`: uniform
    floats in [max(low, -1e6), min(high, 1e6)], uniform integers in
    [low, high] (clipped to the dtype), as the JAX package's sample_space
    draws them."""
    def draw(sp):
        if isinstance(sp, spaces.Dict):
            return {k: draw(v) for k, v in sp.items()}
        if isinstance(sp, spaces.Tuple):
            return tuple(draw(s) for s in sp)
        dtype = emulation.torch_dtype(sp.dtype)
        if isinstance(sp, spaces.Discrete):
            return torch.randint(0, sp.n, (num_lanes,), generator=generator,
                device=device).to(dtype)
        if isinstance(sp, spaces.MultiDiscrete):
            nvec = torch.as_tensor(sp.nvec, device=device)
            u = torch.rand((num_lanes,) + sp.shape, generator=generator,
                device=device, dtype=torch.float64)
            return (u * nvec).floor().to(dtype)
        u = torch.rand((num_lanes,) + sp.shape, generator=generator,
            device=device, dtype=torch.float64)
        np_dtype = np.dtype(sp.dtype)
        if np.issubdtype(np_dtype, np.floating):
            low = torch.as_tensor(np.maximum(sp.low, -1e6), device=device,
                dtype=torch.float64)
            high = torch.as_tensor(np.minimum(sp.high, 1e6), device=device,
                dtype=torch.float64)
            return (low + u * (high - low)).to(dtype)
        info = np.iinfo(np_dtype)
        low = torch.as_tensor(np.maximum(sp.low.astype(np.int64), info.min),
            device=device, dtype=torch.float64)
        high = torch.as_tensor(np.minimum(sp.high.astype(np.int64),
            info.max), device=device, dtype=torch.float64)
        return (low + (u * (high - low + 1)).floor()).to(dtype)
    return draw(space)


class MockEnv(PufferEnv):
    """Episodes of drawn observations: obs = the episode's observation at
    the tick; reward = tick / episode_length; done at episode_length.
    Any valid action is accepted."""

    def __init__(self, observation_space, action_space, episode_length=8):
        self.observation_space = observation_space
        self.action_space = action_space
        self.episode_length = episode_length
        self.emulated = emulation.make_emulated(observation_space)
        self.render_mode = 'ansi'

    def sample_reset(self, num_lanes, device, generator=None):
        from pufferlib_tpu_torch.vector import obs_flattener
        flatten = obs_flattener(self.observation_space, self.emulated)
        ticks = [flatten(sample_space(self.observation_space, num_lanes,
            device, generator)).reshape(num_lanes, -1)
            for _ in range(self.episode_length + 1)]
        return torch.stack(ticks, dim=1)

    def observation(self, episode, tick):
        """The native observation tree at each lane's tick. A lane past
        its episode's end (a step the autoreset discards) reads the last
        tick."""
        flat = episode[torch.arange(episode.shape[0],
            device=episode.device), tick.long().clamp(
            max=self.episode_length)]
        spec = emulation.nativize_dtype(self.emulated)

        def native(sp, sp_spec):
            if isinstance(sp, spaces.Dict):
                return {k: native(v, sp_spec[k]) for k, v in sp.items()}
            if isinstance(sp, spaces.Tuple):
                return tuple(native(s, sp_spec[f'f{i}'])
                    for i, s in enumerate(sp))
            leaf = emulation.nativize_tensor(flat, sp_spec)
            return leaf.reshape((flat.shape[0],) + tuple(sp.shape))
        return native(self.observation_space, spec)

    def reset(self, draws):
        tick = torch.zeros(draws.shape[0], dtype=torch.int32,
            device=draws.device)
        state = dict(episode=draws, tick=tick)
        return state, self.observation(draws, tick)

    def step(self, state, action, draws=None):
        tick = state['tick'] + 1
        done = tick >= self.episode_length
        # times the float32 reciprocal, as XLA compiles the division
        reward = tick.float() * float(np.float32(1 / self.episode_length))
        obs = self.observation(state['episode'], tick)
        info = {'score': torch.where(done, reward, 0.0)}
        return Step(dict(episode=state['episode'], tick=tick), obs, reward,
            done, torch.zeros_like(done), info)


def env_creator(name='box_float-discrete'):
    """name: '<obs_space>-<action_space>' from the MOCK_* keys."""
    obs_name, atn_name = name.split('-')

    def creator(episode_length=8, **kwargs):
        return MockEnv(MOCK_OBSERVATION_SPACES[obs_name],
            MOCK_ACTION_SPACES[atn_name], episode_length)

    return creator
