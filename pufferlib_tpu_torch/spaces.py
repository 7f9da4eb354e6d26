"""Framework-neutral observation/action space types.

Counterpart of pufferlib_tpu/spaces.py: small metadata objects with numpy
sampling on the host. Box, Discrete, MultiDiscrete, MultiBinary and the
nested Dict (keys sorted) and Tuple, and the host path's gymnasium
conversions (from_gymnasium / to_gymnasium; gymnasium is imported only
inside to_gymnasium).
"""
import numpy as np


class Space:
    """Base space. Subclasses define shape, dtype, sample, contains."""
    shape = ()
    dtype = None

    def sample(self, rng=None):
        raise NotImplementedError

    def contains(self, x):
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)

    def sample(self, rng=None):
        rng = rng or np.random
        if np.issubdtype(self.dtype, np.floating):
            low = np.where(np.isfinite(self.low), self.low, -1e6)
            high = np.where(np.isfinite(self.high), self.high, 1e6)
            return rng.uniform(low, high, self.shape).astype(self.dtype)
        return rng.randint(self.low, self.high.astype(np.int64) + 1,
            self.shape).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        if x.shape != self.shape:
            return False
        return bool(np.all(x >= self.low) and np.all(x <= self.high))

    def __eq__(self, other):
        return (isinstance(other, Box) and self.shape == other.shape
            and self.dtype == other.dtype and np.array_equal(self.low, other.low)
            and np.array_equal(self.high, other.high))

    def __repr__(self):
        return f'Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})'


class Discrete(Space):
    shape = ()

    def __init__(self, n, dtype=np.int32):
        self.n = int(n)
        self.dtype = np.dtype(dtype)

    def sample(self, rng=None):
        rng = rng or np.random
        return self.dtype.type(rng.randint(0, self.n))

    def contains(self, x):
        x = int(np.asarray(x))
        return 0 <= x < self.n

    def __eq__(self, other):
        return isinstance(other, Discrete) and self.n == other.n

    def __repr__(self):
        return f'Discrete({self.n})'


class MultiDiscrete(Space):
    def __init__(self, nvec, dtype=np.int32):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(dtype)

    def sample(self, rng=None):
        rng = rng or np.random
        return (rng.random(self.shape) * self.nvec).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        if x.shape != self.shape:
            return False
        return bool(np.all(x >= 0) and np.all(x < self.nvec))

    def __eq__(self, other):
        return (isinstance(other, MultiDiscrete)
            and np.array_equal(self.nvec, other.nvec))

    def __repr__(self):
        return f'MultiDiscrete({self.nvec.tolist()})'


class MultiBinary(Space):
    def __init__(self, n):
        self.n = int(n)
        self.shape = (self.n,)
        self.dtype = np.dtype(np.int8)

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.randint(0, 2, self.shape).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all((x == 0) | (x == 1)))

    def __repr__(self):
        return f'MultiBinary({self.n})'


class Dict(Space):
    def __init__(self, spaces=None, **kwargs):
        if spaces is None:
            spaces = kwargs
        self.spaces = dict(sorted(spaces.items()))

    def items(self):
        return self.spaces.items()

    def keys(self):
        return self.spaces.keys()

    def values(self):
        return self.spaces.values()

    def __getitem__(self, key):
        return self.spaces[key]

    def sample(self, rng=None):
        return {k: v.sample(rng) for k, v in self.spaces.items()}

    def contains(self, x):
        if not isinstance(x, dict) or set(x) != set(self.spaces):
            return False
        return all(self.spaces[k].contains(v) for k, v in x.items())

    def __repr__(self):
        return f'Dict({self.spaces})'


class Tuple(Space):
    def __init__(self, spaces):
        self.spaces = tuple(spaces)

    def __getitem__(self, i):
        return self.spaces[i]

    def __iter__(self):
        return iter(self.spaces)

    def __len__(self):
        return len(self.spaces)

    def sample(self, rng=None):
        return tuple(s.sample(rng) for s in self.spaces)

    def contains(self, x):
        if not isinstance(x, (tuple, list)) or len(x) != len(self.spaces):
            return False
        return all(s.contains(v) for s, v in zip(self.spaces, x))

    def __repr__(self):
        return f'Tuple({self.spaces})'


def from_gymnasium(space):
    """Convert a gymnasium (or pettingzoo) space into a puffer space; a
    puffer space passes through."""
    name = type(space).__name__
    if name == 'Box':
        return Box(space.low, space.high, space.shape, space.dtype)
    if name == 'Discrete':
        return Discrete(space.n)
    if name == 'MultiDiscrete':
        return MultiDiscrete(space.nvec)
    if name == 'MultiBinary':
        return MultiBinary(space.n)
    if name == 'Dict':
        return Dict({k: from_gymnasium(v) for k, v in space.spaces.items()})
    if name == 'Tuple':
        return Tuple([from_gymnasium(s) for s in space.spaces])
    if isinstance(space, Space):
        return space
    raise TypeError(f'Unsupported space type: {type(space)}')


def to_gymnasium(space):
    """Convert a puffer space into a gymnasium space (host bridge only)."""
    import gymnasium
    if isinstance(space, Box):
        return gymnasium.spaces.Box(
            low=space.low, high=space.high, shape=space.shape, dtype=space.dtype)
    if isinstance(space, Discrete):
        return gymnasium.spaces.Discrete(space.n)
    if isinstance(space, MultiDiscrete):
        return gymnasium.spaces.MultiDiscrete(space.nvec)
    if isinstance(space, MultiBinary):
        return gymnasium.spaces.MultiBinary(space.n)
    if isinstance(space, Dict):
        return gymnasium.spaces.Dict(
            {k: to_gymnasium(v) for k, v in space.items()})
    if isinstance(space, Tuple):
        return gymnasium.spaces.Tuple([to_gymnasium(s) for s in space])
    raise TypeError(f'Unsupported space type: {type(space)}')
