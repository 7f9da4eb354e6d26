"""Framework-neutral observation/action space types.

Counterpart of pufferlib_tpu/spaces.py: small metadata objects with numpy
sampling on the host. Only the spaces the ported envs use are here (Box,
Discrete, MultiDiscrete); the nested spaces come with the envs that need
them (ROADMAP, queue 1).
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
