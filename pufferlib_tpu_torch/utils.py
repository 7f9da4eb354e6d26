"""Utilities (counterpart of pufferlib_tpu/utils.py): the wall-clock
Profiler and its @profile decorator, and unroll_nested_dict, which the
host trainer needs. The rest of the JAX module (Suppress,
compare_space_samples, get_init_args) waits for the CLI.

Parity: reference pufferlib/utils.py (Profiler :247-319, @profile
:321-340, unroll_nested_dict :56).
"""
import time


class Profiler:
    """Context-manager wall-clock timer with call accounting. Device work
    is asynchronous: a timed region measures the card only where it ends
    in a synchronising read."""

    def __init__(self):
        self.elapsed = 0.0
        self.calls = 0
        self.prev = 0.0
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.prev = time.perf_counter() - self._start
        self.elapsed += self.prev
        self.calls += 1
        self._start = None
        return False


def profile(fn):
    """Decorator accumulating a Profiler per function in
    first_argument._timers."""
    name = fn.__name__

    def wrapper(self, *args, **kwargs):
        if not hasattr(self, '_timers'):
            self._timers = {}
        if name not in self._timers:
            self._timers[name] = Profiler()
        with self._timers[name]:
            return fn(self, *args, **kwargs)

    wrapper.__name__ = name
    return wrapper


def unroll_nested_dict(d, prefix=()):
    """Yield (slash/joined/key, value) for every leaf of a nested dict."""
    for k, v in d.items():
        key = prefix + (str(k),)
        if isinstance(v, dict):
            yield from unroll_nested_dict(v, key)
        else:
            yield '/'.join(key), v
