"""Utilities (counterpart of pufferlib_tpu/utils.py): the wall-clock
Profiler and its @profile decorator, Suppress, unroll_nested_dict,
compare_space_samples and get_init_args (the CLI's flag introspection).

Parity: reference pufferlib/utils.py (Profiler :247-319, @profile
:321-340, Suppress :353-383, unroll_nested_dict :56, get_init_args
:34-53).
"""
import inspect
import os
import sys
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


class Suppress:
    """stdout/stderr silencing at both levels: fds 1/2 (swallows C-level
    output) and sys.stdout/sys.stderr (swallows Python prints even where
    the sys streams are not fd-backed, as under pytest's capture)."""

    def __enter__(self):
        self.null = os.open(os.devnull, os.O_WRONLY)
        sys.stdout.flush()
        sys.stderr.flush()
        self.saved = (os.dup(1), os.dup(2))
        os.dup2(self.null, 1)
        os.dup2(self.null, 2)
        self.saved_sys = (sys.stdout, sys.stderr)
        self._null_stream = open(os.devnull, 'w')
        sys.stdout = sys.stderr = self._null_stream
        return self

    def __exit__(self, *args):
        sys.stdout, sys.stderr = self.saved_sys
        self._null_stream.close()
        os.dup2(self.saved[0], 1)
        os.dup2(self.saved[1], 2)
        os.close(self.saved[0])
        os.close(self.saved[1])
        os.close(self.null)
        return False


def unroll_nested_dict(d, prefix=()):
    """Yield (slash/joined/key, value) for every leaf of a nested dict."""
    for k, v in d.items():
        key = prefix + (str(k),)
        if isinstance(v, dict):
            yield from unroll_nested_dict(v, key)
        else:
            yield '/'.join(key), v


def compare_space_samples(sample_1, sample_2, idx=None):
    """Deep-compare two space samples; sample_2 may be a batched version
    of sample_1 at index idx (reference utils.py:146-170)."""
    import numpy as np
    if isinstance(sample_1, dict):
        return all(k in sample_2 and compare_space_samples(
            v, sample_2[k], idx) for k, v in sample_1.items())
    if isinstance(sample_1, (tuple, list)):
        return len(sample_1) == len(sample_2) and all(
            compare_space_samples(a, b, idx)
            for a, b in zip(sample_1, sample_2))
    sample_2 = np.asarray(sample_2)
    if idx is not None:
        sample_2 = sample_2[idx]
    sample_1 = np.asarray(sample_1)
    return sample_1.shape == np.asarray(sample_2).reshape(
        sample_1.shape).shape and np.allclose(
        sample_1, np.asarray(sample_2).reshape(sample_1.shape))


def get_init_args(fn):
    """The default keyword arguments of a callable's signature, which the
    CLI turns into flags (reference utils.py:34-53)."""
    if fn is None:
        return {}
    args = {}
    for name, param in inspect.signature(fn).parameters.items():
        if name in ('self', 'env', 'policy'):
            continue
        if param.kind in (inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD):
            continue
        if param.default is not inspect.Parameter.empty:
            args[name] = param.default
    return args
