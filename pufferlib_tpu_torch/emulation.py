"""Space emulation: native obs/action spaces -> flat fixed-dtype spaces.

Counterpart of pufferlib_tpu/emulation.py:37-123 (dtype_from_space,
emulate_observation_space, emulate_action_space) for the leaf spaces
this package has. Nested spaces, flatten_space and the device-side
structured nativize (`nativize_tensor`) come in a later slice.
"""
import numpy as np

from pufferlib_tpu_torch import spaces


def dtype_from_space(space):
    """numpy dtype of one sample of a leaf space (align=True, as the
    structured dtypes of nested spaces will be)."""
    if isinstance(space, spaces.Discrete):
        dtype = (space.dtype, ())
    else:
        dtype = (space.dtype, space.shape)
    return np.dtype(dtype, align=True)


def _dtype_bounds(dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return info.min, info.max
    info = np.finfo(dtype)
    return info.min, info.max


def emulate_observation_space(space):
    """Space -> (flat Box, emulated dtype). A Box passes through
    unchanged; a discrete observation becomes a flat Box of its dtype."""
    emulated_dtype = dtype_from_space(space)
    if isinstance(space, spaces.Box):
        return space, emulated_dtype

    dtype = np.dtype(space.dtype)
    mmin, mmax = _dtype_bounds(dtype)
    numel = emulated_dtype.itemsize // dtype.itemsize
    flat = spaces.Box(low=mmin, high=mmax, shape=(numel,), dtype=dtype)
    return flat, emulated_dtype


def emulate_action_space(space):
    """Action space -> (Discrete or MultiDiscrete, dtype). Continuous
    (Box) action spaces cannot be emulated; discretize them first."""
    if isinstance(space, (spaces.Discrete, spaces.MultiDiscrete)):
        return space, space.dtype
    raise ValueError(
        'Continuous (Box) action spaces cannot be emulated; '
        'discretize them first')
