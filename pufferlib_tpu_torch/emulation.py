"""Space emulation: nested obs/action spaces <-> flat fixed-dtype tensors.

Counterpart of pufferlib_tpu/emulation.py. The structured-dtype metadata
is computed once on the host with numpy; on the device, flattening and
nativizing a batch are slices, byte copies and dtype views of tensors.

- dtype_from_space, flatten_space: the structured dtype of a nested space
  (align=True, tuple fields f0..fN) and its depth-first leaves
- emulate_observation_space: a flat Box of the common leaf dtype, or raw
  uint8 bytes where the leaves differ
- emulate_action_space: MultiDiscrete of the leaves' cardinalities
- emulate / make_buffer / nativize / nativize_multidiscrete: numpy, on
  the host
- nativize_dtype: the (dtype, shape, offset, delta) spec of every leaf,
  its offset from numpy's own field layout
- nativize_tensor / emulate_tensor: flat (B, numel) tensor <-> leaves
"""
import numpy as np
import torch

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.environment import tree_leaves
from pufferlib_tpu_torch.namespace import namespace


# --------------------------------------------------------------------------
# Structured dtype metadata (host side)

def dtype_from_space(space):
    """numpy structured dtype mirroring the nested space. Tuple fields are
    named f0..fN; align=True so offsets match C structs."""
    if isinstance(space, spaces.Tuple):
        dtype = [(f'f{i}', dtype_from_space(elem))
            for i, elem in enumerate(space)]
    elif isinstance(space, spaces.Dict):
        dtype = [(k, dtype_from_space(v)) for k, v in space.items()]
    elif isinstance(space, spaces.Discrete):
        dtype = (space.dtype, ())
    else:
        dtype = (space.dtype, space.shape)
    return np.dtype(dtype, align=True)


def flatten_space(space):
    """Depth-first list of leaf spaces."""
    if isinstance(space, (spaces.Tuple, spaces.Dict)):
        leaves = []
        for e in (space.values() if isinstance(space, spaces.Dict)
                else space):
            leaves.extend(flatten_space(e))
        return leaves
    return [space]


def _dtype_bounds(dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return info.min, info.max
    info = np.finfo(dtype)
    return info.min, info.max


def emulate_observation_space(space):
    """Nested space -> (flat Box, structured dtype). A Box passes through
    unchanged. Otherwise the flat space uses the common leaf dtype, or
    raw uint8 bytes when leaves disagree."""
    emulated_dtype = dtype_from_space(space)
    if isinstance(space, spaces.Box):
        return space, emulated_dtype

    dtypes = [np.dtype(leaf.dtype) for leaf in flatten_space(space)]
    if all(d == dtypes[0] for d in dtypes):
        dtype = dtypes[0]
    else:
        dtype = np.dtype(np.uint8)

    mmin, mmax = _dtype_bounds(dtype)
    numel = emulated_dtype.itemsize // dtype.itemsize
    flat = spaces.Box(low=mmin, high=mmax, shape=(numel,), dtype=dtype)
    return flat, emulated_dtype


def emulate_action_space(space):
    """Nested action space -> (MultiDiscrete of leaf cardinalities, dtype).
    Continuous (Box) action spaces cannot be emulated; discretize them
    first."""
    if isinstance(space, (spaces.Discrete, spaces.MultiDiscrete)):
        return space, space.dtype
    emulated_dtype = dtype_from_space(space)
    nvec = []
    for leaf in flatten_space(space):
        if isinstance(leaf, spaces.MultiDiscrete):
            nvec.extend(int(n) for n in leaf.nvec)
        elif isinstance(leaf, spaces.MultiBinary):
            nvec.extend([2] * leaf.n)
        elif isinstance(leaf, spaces.Discrete):
            nvec.append(leaf.n)
        else:
            raise ValueError(
                'Continuous (Box) action spaces cannot be emulated; '
                'discretize them first')
    return spaces.MultiDiscrete(nvec), emulated_dtype


def is_emulated(space):
    """True when the flat space differs from the native space."""
    flat, _ = emulate_observation_space(space)
    return flat is not space


# --------------------------------------------------------------------------
# numpy pack/unpack on the host

def emulate(struct, sample):
    """Copy a nested dict/tuple sample into a structured-array view.
    Assignment goes through the parent field (struct[key] = value):
    indexing a scalar field of a void scalar returns a copy."""
    if isinstance(sample, dict):
        items = sample.items()
    elif isinstance(sample, (tuple, list)):
        items = ((f'f{i}', v) for i, v in enumerate(sample))
    else:
        struct[()] = sample
        return
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            emulate(struct[k], v)
        else:
            struct[k] = v


def make_buffer(arr_dtype, struct_dtype, n=None):
    """Allocate paired (flat array view, structured view) buffers."""
    struct = np.zeros(1 if n is None else n, dtype=struct_dtype)
    arr = struct.view(arr_dtype)
    arr = arr.ravel() if n is None else arr.reshape(n, -1)
    return arr, struct


def _nativize_np(struct, space):
    if isinstance(space, spaces.Discrete):
        return struct.item()
    if isinstance(space, spaces.Tuple):
        return tuple(_nativize_np(struct[f'f{i}'], e)
            for i, e in enumerate(space))
    if isinstance(space, spaces.Dict):
        return {k: _nativize_np(struct[k], v) for k, v in space.items()}
    return struct


def nativize(arr, space, struct_dtype):
    """View a flat numpy array back as the native nested sample."""
    struct = np.asarray(arr).view(struct_dtype)[0]
    return _nativize_np(struct, space)


def nativize_multidiscrete(action, space):
    """Unpack a flat MultiDiscrete action vector into the nested action
    space it emulates, depth-first (inverse of emulate_action_space).
    numpy, on the host."""
    flat = np.asarray(action).ravel()
    pos = [0]

    def take(k, dtype):
        values = flat[pos[0]:pos[0] + k]
        pos[0] += k
        return np.asarray(values, dtype=dtype)

    def build(sp):
        if isinstance(sp, spaces.Discrete):
            pos[0] += 1
            return int(flat[pos[0] - 1])
        if isinstance(sp, spaces.MultiBinary):
            return take(sp.n, sp.dtype)
        if isinstance(sp, spaces.MultiDiscrete):
            return take(len(sp.nvec), sp.dtype)
        if isinstance(sp, spaces.Dict):
            return {k: build(v) for k, v in sp.items()}
        if isinstance(sp, spaces.Tuple):
            return tuple(build(s) for s in sp)
        raise ValueError(
            f'Nested action spaces must have Discrete leaves, got {sp}')

    return build(space)


# --------------------------------------------------------------------------
# nativize specs

def nativize_dtype(emulated):
    """The flat-offset spec tree for reconstructing structured obs.

    emulated: namespace with .observation_dtype (the flat sample dtype)
    and .emulated_observation_dtype (the structured dtype). Returns a leaf
    spec (np_dtype, shape, offset, delta) or a nested dict of specs.
    Offsets and deltas are in bytes when the sample dtype is single-byte,
    else in elements of the (uniform) sample dtype."""
    subviews, dtype, shape, offset, delta = _nativize_dtype(
        np.dtype(emulated.observation_dtype),
        np.dtype(emulated.emulated_observation_dtype))
    if subviews is None:
        return (dtype, shape, offset, delta)
    return subviews


def _nativize_dtype(sample_dtype, structured_dtype, byte_offset=0):
    """Offsets come from numpy's own field layout (dtype.fields carries
    each field's byte offset), so the tail padding of a nested struct
    under align=True is honoured."""
    if structured_dtype.fields is None:
        if structured_dtype.subdtype is not None:
            dtype, shape = structured_dtype.subdtype
        else:
            dtype, shape = structured_dtype, (1,)
        delta = int(np.prod(shape))
        if sample_dtype.base.itemsize == 1:
            offset = byte_offset
            delta *= dtype.itemsize
        else:
            if dtype.itemsize != sample_dtype.base.itemsize:
                raise ValueError('mixed-dtype spaces must emulate to bytes')
            offset = byte_offset // sample_dtype.base.itemsize
        return None, np.dtype(dtype), tuple(shape), offset, delta

    subviews = {}
    for name, finfo in structured_dtype.fields.items():
        views, dtype, shape, offset, delta = _nativize_dtype(
            sample_dtype, finfo[0], byte_offset + finfo[1])
        subviews[name] = views if views is not None else (
            dtype, shape, offset, delta)
    return subviews, dtype, shape, byte_offset, structured_dtype.itemsize


def torch_dtype(np_dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


# --------------------------------------------------------------------------
# nativize / emulate on tensors

def nativize_tensor(observation, native_dtype):
    """Structured obs from a flat batch: observation (B, numel) of the
    flat sample dtype, native_dtype a spec of nativize_dtype. Returns a
    (possibly nested dict) tree of (B, *shape) tensors.

    Byte leaves wider than one byte are copied out of their columns
    before the dtype view: a column slice of a (B, numel) uint8 batch has
    neither a contiguous row nor an aligned start. Little-endian, as the
    JAX package's bitcast. A 64-bit integer leaf comes back as its low
    32-bit word (int32 / uint32), as the JAX package gives it without
    x64: the values must fit 32 bits."""
    if not isinstance(native_dtype, tuple):
        return {name: nativize_tensor(observation, sub)
            for name, sub in native_dtype.items()}
    dtype, shape, offset, delta = native_dtype
    dtype = np.dtype(dtype)
    B = observation.shape[0]
    chunk = observation[:, offset:offset + delta]
    if dtype.itemsize == 8:
        if dtype.kind not in 'iu':
            raise ValueError(f'float64 obs leaf is not supported ({dtype})')
        low = torch.int32 if dtype.kind == 'i' else torch.uint32
        if observation.element_size() == 1:
            words = chunk.contiguous().view(B, delta // 8, 2, 4).view(low)
            chunk = words[..., 0, 0]
        else:
            chunk = chunk.to(torch.int64).view(torch.int32).reshape(
                B, -1, 2)[..., 0].view(low)
        return chunk.reshape(B, *shape)
    target = torch_dtype(dtype)
    if observation.element_size() == 1 and dtype.itemsize != 1:
        chunk = chunk.contiguous().view(B, delta // dtype.itemsize,
            dtype.itemsize).view(target)
    elif chunk.dtype != target:
        chunk = chunk.contiguous().view(target)
    return chunk.reshape(B, *shape)


def is_spec(node):
    """Whether a node of a nativize_dtype tree is a leaf spec, a
    (dtype, shape, offset, delta) tuple."""
    return isinstance(node, tuple)


def write_leaves(leaves, specs, sample_dtype, numel):
    """(B, numel) flat batch of sample_dtype from leaves, each cast to its
    spec's dtype and written at its spec's offset: as bytes where the
    sample dtype is single-byte, else as elements of the sample dtype.
    Bytes the leaves do not cover (alignment padding) are zero."""
    sample_dtype = np.dtype(sample_dtype)
    batch = leaves[0].shape[0]
    out = torch.zeros((batch, numel), dtype=torch_dtype(sample_dtype),
        device=leaves[0].device)
    for leaf, (dtype, _, offset, _) in zip(leaves, specs):
        leaf = leaf.reshape(batch, -1).to(torch_dtype(dtype))
        if leaf.dtype != out.dtype:
            leaf = leaf.contiguous().view(out.dtype).reshape(batch, -1)
        out[:, offset:offset + leaf.shape[1]] = leaf
    return out


def emulate_tensor(sample, emulated):
    """Flatten a structured obs tree (leaves (B, ...)) into the flat batch
    (B, numel) of the flat dtype: the inverse of nativize_tensor."""
    sample_dtype = np.dtype(emulated.observation_dtype)
    specs = tree_leaves(nativize_dtype(emulated), is_leaf=is_spec)
    leaves = tree_leaves(sample)
    if len(leaves) != len(specs):
        raise ValueError('sample does not match spec')
    numel, _ = emulate_observation_space_from_dtype(
        emulated.emulated_observation_dtype, sample_dtype)
    return write_leaves(leaves, specs, sample_dtype, numel)


def emulate_observation_space_from_dtype(struct_dtype, sample_dtype):
    """numel of the flat representation for a structured dtype."""
    numel = np.dtype(struct_dtype).itemsize // np.dtype(sample_dtype).itemsize
    return numel, sample_dtype


def make_emulated(observation_space):
    """Namespace carrying the flat and structured dtypes of an
    observation space (as vector.Device's `emulated`)."""
    flat, struct_dtype = emulate_observation_space(observation_space)
    return namespace(
        observation_dtype=np.dtype(flat.dtype),
        emulated_observation_dtype=struct_dtype,
    )
