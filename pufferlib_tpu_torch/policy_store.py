"""Directory of checkpointed policies for self-play opponents.

Counterpart of pufferlib_tpu/policy_store.py: a policy is a
`model_{epoch:06d}.pt` file. The port's own (training/checkpoint.py
writes the policy's state_dict) comes back as it is; a reference
PufferLib state_dict (its Default or LSTMWrapper(Default)) comes back
converted to the port's layout through frameworks.torch_import, as the
JAX store converts it to flax params. The keys tell the two layouts
apart. The store unpickles nothing but tensors: a pickled module is
refused unread (read_policy).
"""
import os
import pickle

import torch

from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.frameworks import torch_import

# the package whose pickled modules read_policy may unpickle
_REFERENCE_PACKAGE = 'pufferlib.'


def _pickled_classes(path):
    """The classes a checkpoint pickles beyond tensors in containers,
    listed without unpickling it (none for a file torch.save did not
    write)."""
    try:
        return torch.serialization.get_unsafe_globals_in_checkpoint(path)
    except ValueError:
        return []


def read_policy(path, unpickle_reference=False):
    """The state_dict of a policy file, its tensors on the CPU: the
    port's own as it is; a reference PufferLib policy converted to the
    keys of the port's Policy / RecurrentPolicy, as the trainer saves
    them (torch_import.convert). A file that is neither raises
    APIUsageError.

    The file is read with weights_only=True, which unpickles tensors in
    containers and nothing else. A file that pickles other objects (a
    saved module) is refused without being unpickled, unless
    unpickle_reference is set and a class it names is of the reference
    `pufferlib` package: then it is read as the reference saves it
    (torch_import.read, weights_only=False, which runs what the pickle
    says), so set it only for a file the user named. Unpickling a
    reference module needs the reference package, and the ImportError
    says so."""
    refusal = (f'{path} holds no policy state_dict (model_*.pt as '
        'training/checkpoint.py writes it, or a reference PufferLib Default '
        '/ LSTMWrapper(Default), its state_dict or module)')
    try:
        obj = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError:
        classes = _pickled_classes(path)
        if not any(c.startswith(_REFERENCE_PACKAGE) for c in classes):
            raise APIUsageError(f'{refusal}: it pickles {classes}, none of '
                'the reference package, and was not unpickled') from None
        if not unpickle_reference:
            raise APIUsageError(f'{path} pickles a reference PufferLib '
                f'module ({classes}), which is not unpickled here: read it '
                'with torch_import.load_pt, or save its state_dict') \
                from None
        obj = torch_import.read(path)
    except (RuntimeError, EOFError) as e:
        # not a file torch.save wrote
        raise APIUsageError(refusal) from e
    module = hasattr(obj, 'state_dict')
    if module:
        obj = obj.state_dict()
    if not (isinstance(obj, dict) and obj and all(
            isinstance(k, str) and torch.is_tensor(v)
            for k, v in obj.items())):
        raise APIUsageError(refusal)
    if torch_import.is_reference(obj):
        return torch_import.convert(obj, wrapper=True)
    if module:
        # the port saves state_dicts, never modules
        raise APIUsageError(refusal)
    return obj


class PolicyStore:
    def __init__(self, path):
        self.path = path

    def policy_names(self):
        return sorted(file[:-len('.pt')] for file in os.listdir(self.path)
            if file.startswith('model_') and file.endswith('.pt'))

    def get_policy(self, name):
        """The state_dict saved as `name`.pt (read_policy: a pickled
        module is refused unread), its tensors on the CPU."""
        return read_policy(os.path.join(self.path, name + '.pt'))
