"""ctypes loader for the C++ envpool driver core (csrc/envpool.cpp),
counterpart of pufferlib_tpu/native.py.

Builds the port's own copy of the source with g++ at first use into
pufferlib_tpu_torch/_build/libpufferpool-<hash>.so (the hash of the source
and the flags, so an edited source is rebuilt). load() keeps the JAX
loader's contract, None when the library cannot be had, so that
HostMultiprocessing's default runs the Python spin loop instead;
load(required=True) raises with the compiler's output instead, for a
caller that asked for the native driver.
"""
import ctypes
import hashlib
import os
import subprocess

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PACKAGE_DIR, 'csrc', 'envpool.cpp')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_LIB = None
_ERROR = None


def library_path():
    digest = hashlib.sha1()
    with open(SOURCE, 'rb') as f:
        digest.update(f.read())
    digest.update(' '.join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
        f'libpufferpool-{digest.hexdigest()[:12]}.so')


def _build():
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run(['g++', *FLAGS, '-o', tmp, SOURCE],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed on {SOURCE} (exit '
            f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def _open(path):
    lib = ctypes.CDLL(path)
    lib.wait_ready.restype = ctypes.c_int
    lib.wait_ready.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.gather_blocks.restype = None
    lib.gather_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64]
    lib.scatter_blocks.restype = None
    lib.scatter_blocks.argtypes = lib.gather_blocks.argtypes
    lib.signal_workers.restype = None
    lib.signal_workers.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint8]
    return lib


def load(required=False):
    """The loaded library; None when it cannot be built or loaded (no
    compiler, say), unless `required`, which raises the reason. The first
    attempt's outcome is kept."""
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            _LIB = _open(_build())
        except (OSError, RuntimeError) as e:
            _ERROR = e
    if _LIB is None and required:
        raise RuntimeError(f'the native envpool driver is unavailable: '
            f'{_ERROR}') from _ERROR
    return _LIB


def wait_ready(lib, sem_arr, candidates, needed, timeout_us=-1,
        spin_us=500_000):
    """Spin (GIL released inside C) until `needed` of `candidates` are
    ready; returns their indices in completion order. spin_us=0 naps
    from the start — required when workers outnumber cores, where a
    hot-spinning driver starves the workers it is waiting on."""
    candidates = np.ascontiguousarray(candidates, dtype=np.int32)
    out = np.empty(needed, dtype=np.int32)
    n = lib.wait_ready(
        sem_arr.ctypes.data, len(sem_arr),
        candidates.ctypes.data, len(candidates), needed,
        out.ctypes.data, timeout_us, spin_us)
    if n < 0:
        raise TimeoutError('wait_ready timed out')
    return out[:n]


def gather_rows(lib, src, dst, row_indices, row_bytes):
    """dst[b] = src rows at row_indices (contiguous row-major blocks)."""
    offsets = np.ascontiguousarray(row_indices, np.int64) * row_bytes
    lib.gather_blocks(src.ctypes.data, dst.ctypes.data,
        offsets.ctypes.data, len(offsets), row_bytes)


def scatter_rows(lib, src, dst, row_indices, row_bytes):
    offsets = np.ascontiguousarray(row_indices, np.int64) * row_bytes
    lib.scatter_blocks(src.ctypes.data, dst.ctypes.data,
        offsets.ctypes.data, len(offsets), row_bytes)
