"""Build and load the port's CUDA kernels.

Each kernel source in pufferlib_tpu_torch/csrc/ is compiled by nvcc, at
first use, into a shared library with a plain C interface and loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -split-compile 0 \
         -o _build/lib<name>-<hash>.so <name>.cu

-split-compile 0 lets nvcc optimise a source's kernels on every core at
once: the LSTM sources hold dozens of template instantiations each, and
the longest of them sets the wall time of a build.

The library's name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale one is never loaded. The build
directory (pufferlib_tpu_torch/_build/) is listed in .gitignore. A build
that fails raises with nvcc's output; there is no fallback.

Every exported C function launches on the stream it is given, returns
cudaGetLastError() (0 is success), and allocates nothing: the Python
wrapper allocates outputs with torch.empty.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
    '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
    '-split-compile', '0')


def nvcc_path():
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home:
            path = os.path.join(home, 'bin', 'nvcc')
            if os.path.exists(path):
                return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError(
            'nvcc not found (CUDA_HOME, /usr/local/cuda, PATH); the CUDA '
            'kernels of pufferlib_tpu_torch are built with it')
    return path


class CudaKernel:
    """One CUDA source file, its C functions and its launch count.

    functions: {C function name: [ctypes argument types]}; each returns
    an int cudaError_t. `launches` counts successful launches through
    `launch` and nothing else, `fn_launches` the same per C function;
    reset_counts() sets both to 0."""

    def __init__(self, source, functions):
        self.source = source
        self.functions = functions
        self.launches = 0
        self.fn_launches = dict.fromkeys(functions, 0)
        self.build_log = ''
        self.build_seconds = None
        self._lib = None

    @property
    def name(self):
        return os.path.splitext(self.source)[0]

    def library_path(self):
        # the source and every shared header it may include
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
        digest = hashlib.sha1()
        for name in [self.source] + headers:
            with open(os.path.join(CSRC_DIR, name), 'rb') as f:
                digest.update(f.read())
        digest.update(' '.join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
            f'lib{self.name}-{digest.hexdigest()[:12]}.so')

    def start_build(self):
        """Start nvcc for this source unless its library exists. Returns
        a pending build for finish_build, or None."""
        path = self.library_path()
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp,
            os.path.join(CSRC_DIR, self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path, time.perf_counter()

    def finish_build(self, pending):
        if pending is None:
            return
        proc, tmp, path, start = pending
        out, _ = proc.communicate()
        self.build_log = out
        self.build_seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed on {self.source} (exit {proc.returncode}):\n'
                f'{out}')
        os.replace(tmp, path)

    def build(self):
        self.finish_build(self.start_build())

    def lib(self):
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(self.library_path())
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn, *args):
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.cuda_error_string(err).decode()
            raise RuntimeError(f'{fn} failed: cudaError {err} ({msg})')
        self.launches += 1
        self.fn_launches[fn] += 1

    def reset_counts(self):
        self.launches = 0
        self.fn_launches = dict.fromkeys(self.functions, 0)


def build_all(kernels):
    """Build every kernel's library at once, one nvcc process each."""
    pending = [(k, k.start_build()) for k in kernels]
    errors = []
    for kernel, p in pending:
        try:
            kernel.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    for kernel in kernels:
        kernel.lib()


def stream_handle(tensor):
    """The current CUDA stream of tensor's device, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def ptr_or_null(tensor):
    """ptr(tensor), or a null pointer for None: an optional output that
    the kernel then skips."""
    return None if tensor is None else ptr(tensor)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
