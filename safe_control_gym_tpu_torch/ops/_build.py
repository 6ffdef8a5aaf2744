"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

The kernels have a plain C interface (no PyTorch headers), so one ``nvcc``
call per source takes seconds. The shared libraries go into ``csrc/build/``
(listed in ``.gitignore``) on first use and are rebuilt when their source or
any shared header ``csrc/*.cuh`` is newer; beside each library, ``ptxas``'s
report of every kernel's registers, stack and spills (``ptxas_log``).
Nothing is built or imported when this module is imported: the CPU tests
import every module of the package on a machine without ``nvcc``.

    lib = load_library('cartpole_kernels')   # csrc/cartpole_kernels.cu
    lib = load_library('quad_kernels')       # csrc/quad_kernels.cu
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import os
import shutil
import subprocess
import threading

__all__ = ['CSRC_DIR', 'BUILD_DIR', 'NVCC_FLAGS', 'sources', 'is_stale',
           'build_all', 'load_library', 'ptxas_log', 'check']

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'csrc')
BUILD_DIR = os.path.join(CSRC_DIR, 'build')

# Hopper with its architecture-specific features; no fast-math intrinsics and
# no fused multiply-add contraction, so every float operation rounds as the
# plain PyTorch version's separate elementwise ops do. ``-Xptxas -v`` only
# reports each kernel's registers, stack and spills (kept by ``_build``).
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, 'bin', 'nvcc')):
        return os.path.join(CUDA_HOME, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a machine '
                       'with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)')


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f'lib{name}.so')


def ptxas_log(name: str) -> str:
    """The path of ``ptxas -v``'s report from the last build of ``lib<name>.so``
    (``experiments/sass.py`` ``ptxas_resources`` reads it)."""
    return os.path.join(BUILD_DIR, f'lib{name}.ptxas.txt')


def sources(name: str, csrc_dir: str = CSRC_DIR) -> list:
    """What ``lib<name>.so`` is built from: ``<name>.cu`` and every shared
    header ``*.cuh`` beside it."""
    return [os.path.join(csrc_dir, f'{name}.cu'),
            *sorted(glob.glob(os.path.join(csrc_dir, '*.cuh')))]


def is_stale(lib: str, srcs) -> bool:
    """True when ``lib`` is missing or older than any of ``srcs``."""
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(s) > built for s in srcs)


def _build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    srcs = sources(name)
    src = srcs[0]
    out = _lib_path(name)
    if not is_stale(out, srcs):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src} (exit {proc.returncode}):\n'
                           f'{proc.stdout}\n{proc.stderr}')
    with open(ptxas_log(name), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Build every ``csrc/*.cu``, one ``nvcc`` process per source, all at once.
    Returns {name: library path}."""
    names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith('.cu'))
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futures = {n: ex.submit(_build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            lib.scg_error_string.argtypes = [ctypes.c_int]
            lib.scg_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if err != 0:
        msg = lib.scg_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err}: {msg}')
