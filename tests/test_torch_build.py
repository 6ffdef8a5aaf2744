"""``ops/_build.py`` rebuilds a kernel library when its ``.cu`` source or any
shared header ``csrc/*.cuh`` is newer than the library. Checked on file times
in a scratch directory; no ``nvcc`` is called."""

import os

from safe_control_gym_tpu_torch.ops import _build


def _touch(path, mtime):
    with open(path, 'a'):
        pass
    os.utime(path, (mtime, mtime))


def test_sources_are_the_cu_and_every_shared_header(tmp_path):
    for name in ('quad_kernels.cu', 'cartpole_kernels.cu', 'philox.cuh', 'other.cuh'):
        _touch(tmp_path / name, 1000)
    assert _build.sources('quad_kernels', str(tmp_path)) == [
        str(tmp_path / 'quad_kernels.cu'), str(tmp_path / 'other.cuh'),
        str(tmp_path / 'philox.cuh')]
    srcs = _build.sources('cartpole_kernels')
    assert os.path.basename(srcs[0]) == 'cartpole_kernels.cu'
    assert 'philox.cuh' in {os.path.basename(s) for s in srcs}


def test_a_newer_source_or_header_makes_the_library_stale(tmp_path):
    cu, cuh, lib = tmp_path / 'k.cu', tmp_path / 'philox.cuh', tmp_path / 'libk.so'
    srcs = [str(cu), str(cuh)]
    _touch(cu, 1000)
    _touch(cuh, 1000)
    assert _build.is_stale(str(lib), srcs)           # never built
    _touch(lib, 2000)
    assert not _build.is_stale(str(lib), srcs)       # built after both
    _touch(cuh, 3000)
    assert _build.is_stale(str(lib), srcs)           # the shared header changed
    _touch(lib, 4000)
    _touch(cu, 5000)
    assert _build.is_stale(str(lib), srcs)           # the source changed
    _touch(lib, 5000)
    assert not _build.is_stale(str(lib), srcs)       # same time: up to date
