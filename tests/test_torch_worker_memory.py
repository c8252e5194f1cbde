"""Keep a test process's memory from growing file by file.

The tier-1 suite runs in several xdist workers, each of which runs many
test files in one process.  Without a release between files a worker
keeps what every file left behind (JAX's compiled executables, the freed
heap that glibc holds on to) and grows by gigabytes over a handful of the
port's files: a process that large may be ended when memory runs short,
and the test it was running then fails.  So every port test file but the
card's (which imports no JAX) takes ``release_memory``, a module-scoped
fixture that releases after the file: garbage, JAX's caches, and the
heap's free pages back to the system.
"""
import ctypes
import ctypes.util
import gc

import jax
import pytest


def release() -> None:
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    except (OSError, AttributeError, TypeError):
        pass  # no glibc: nothing to trim


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    yield
    release()


def test_release_clears_jax_caches():
    f = jax.jit(lambda v: v + 1.0)
    f(1.0)
    assert f._cache_size() == 1
    release()
    assert f._cache_size() == 0
    assert float(f(2.0)) == 3.0          # recompiles on the next call
