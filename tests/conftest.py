"""Test configuration.

Runs the suite on CPU with 8 virtual devices so multi-device sharding logic
is exercised without GPUs (the "fake backend" pattern — the reference
runs its KernelAbstractions GPU kernels on the CPU() backend the same way,
see /root/reference/test/gpu_performance.jl:27-37). ``JAX_PLATFORMS``, when
set, wins: ``JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/`` runs the tests
that need a GPU on one.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache ($JAX_COMPILATION_CACHE_DIR when set): the
# P3 integration tests compile very large XLA programs; caching the
# executables on disk makes repeat suite runs minutes faster.
from cloudmicrophysics_tpu.perf import enable_compile_cache  # noqa: E402

enable_compile_cache(os.path.join(os.path.dirname(__file__),
                                  ".jax_compile_cache"))

import pytest  # noqa: E402


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    import numpy as np

    return np.dtype(request.param)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    A multi-hundred-program pytest session has segfaulted XLA:CPU inside
    ``backend_compile`` when compiling the large fused P3 programs late in
    the run (LLVM JIT code-memory exhaustion); the same programs compile
    fine in a fresh process. Bounding the in-memory executable cache keeps
    the long suite stable.
    """
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-compiling benchmark/integration tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (decided at run time)")
