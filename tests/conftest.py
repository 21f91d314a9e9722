import os

# Tests run on a virtual 8-device CPU mesh, so multi-device sharding paths
# are exercised without GPUs. JAX_PLATFORMS=cuda runs them on the card
# instead, for the GPU-marked tests (README 'Testing').
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# tests use tiny graphs; drop the dense-incidence edge-count floor so the
# dense aggregation paths are exercised (data/graph.py _DENSE_INC_MIN_EDGES)
os.environ.setdefault("IGNNITION_TPU_DENSE_INC_MIN_EDGES", "0")

import jax  # noqa: E402

# JAX may have been imported (and its platform fixed) before this file
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _bound_executable_accumulation():
    """Release compiled XLA executables between test modules.

    The suite compiles hundreds of distinct programs; on small (2-core) CI
    hosts the accumulated XLA CPU state has intermittently crashed the
    process late in the run (fatal 'Aborted' inside backend_compile_and_load
    / segfaults, reproduced twice before this bound). Modules rarely share
    compiled shapes, so the cost is a handful of recompiles."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def native_loader():
    """The native (C++) loader, built from native/ with `make` once per test
    process. An exclusive lock on the Makefile serializes the build across
    concurrent test workers, so none loads a half-written library."""
    import fcntl
    import subprocess

    native = os.path.join(ROOT, "native")
    with open(os.path.join(native, "Makefile")) as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-s", "-C", native], check=True)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    from ignnition_tpu.data import native_loader as nl

    assert nl.available(), "make -C native did not produce the library"
    return nl


@pytest.fixture
def gpu():
    """Skips the test where JAX finds no GPU — decided when the test runs,
    never at import, so every test worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is {dev}")
    return dev
