"""Test configuration: run on a virtual 8-device CPU mesh.

Tests must not require a GPU; sharding tests use the forced host-platform
device count. chip_smoke.py and bench.py (run separately) use the GPU.
The platform is set through jax.config, which also holds when jax was
imported before this file ran.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The suite compiles hundreds of XLA programs (every (shape, config)
    pair across 20+ modules); keeping them all live exhausts per-process
    memory mappings (vm.max_map_count 65530 here) and aborts the XLA
    compiler late in the run — reproducibly at ~test 126, while the same
    module passes standalone. Bounding live programs to one module's
    worth keeps the full run well under the limit; jitted functions
    retrace transparently on next use.
    """
    yield
    jax.clear_caches()
