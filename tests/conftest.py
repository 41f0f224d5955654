"""Test configuration: an 8-device virtual CPU mesh, fp64.

The tests run on the CPU (``JAX_PLATFORMS=cpu``, the default here): the fp64
oracle path (SURVEY.md §7 hard-part 3), the multi-device sharding story on
eight virtual devices, and the GPU evolve kernel through the Pallas
interpreter.  Tests that need the card carry the ``gpu`` marker and skip
without one; run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

NOTE: the default tier deselects ``@pytest.mark.slow`` via pyproject
``addopts`` — this ALSO deselects a slow test you name explicitly by node
id ("1 deselected, no tests ran").  Override with ``-m ""`` (run
everything) or ``-m slow`` (slow tier only).
"""

import functools
import os

import jax

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from armadillocudalinearinterpolation import ModelConfig, MapParams  # noqa: E402
from armadillocudalinearinterpolation.utils.cache import (  # noqa: E402
    enable_compilation_cache)

enable_compilation_cache()


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route every call of the GPU evolve kernel through the Pallas
    interpreter, which runs it as plain XLA ops on the CPU."""
    from armadillocudalinearinterpolation.model import evolve_pallas as ep
    monkeypatch.setattr(ep, "evolve_ensemble_pallas", functools.partial(
        ep.evolve_ensemble_pallas, interpret=True))


@pytest.fixture(scope="session")
def cfg():
    """Small but physical config: converges to the reference regime."""
    return ModelConfig(n_neurons=512, n_real=4, dtype="float64")


@pytest.fixture(scope="session")
def params():
    """Driver.cu:16 — beta = 13.0589, homogeneous (sigma = 0)."""
    return MapParams.create(13.0589, 0.0, dtype="float64")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def z_ref():
    """Reference initial guess / approximate fixed point (Driver.cu:24)."""
    return jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)
