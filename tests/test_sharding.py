"""Multi-device tests on the 8-device virtual CPU mesh: sharded map equals
the unsharded map bitwise, and the sharded Newton solve converges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, event_driven_map)
from armadillocudalinearinterpolation.parallel import (
    make_mesh, make_sharded_residual_fn, sharded_newton_solve)
from armadillocudalinearinterpolation.parallel.sharding import (
    event_driven_map_sharded)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return make_mesh({"real": 8})


def test_make_mesh_validates_device_count():
    with pytest.raises(ValueError):
        make_mesh({"real": 1024})


def test_sharded_map_matches_unsharded(params, key, z_ref, mesh8):
    """Same traced program, GSPMD-partitioned: agreement to reduction-order
    rounding (the cross-device psum reassociates the ensemble sum)."""
    cfg = ModelConfig(n_neurons=256, n_real=16, dtype="float64")
    p = MapParams.create(13.0589, 0.1, dtype="float64")
    f_sharded = jax.jit(
        lambda z: event_driven_map_sharded(cfg, p, key, z, mesh8))(z_ref)
    f_plain = event_driven_map(cfg, p, key, z_ref)
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_plain), rtol=0, atol=1e-13)


def test_sharded_residual_under_vmap(params, key, z_ref, mesh8):
    """FD-Jacobian batching composes with the GSPMD constraint."""
    cfg = ModelConfig(n_neurons=256, n_real=8, dtype="float64")
    F = make_sharded_residual_fn(cfg, params, key, mesh8)
    pts = z_ref[None, :] + 1e-6 * jnp.eye(3, dtype=z_ref.dtype)
    out = jax.jit(jax.vmap(F))(pts)
    assert out.shape == (3, 3)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.slow
def test_sharded_newton_converges(params, key, z_ref, mesh8):
    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64")
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_epsilon=1e-7)
    res = jax.jit(lambda z: sharded_newton_solve(
        cfg, params, key, z, ncfg, mesh8))(z_ref)
    assert bool(res.converged)
    np.testing.assert_allclose(
        np.asarray(res.solution), [0.331, 0.6914, 1.3557], atol=0.05)


def test_sharded_map_with_windowed_evolve(params, key, z_ref, mesh8):
    """The batched windowed evolve (evolve_window > 0) must partition under
    GSPMD like the vmapped path: sharded == unsharded on the same config."""
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float64",
                      evolve_window=128)
    f_unsharded = event_driven_map(cfg, params, key, z_ref,
                                   evolve_backend="xla")
    f_sharded = jax.jit(
        lambda z: event_driven_map_sharded(cfg, params, key, z, mesh8))(z_ref)
    np.testing.assert_allclose(np.asarray(f_sharded),
                               np.asarray(f_unsharded), rtol=1e-12)
