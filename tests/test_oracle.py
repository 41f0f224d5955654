"""Native C++ fp64 oracle vs the JAX fp64 path.

The 1e-10 cross-validation demanded by BASELINE.md: two independently
written implementations of the full map (C++ thread-pool vs JAX lockstep
vmap) must agree to fp64 rounding at sigma = 0 (identical math, no RNG),
and both Newton solvers must land on the same fixed point.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, event_driven_map,
    make_residual_fn, newton_solve)

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable")

from armadillocudalinearinterpolation import oracle  # noqa: E402


def test_oracle_matches_jax_residual(cfg, params, key, z_ref):
    """sigma=0: identical math, independent code -> 1e-12 agreement."""
    f_cpp = oracle.compute_f(cfg, params, np.asarray(z_ref))
    f_jax = np.asarray(event_driven_map(cfg, params, key, z_ref))
    np.testing.assert_allclose(f_cpp, f_jax, rtol=0, atol=1e-12)


def test_oracle_diagnostics_match(cfg, params, key, z_ref):
    """Per-stage agreement: restricted positions and accept flags."""
    import ctypes
    from armadillocudalinearinterpolation.oracle import _load, _params
    lib = _load()
    p = _params(cfg, params, 0)
    Z = np.ascontiguousarray(np.asarray(z_ref), np.float64)
    f = np.empty(cfg.n_spikes, np.float64)
    pos = np.empty((cfg.n_real, cfg.n_spikes), np.float64)
    acc = np.empty(cfg.n_real, np.int32)
    lib.edmap_compute_f(ctypes.byref(p), Z, f,
                        pos.ctypes.data_as(ctypes.c_void_p),
                        acc.ctypes.data_as(ctypes.c_void_p))
    _, d = event_driven_map(cfg, params, key, z_ref, with_diagnostics=True)
    np.testing.assert_allclose(pos, np.asarray(d.positions), atol=1e-12)
    np.testing.assert_array_equal(acc.astype(bool), np.asarray(d.evolve.accept))


def test_oracle_newton_same_fixed_point(cfg, params, key, z_ref):
    res_cpp = oracle.newton_solve(cfg, params, np.asarray(z_ref),
                                  tol=1e-10, max_iterations=15, fd_eps=1e-7)
    assert res_cpp["converged"]
    F = make_residual_fn(cfg, params, key)
    res_jax = jax.jit(lambda z: newton_solve(
        F, z, NewtonConfig(tolerance=1e-10, max_iterations=15,
                           fd_epsilon=1e-7)))(z_ref)
    assert bool(res_jax.converged)
    np.testing.assert_allclose(res_cpp["solution"],
                               np.asarray(res_jax.solution), atol=1e-10)


def test_oracle_seeded_heterogeneity_deterministic(cfg, z_ref):
    p = MapParams.create(13.0589, 0.3, dtype="float64")
    Z = np.asarray(z_ref)
    fa = oracle.compute_f(cfg, p, Z, seed=7)
    fb = oracle.compute_f(cfg, p, Z, seed=7)
    fc = oracle.compute_f(cfg, p, Z, seed=8)
    np.testing.assert_array_equal(fa, fb)
    assert (fa != fc).any()


def test_oracle_thread_count_invariant(cfg, z_ref):
    """Counter-mode per-realisation seeding: result independent of pool size."""
    p = MapParams.create(13.0589, 0.3, dtype="float64")
    Z = np.asarray(z_ref)
    f1 = oracle.compute_f(cfg, p, Z, seed=3, n_threads=1)
    f4 = oracle.compute_f(cfg, p, Z, seed=3, n_threads=4)
    np.testing.assert_array_equal(f1, f4)
