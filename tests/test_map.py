"""Full-map tests: determinism, dtype-path agreement, residual structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, event_driven_map, make_residual_fn)


def test_map_residual_small_near_reference_fixed_point(cfg, params, key, z_ref):
    """Driver.cu:24's guess is near the fixed point: |F| should be small."""
    f = event_driven_map(cfg, params, key, z_ref)
    assert f.shape == (cfg.n_spikes,)
    assert np.all(np.abs(np.asarray(f)) < 0.05)


def test_map_deterministic_with_fixed_key(cfg, key, z_ref):
    """Common random numbers: same key => bitwise-identical residual
    (the reference's ResetSeed protocol, EventDrivenMap.cu:178)."""
    params = MapParams.create(13.0589, 0.5, dtype="float64")
    f1 = event_driven_map(cfg, params, key, z_ref)
    f2 = event_driven_map(cfg, params, key, z_ref)
    assert (np.asarray(f1) == np.asarray(f2)).all()
    f3 = event_driven_map(cfg, params, jax.random.split(key)[0], z_ref)
    assert (np.asarray(f1) != np.asarray(f3)).any()


def test_fp32_path_agrees_with_fp64_oracle(params, key, z_ref):
    """fp32 fast path vs fp64 oracle (SURVEY.md §7 hard-part 3)."""
    cfg64 = ModelConfig(n_neurons=512, n_real=2, dtype="float64")
    cfg32 = ModelConfig(n_neurons=512, n_real=2, dtype="float32")
    p32 = MapParams.create(13.0589, 0.0, dtype="float32")
    f64 = np.asarray(event_driven_map(cfg64, params, key, z_ref))
    f32 = np.asarray(event_driven_map(
        cfg32, p32, key, z_ref.astype(jnp.float32)))
    np.testing.assert_allclose(f32, f64, atol=5e-6)


def test_map_diagnostics_stages(cfg, params, key, z_ref):
    """Diagnostics mirror the reference's debug-dump stages
    (EventDrivenMap.cu:406-503)."""
    f, d = event_driven_map(cfg, params, key, z_ref, with_diagnostics=True)
    R, N, M = cfg.n_real, cfg.n_neurons, cfg.n_spikes
    assert d.v0.shape == d.s0.shape == (N,)
    assert d.init_ind.shape == (M,)
    assert d.evolve.last_ind.shape == (R, M)
    assert d.positions.shape == (R, M)
    assert d.u_mean.shape == (M,)
    assert float(d.accept_count) == R
    np.testing.assert_allclose(
        np.asarray(f),
        np.asarray(-z_ref[0] * jnp.concatenate([jnp.zeros(1), z_ref[1:]])
                   - d.u_mean + z_ref[0] * cfg.t_horizon))


def test_map_jits_and_vmaps(cfg, params, key, z_ref):
    """The FD-Jacobian batching pattern: vmap over perturbed points."""
    F = jax.jit(make_residual_fn(cfg, params, key))
    pts = z_ref[None, :] + 1e-6 * jnp.eye(3, dtype=z_ref.dtype)
    batched = jax.vmap(F)(pts)
    assert batched.shape == (3, 3)
    assert np.all(np.isfinite(np.asarray(batched)))


def test_map_generalizes_over_n_spikes(key):
    """The reference hardcodes noSpikes=3 (parameters.hpp:12); here n_spikes
    is a config axis.  A 2-spike map evaluates with accepted realisations."""
    cfg2 = ModelConfig(n_neurons=512, n_real=2, n_spikes=2, dtype="float64")
    p = MapParams.create(13.0589, 0.0, dtype="float64")
    f, d = event_driven_map(cfg2, p, key, jnp.array([0.33, 0.9]),
                            with_diagnostics=True)
    assert f.shape == (2,)
    assert np.isfinite(np.asarray(f)).all()
    assert float(d.accept_count) == 2.0
