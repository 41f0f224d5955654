"""Batched (array-level) evolve vs the vmapped reference path.

The windowed batched loop must be *exactly* equal to the vmapped while_loop
(same event order, same bookkeeping) — the window is certified per event
with full-evaluation fallback — and must stay forward-differentiable (the
f64 Newton stage takes jacfwd through it)."""

import jax
import jax.numpy as jnp
import numpy as np

from armadillocudalinearinterpolation import ModelConfig, MapParams
from armadillocudalinearinterpolation.model import emap as _emap


def _both(cfg0, cfgw, params, key, Z):
    f0, d0 = _emap.event_driven_map(cfg0, params, key, Z,
                                    with_diagnostics=True,
                                    evolve_backend="xla")
    fw, dw = _emap.event_driven_map(cfgw, params, key, Z,
                                    with_diagnostics=True,
                                    evolve_backend="xla")
    return f0, d0, fw, dw


def test_batched_windowed_matches_vmap_exactly(key, z_ref):
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    cfg0 = ModelConfig(n_neurons=512, n_real=8, dtype="float64")
    cfgw = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                       evolve_window=128)
    f0, d0, fw, dw = _both(cfg0, cfgw, params, key, z_ref)
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(fw))
    np.testing.assert_array_equal(np.asarray(d0.evolve.last_ind),
                                  np.asarray(dw.evolve.last_ind))
    np.testing.assert_array_equal(np.asarray(d0.evolve.crossed_time),
                                  np.asarray(dw.evolve.crossed_time))
    np.testing.assert_array_equal(np.asarray(d0.evolve.n_events),
                                  np.asarray(dw.evolve.n_events))
    np.testing.assert_array_equal(np.asarray(d0.evolve.accept),
                                  np.asarray(dw.evolve.accept))


def test_batched_windowed_jacfwd(key, z_ref):
    """Exact forward-mode Jacobians flow through the batched windowed loop
    (the lax.cond fallback included)."""
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    cfg0 = ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                       root_tol=1e-13)
    cfgw = cfg0.with_(evolve_window=128)
    J0 = jax.jacfwd(lambda z: _emap.event_driven_map(
        cfg0, params, key, z, evolve_backend="xla"))(z_ref)
    Jw = jax.jacfwd(lambda z: _emap.event_driven_map(
        cfgw, params, key, z, evolve_backend="xla"))(z_ref)
    np.testing.assert_allclose(np.asarray(Jw), np.asarray(J0),
                               rtol=1e-10, atol=1e-12)


def test_batched_window_fallback_stays_exact(key):
    """A window too small for the spike spread forces the certificate's
    full-evaluation fallback — results must STILL match the vmapped path
    exactly (the window is a performance knob, never a semantics knob)."""
    from armadillocudalinearinterpolation.model.coupling import (
        coupling_kernel)
    from armadillocudalinearinterpolation.model.evolve import (
        evolve_ensemble)
    from armadillocudalinearinterpolation.model.evolve_batched import (
        evolve_ensemble_batched)
    from armadillocudalinearinterpolation.model.lift import lift
    from armadillocudalinearinterpolation.model import emap as _emap

    cfg = ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                      evolve_window=128)
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    # spike positions spread far beyond one 128-lane window
    U = jnp.array([0.3262, 0.0, 0.7194, 1.3690], jnp.float64)
    v0, s0 = lift(cfg, params, U)
    beta = 13.0589 + 0.1 * jax.random.normal(key, (4, 512), jnp.float64)
    init_ind = jnp.array([420, 256, 60], jnp.int32)  # spread 360 >> window

    w = coupling_kernel(cfg)
    r_v = evolve_ensemble(cfg, w, v0, s0, beta, init_ind)
    r_b = evolve_ensemble_batched(cfg, w, v0, s0, beta, init_ind)
    np.testing.assert_array_equal(np.asarray(r_v.last_ind),
                                  np.asarray(r_b.last_ind))
    np.testing.assert_array_equal(np.asarray(r_v.last_time),
                                  np.asarray(r_b.last_time))
    np.testing.assert_array_equal(np.asarray(r_v.crossed_time),
                                  np.asarray(r_b.crossed_time))
    np.testing.assert_array_equal(np.asarray(r_v.n_events),
                                  np.asarray(r_b.n_events))
