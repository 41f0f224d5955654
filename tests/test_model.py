"""Model-stage tests: coupling table, lift profiles, event times, evolve
bookkeeping, restriction — mirroring the reference's per-stage debug dumps
(SURVEY.md §4) with property assertions instead of golden files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, coupling_kernel, mexican_hat, lift,
    initial_spike_indices, event_time, evolve, evolve_ensemble,
    restrict_positions, masked_ensemble_mean, z_to_u, u_to_z,
)
from armadillocudalinearinterpolation.model.coupling import coupling_row
from armadillocudalinearinterpolation.model.events import (
    membrane_fun, fire_decision)
from armadillocudalinearinterpolation.model.evolve import EvolveResult


# ---------------------------------------------------------------- coupling

def test_coupling_matches_direct_circshift_construction(cfg):
    """Table equals the reference's sample-then-circshift(N/2) construction."""
    n, L = cfg.n_neurons, cfg.half_width
    dx = 2 * L / n
    x = -L + dx * np.arange(n)
    w_ref = (11.0 * np.exp(-5.0 * np.abs(x)) - 7.0 * np.exp(-3.5 * np.abs(x))) * dx
    w_ref = np.roll(w_ref, -(n // 2))  # circshift left by N/2
    np.testing.assert_allclose(np.asarray(coupling_kernel(cfg)), w_ref, rtol=1e-12)


def test_coupling_is_ring_distance_kernel(cfg):
    """w[k] == dx * mexhat(min(k, N-k) * dx) — even in index distance."""
    w = np.asarray(coupling_kernel(cfg))
    n = cfg.n_neurons
    k = np.arange(n)
    dist = np.minimum(k, n - k) * cfg.dx
    want = np.asarray(mexican_hat(jnp.asarray(dist), cfg)) * cfg.dx
    np.testing.assert_allclose(w, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(w[1:], w[1:][::-1], rtol=1e-12)  # evenness


def test_coupling_row_equals_abs_index_gather(cfg):
    """roll-based row == the reference's w[|i-j|] gather (EventDrivenMap.cu:617)."""
    w = coupling_kernel(cfg)
    i = np.arange(cfg.n_neurons)
    for j in [0, 1, 255, 256, 511]:
        row = np.asarray(coupling_row(w, jnp.int32(j)))
        want = np.asarray(w)[np.abs(i - j)]
        np.testing.assert_allclose(row, want, rtol=1e-12)


# ---------------------------------------------------------------- lift

def test_lift_profiles_are_physical(cfg, params, z_ref):
    v, s = lift(cfg, params, z_to_u(z_ref))
    assert v.shape == s.shape == (cfg.n_neurons,)
    assert np.all(np.isfinite(np.asarray(v)))
    assert np.all(np.isfinite(np.asarray(s)))
    # voltage clamp: v strictly below threshold everywhere (EventDrivenMap.cu:538)
    assert np.all(np.asarray(v) < cfg.vth)
    # synaptic field must be positive somewhere (wave carries activity)
    assert np.asarray(s).max() > 0


def test_initial_spike_indices_match_reference_scan(cfg, z_ref):
    """Vectorised seeding == the reference's downward host scan
    (EventDrivenMap.cu:361-376)."""
    Z = np.asarray(z_ref)
    n, L = cfg.n_neurons, cfg.half_width
    ind_ref = np.zeros(cfg.n_spikes, np.int32)
    ind_ref[0] = n // 2
    for m in range(1, cfg.n_spikes):
        for i in range(ind_ref[m - 1], 0, -1):
            if -L + (2 * i * L / n) < -Z[0] * Z[m]:
                ind_ref[m] = i
                break
    got = np.asarray(initial_spike_indices(cfg, z_ref))
    np.testing.assert_array_equal(got, ind_ref)


# ---------------------------------------------------------------- events

def test_event_time_is_true_root(cfg, params):
    """For firing neurons, event_time returns a root of the membrane residual."""
    rng = np.random.default_rng(0)
    v0 = jnp.asarray(rng.uniform(0.0, 0.99, 64))
    s0 = jnp.asarray(rng.uniform(0.5, 5.0, 64))
    beta = jnp.full((64,), 13.0589)
    t = event_time(v0, s0, beta, cfg)
    fires = np.asarray(fire_decision(v0, s0, beta, cfg))
    f_at_t = np.asarray(membrane_fun(t, v0, s0, beta, cfg))
    assert fires.any()
    assert np.all(np.abs(f_at_t[fires]) <= 10 * cfg.root_tol)
    assert np.all(np.asarray(t)[fires] >= 0)


def test_event_time_sentinel_for_nonfiring(cfg):
    """Non-firers return the +100 sentinel (EventDrivenMap.cu:571), including
    the negative-s0 NaN-power path."""
    beta = jnp.asarray(13.0589)
    t = event_time(jnp.asarray(0.1), jnp.asarray(-0.5), beta, cfg)
    assert float(t) == pytest.approx(100.0)
    t2 = event_time(jnp.asarray(0.0), jnp.asarray(1e-8), beta, cfg)
    assert float(t2) >= 100.0


# ---------------------------------------------------------------- evolve

@pytest.fixture(scope="module")
def evolved(cfg, params, z_ref, key):
    from armadillocudalinearinterpolation.model.emap import sample_beta
    U = z_to_u(z_ref)
    v0, s0 = lift(cfg, params, U)
    w = coupling_kernel(cfg)
    init_ind = initial_spike_indices(cfg, z_ref)
    beta = sample_beta(cfg, params, key)
    return evolve_ensemble(cfg, w, v0, s0, beta, init_ind)


def test_evolve_accepts_and_brackets_horizon(cfg, evolved):
    res = evolved
    accept = np.asarray(res.accept)
    assert accept.all()  # physical regime: every realisation completes
    last_t = np.asarray(res.last_time)
    crossed_t = np.asarray(res.crossed_time)
    # last event strictly before T, crossing strictly after (EvolveKernel :630-644)
    assert (last_t <= cfg.t_horizon).all()
    assert (crossed_t > cfg.t_horizon).all()
    assert (crossed_t <= 2 * cfg.t_horizon).all()
    assert (last_t >= 0).all()


def test_evolve_spikes_travel_right(cfg, evolved):
    """Wave speed c > 0: crossing sites sit right of the initial sites."""
    res = evolved
    assert (np.asarray(res.crossed_ind) > np.asarray(res.last_ind)).all()


def test_evolve_homogeneous_realisations_identical(cfg, evolved):
    """sigma = 0 -> all realisations are bitwise identical."""
    for field in ["last_ind", "last_time", "crossed_ind", "crossed_time"]:
        arr = np.asarray(getattr(evolved, field))
        assert (arr == arr[0]).all()


# ---------------------------------------------------------------- restrict

def test_restrict_interpolates_between_bracketing_positions(cfg, evolved):
    pos = np.asarray(restrict_positions(cfg, evolved))
    x0 = -cfg.half_width + cfg.dx * np.asarray(evolved.last_ind)
    x1 = -cfg.half_width + cfg.dx * np.asarray(evolved.crossed_ind)
    lo = np.minimum(x0, x1)
    hi = np.maximum(x0, x1)
    assert (pos >= lo).all() and (pos <= hi).all()


def test_masked_mean_excludes_rejected():
    pos = jnp.asarray([[1.0, 2.0], [100.0, 200.0], [3.0, 4.0]])
    accept = jnp.asarray([True, False, True])
    mean, count = masked_ensemble_mean(pos, accept)
    np.testing.assert_allclose(np.asarray(mean), [2.0, 3.0])
    assert float(count) == 2.0


def test_masked_mean_zero_accept_is_nan():
    """Division by zero accepted realisations fails loudly (NaN), matching
    the reference's average/accept[0] semantics."""
    mean, count = masked_ensemble_mean(jnp.ones((3, 2)), jnp.zeros(3, bool))
    assert float(count) == 0.0
    assert np.isnan(np.asarray(mean)).all()


# ---------------------------------------------------------------- gauge maps

def test_gauge_roundtrip(z_ref):
    U = z_to_u(z_ref)
    assert U.shape == (4,)
    assert float(U[1]) == 0.0
    np.testing.assert_allclose(np.asarray(u_to_z(U)), np.asarray(z_ref))


def test_pipeline_generalizes_over_n_spikes(key):
    """The whole pipeline is generic in n_spikes (the reference hardcodes
    noSpikes=3 at compile time, parameters.hpp:12): shapes and finiteness
    for M=2 and M=5."""
    from armadillocudalinearinterpolation import (
        ModelConfig, MapParams, event_driven_map)
    for m, guess in [(2, [0.33, 0.7]), (5, [0.33, 0.5, 1.0, 1.5, 2.0])]:
        cfg = ModelConfig(n_neurons=512, n_real=2, n_spikes=m,
                          dtype="float64")
        params = MapParams.create(13.0589, 0.0, dtype="float64")
        f, diag = event_driven_map(cfg, params, key,
                                   jnp.asarray(guess, jnp.float64),
                                   with_diagnostics=True)
        assert f.shape == (m,)
        if not bool(jnp.all(jnp.isfinite(f))):
            # a NaN residual is legal ONLY as the documented loud failure:
            # zero accepted realisations at a non-physical guess
            assert float(diag.accept_count) == 0.0
        else:
            assert float(diag.accept_count) > 0.0
