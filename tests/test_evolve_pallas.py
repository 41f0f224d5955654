"""GPU evolve kernel (Pallas, Triton route) against the XLA evolve.

The kernel compiles only for a GPU.  On the CPU test mesh it runs through
the Pallas interpreter (an explicit ``interpret=True``), which checks its
logic — event loop, per-lane Newton, lowest-index argmin, bookkeeping,
padding, the firing log — against :func:`evolve_ensemble_batched`.  The
``gpu``-marked tests compile it for the card and skip elsewhere;
``chip_smoke.py`` phase 2 runs the same checks at the full widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, event_driven_map)
from armadillocudalinearinterpolation.model import emap
from armadillocudalinearinterpolation.model.evolve_batched import (
    evolve_ensemble_batched)
from armadillocudalinearinterpolation.model.evolve_pallas import (
    default_num_warps, evolve_ensemble_pallas)
from armadillocudalinearinterpolation.model.lift import (
    initial_spike_indices, lift)


def _pieces(n_neurons, n_real, sigma, seed=0):
    cfg = ModelConfig(n_neurons=n_neurons, n_real=n_real, dtype="float32",
                      max_events=1024)
    p = MapParams.create(13.0589, sigma, dtype="float32")
    Z = jnp.array([0.3310, 0.6914, 1.3557], jnp.float32)
    beta = emap.sample_beta(cfg, p, jax.random.PRNGKey(seed))
    v0, s0 = lift(cfg, p, emap.z_to_u(Z))
    return cfg, v0, s0, beta, initial_spike_indices(cfg, Z)


def _assert_same(rk, rx, atol=0.0):
    np.testing.assert_array_equal(np.asarray(rk.accept), np.asarray(rx.accept))
    np.testing.assert_array_equal(np.asarray(rk.n_events),
                                  np.asarray(rx.n_events))
    for f in ("last_ind", "crossed_ind"):
        np.testing.assert_array_equal(np.asarray(getattr(rk, f)),
                                      np.asarray(getattr(rx, f)))
    for f in ("last_time", "crossed_time"):
        np.testing.assert_allclose(np.asarray(getattr(rk, f)),
                                   np.asarray(getattr(rx, f)), rtol=0,
                                   atol=atol)


def test_auto_backend_selects_xla_on_cpu(cfg, params, key, z_ref):
    """'auto' must not attempt the GPU kernel on the CPU mesh."""
    f = event_driven_map(
        ModelConfig(n_neurons=512, n_real=2, dtype="float32"),
        MapParams.create(13.0589, 0.0, dtype="float32"),
        key, z_ref.astype(jnp.float32), evolve_backend="auto")
    assert np.isfinite(np.asarray(f)).all()


def test_invalid_backend_rejected(cfg, params, key, z_ref):
    with pytest.raises(ValueError, match="evolve_backend"):
        event_driven_map(cfg, params, key, z_ref, evolve_backend="cuda")


def test_pallas_backend_is_fp32_only(key, z_ref):
    with pytest.raises(ValueError, match="fp32-only"):
        event_driven_map(ModelConfig(n_neurons=512, n_real=2,
                                     dtype="float64"),
                         MapParams.create(13.0589, 0.0), key, z_ref,
                         evolve_backend="pallas")


@pytest.mark.parametrize("backend,dtype,evolve_backend,want", [
    ("gpu", "float32", "auto", True),
    ("gpu", "float64", "auto", False),
    ("gpu", "float32", "xla", False),
    ("gpu", "float32", "replay", False),
    ("cpu", "float32", "auto", False),
    ("cpu", "float32", "pallas", True),
])
def test_selector_under_faked_backend(monkeypatch, backend, dtype,
                                      evolve_backend, want):
    """'auto' takes the kernel exactly for fp32 maps on a GPU backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = ModelConfig(n_neurons=512, n_real=2, dtype=dtype)
    assert emap.select_pallas_evolve(cfg, evolve_backend) is want


def test_num_warps_sized_to_row():
    assert default_num_warps(256) == 4
    assert default_num_warps(512) == 4
    assert default_num_warps(1024) == 4
    assert default_num_warps(2048) == 8
    assert default_num_warps(4096) == 16
    assert default_num_warps(3000) == 16     # padded to 4096
    assert default_num_warps(16384) == 16


@pytest.mark.gpu
def test_pallas_matches_xla_on_gpu(gpu, z_ref):
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float32")
    params = MapParams.create(13.0589, 0.1, dtype="float32")
    key = jax.random.PRNGKey(0)
    z = z_ref.astype(jnp.float32)
    fp = event_driven_map(cfg, params, key, z, evolve_backend="pallas")
    fx = event_driven_map(cfg, params, key, z, evolve_backend="xla")
    np.testing.assert_allclose(np.asarray(fp), np.asarray(fx), atol=1e-5)


def test_evolve_window_validation():
    with pytest.raises(ValueError, match="evolve_window"):
        ModelConfig(n_neurons=512, n_real=2, evolve_window=100)
    with pytest.raises(ValueError, match="evolve_window"):
        ModelConfig(n_neurons=512, n_real=2, evolve_window=512)
    ModelConfig(n_neurons=512, n_real=2, evolve_window=256)  # ok


def test_pallas_interpret_matches_xla_on_cpu(pallas_interpret, z_ref):
    """The kernel's map residual against the XLA evolve's, and the windowed
    config (an XLA-only optimisation the kernel ignores) unchanged."""
    params = MapParams.create(13.0589, 0.1, dtype="float32")
    key = jax.random.PRNGKey(0)
    z = z_ref.astype(jnp.float32)
    cfg_f = ModelConfig(n_neurons=256, n_real=4, dtype="float32")
    cfg_w = ModelConfig(n_neurons=256, n_real=4, dtype="float32",
                        evolve_window=128)
    fx = event_driven_map(cfg_f, params, key, z, evolve_backend="xla")
    ff = event_driven_map(cfg_f, params, key, z, evolve_backend="pallas")
    fw = event_driven_map(cfg_w, params, key, z, evolve_backend="pallas")
    np.testing.assert_allclose(np.asarray(ff), np.asarray(fx), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ff), np.asarray(fw))


@pytest.mark.gpu
def test_windowed_matches_full_kernel_on_gpu(gpu, z_ref):
    """The kernel against the certified-window XLA evolve, on the card:
    same events, same bookkeeping."""
    cfg, v0, s0, beta, ind = _pieces(512, 32, 0.1)
    rk = evolve_ensemble_pallas(cfg, v0, s0, beta, ind)
    rx = evolve_ensemble_batched(cfg.with_(evolve_window=128), None, v0, s0,
                                 beta, ind)
    _assert_same(rk, rx, atol=1e-4)


@pytest.mark.parametrize("n_neurons,sigma,record", [
    (256, 0.0, 0),
    (256, 0.1, 0),
    (256, 0.1, 1024),
    (300, 0.1, 0),        # N padded to 512 inside the kernel
    (300, 0.1, 1000),     # firing log width that is not a power of two
    (512, 0.5, 1024),
    (512, 1.2, 0),        # strong heterogeneity: rows de-synchronise
])
def test_kernel_interpret_matches_batched(n_neurons, sigma, record):
    """Event for event against the XLA batched loop: identical discrete
    outcome and firing log, times to rounding (the interpreter and XLA
    fuse the same f32 formulas differently)."""
    cfg, v0, s0, beta, ind = _pieces(n_neurons, 3, sigma)
    out_k = evolve_ensemble_pallas(cfg, v0, s0, beta, ind, record,
                                   interpret=True)
    out_x = evolve_ensemble_batched(cfg, None, v0, s0, beta, ind,
                                    record_schedule=record)
    if record:
        (rk, sk), (rx, sx) = out_k, out_x
        assert sk.shape == (3, record) and sk.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(sk), np.asarray(sx))
    else:
        rk, rx = out_k, out_x
    _assert_same(rk, rx, atol=5e-5)


@pytest.mark.parametrize("n_real", [1, 5])
def test_kernel_any_ensemble_size(n_real):
    """One program per realisation: no block to pad R to."""
    cfg, v0, s0, beta, ind = _pieces(256, n_real, 0.1)
    rk = evolve_ensemble_pallas(cfg, v0, s0, beta, ind, interpret=True)
    assert rk.last_ind.shape == (n_real, 3)
    assert rk.accept.shape == (n_real,)
    rx = evolve_ensemble_batched(cfg, None, v0, s0, beta, ind)
    _assert_same(rk, rx, atol=5e-5)


def test_kernel_log_overflow_keeps_latest_event():
    """A firing log shorter than the event count keeps the batched loop's
    rule: the last column holds the latest event, n_events runs on."""
    cfg, v0, s0, beta, ind = _pieces(256, 2, 0.1)
    rk, sk = evolve_ensemble_pallas(cfg, v0, s0, beta, ind, 64,
                                    interpret=True)
    rx, sx = evolve_ensemble_batched(cfg, None, v0, s0, beta, ind,
                                     record_schedule=64)
    assert int(rk.n_events.min()) > 64
    np.testing.assert_array_equal(np.asarray(sk), np.asarray(sx))


def test_kernel_under_vmap_matches_per_point():
    """The FD Jacobian vmaps the map over points: the batching rule adds a
    grid axis and each point must equal its own call."""
    cfg, v0, s0, beta, ind = _pieces(256, 2, 0.1)
    scale = jnp.array([1.0, 1.001, 0.999], jnp.float32)
    v0s = v0[None, :] * scale[:, None]
    batched = jax.vmap(lambda v: evolve_ensemble_pallas(
        cfg, v, s0, beta, ind, interpret=True))(v0s)
    for i in range(3):
        one = evolve_ensemble_pallas(cfg, v0s[i], s0, beta, ind,
                                     interpret=True)
        _assert_same(jax.tree.map(lambda x: x[i], batched), one)
