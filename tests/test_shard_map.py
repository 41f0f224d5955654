"""Explicit shard_map ensemble path (the Pallas-compatible multi-chip route)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, event_driven_map, newton_solve)
from armadillocudalinearinterpolation.parallel import (
    make_mesh, make_shard_map_residual_fn)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"real": 8})


def test_shard_map_exact_at_sigma_zero(key, z_ref, mesh8):
    """sigma=0: per-device draws are irrelevant -> matches unsharded to
    reduction-order rounding."""
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float64")
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    F = jax.jit(make_shard_map_residual_fn(cfg, params, key, mesh8))
    f_s = np.asarray(F(z_ref))
    f_u = np.asarray(event_driven_map(cfg, params, key, z_ref))
    np.testing.assert_allclose(f_s, f_u, rtol=0, atol=1e-13)


def test_shard_map_heterogeneous_deterministic(key, z_ref, mesh8):
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float64")
    params = MapParams.create(13.0589, 0.2, dtype="float64")
    F = jax.jit(make_shard_map_residual_fn(cfg, params, key, mesh8))
    a, b = np.asarray(F(z_ref)), np.asarray(F(z_ref))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()


def test_shard_map_honors_replay_backend(key, z_ref, mesh8):
    """evolve_backend="replay" must actually run the df64 replay per shard
    (it used to be silently dropped -> plain cfg-dtype XLA evolve); at
    sigma=0 the sharded replay must match the unsharded replay exactly.

    The unsharded reference is JITTED: XLA's whole-program simplifier
    rewrites some df64 chain that eager op-by-op dispatch leaves alone
    (measured drift ~5e-13 in crossing times, within the replay's
    contract), while shard_map-vs-plain-jit replay times agree BITWISE —
    so compiled-vs-compiled is the apples-to-apples comparison, leaving
    only the ensemble mean's reduction order (psum tree vs flat sum)."""
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float64")
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    F = jax.jit(make_shard_map_residual_fn(cfg, params, key, mesh8,
                                           evolve_backend="replay"))
    f_s = np.asarray(F(z_ref))
    f_rep = np.asarray(jax.jit(
        lambda z: event_driven_map(cfg, params, key, z,
                                   evolve_backend="replay"))(z_ref))
    f_xla = np.asarray(event_driven_map(cfg, params, key, z_ref))
    np.testing.assert_allclose(f_s, f_rep, rtol=0, atol=1e-13)
    # and it really is the replay, not the f64 XLA path: the two backends
    # differ at the replay's noise floor, well above reduction rounding
    assert float(np.max(np.abs(f_s - f_xla))) > 1e-13


def test_shard_map_rejects_indivisible_ensemble(key, mesh8):
    cfg = ModelConfig(n_neurons=512, n_real=10, dtype="float64")
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    with pytest.raises(ValueError, match="must divide"):
        make_shard_map_residual_fn(cfg, params, key, mesh8)


@pytest.mark.slow
def test_frozen_stencil_sharded_matches_unsharded(key, z_ref, mesh8):
    """The fused frozen-FD stencil replay with its flat stencil*R row axis
    sharded over the mesh (GSPMD constraint, zero in-loop collectives) must
    match the unsharded launch to reduction-order rounding — and a
    mesh-sharded ``newton_solve_frozen`` must converge to the same root as
    the unsharded one.  This is the multi-chip form of the staged solver's
    accurate stage (the stencil spreads over the mesh like extra realisations)."""
    from armadillocudalinearinterpolation.model.emap import (
        compute_discrete_outcome, frozen_schedule_map_batched)
    from armadillocudalinearinterpolation.solvers.staged import (
        newton_solve_frozen)

    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    sched, n_ev, ii = jax.jit(
        lambda z: compute_discrete_outcome(cfg, params, key, z))(z_ref)
    e = 1e-5 * jnp.eye(3, dtype=jnp.float64)
    pts = jnp.concatenate([z_ref[None], z_ref[None] + e, z_ref[None] - e])
    f_u = jax.jit(lambda p: frozen_schedule_map_batched(
        cfg, params, key, p, sched, n_ev, ii))(pts)
    f_s = jax.jit(lambda p: frozen_schedule_map_batched(
        cfg, params, key, p, sched, n_ev, ii, row_mesh=mesh8))(pts)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_u),
                               rtol=0, atol=1e-13)

    ncfg = NewtonConfig(tolerance=5e-8, max_iterations=8,
                        fd_mode="frozen", fd_epsilon=1e-5)
    res_s = newton_solve_frozen(cfg, params, key, z_ref, ncfg, mesh=mesh8)
    res_u = newton_solve_frozen(cfg, params, key, z_ref, ncfg)
    assert bool(res_s.converged) and bool(res_u.converged)
    np.testing.assert_allclose(np.asarray(res_s.solution),
                               np.asarray(res_u.solution), atol=1e-8)


@pytest.mark.slow
def test_staged_solve_sharded_matches_unsharded(key, z_ref, mesh8):
    """newton_solve_staged(mesh=...): the WHOLE hybrid-precision recipe
    with the ensemble GSPMD-sharded (fp32 stage, fused frozen stencil,
    polish) must find the same root as the unsharded call — GSPMD
    partitions the same traced programs, so only reduction-order rounding
    differs."""
    from armadillocudalinearinterpolation import newton_solve_staged

    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    ncfg2 = NewtonConfig(tolerance=5e-7, max_iterations=6,
                         fd_mode="frozen", fd_epsilon=1e-5)
    cache = {}
    res_s = newton_solve_staged(cfg, params, key, z_ref, tolerance=1e-7,
                                stage2_ncfg=ncfg2, mesh=mesh8,
                                jit_cache=cache)
    res_u = newton_solve_staged(cfg, params, key, z_ref, tolerance=1e-7,
                                stage2_ncfg=ncfg2)
    assert bool(res_s.converged) and bool(res_u.converged)
    np.testing.assert_allclose(np.asarray(res_s.solution),
                               np.asarray(res_u.solution), atol=1e-7)
    # a cache built WITH a mesh must reject a meshless call (the identity
    # check raises before any compute)
    with pytest.raises(ValueError, match="different"):
        newton_solve_staged(cfg, params, key, z_ref, tolerance=1e-7,
                            stage2_ncfg=ncfg2, jit_cache=cache)


@pytest.mark.slow
def test_arclength_frozen_corrector_sharded(key, mesh8):
    """The fused frozen-outcome arclength corrector with its stencil rows
    mesh-sharded must accept the same point as the unsharded corrector
    (GSPMD, same traced program)."""
    from armadillocudalinearinterpolation.analysis.continuation import (
        initial_tangent, make_arclength_step_frozen)

    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                        fd_mode="frozen", fd_epsilon=1e-5)
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    y0 = jnp.concatenate([Z0, jnp.asarray([13.0589], jnp.float64)])
    tangent = initial_tangent(3, +1.0, jnp.float64)
    step_u = make_arclength_step_frozen(cfg, key, 0.0, "beta", ncfg)
    step_s = make_arclength_step_frozen(cfg, key, 0.0, "beta", ncfg,
                                        mesh=mesh8)
    r_u = step_u(y0, tangent, 0.3)
    r_s = step_s(y0, tangent, 0.3)
    assert bool(r_u.converged) and bool(r_s.converged)
    np.testing.assert_allclose(np.asarray(r_s.solution),
                               np.asarray(r_u.solution), atol=5e-9)


@pytest.mark.slow
def test_shard_map_newton_converges(key, z_ref, mesh8):
    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64")
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    F = make_shard_map_residual_fn(cfg, params, key, mesh8)
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_epsilon=1e-7)
    res = jax.jit(lambda z: newton_solve(F, z, ncfg))(z_ref)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.solution),
                               [0.331, 0.6914, 1.3557], atol=0.05)


def test_shard_map_pallas_interpret_on_virtual_mesh(key, z_ref, mesh8,
                                                    pallas_interpret):
    """The GPU evolve kernel under ``shard_map`` on a MULTI-device mesh.
    Here the kernel runs through the Pallas interpreter (plain XLA ops, so
    shard_map can partition it) on the 8-device virtual CPU mesh.  At
    sigma=0 the per-device key folds are irrelevant, so the sharded kernel
    map must match the unsharded interpret-mode kernel map to f32
    reduction-order rounding.  N=512 keeps the map in its physical regime
    (at N=256 it sits far from any wave, where the event-time roots'
    root_tol quantisation shows through the residual)."""
    cfg = ModelConfig(n_neurons=512, n_real=16, dtype="float32")
    params = MapParams.create(13.0589, 0.0, dtype="float32")
    z = z_ref.astype(jnp.float32)
    F = jax.jit(make_shard_map_residual_fn(cfg, params, key, mesh8,
                                           evolve_backend="pallas"))
    f_s = np.asarray(F(z))
    f_u = np.asarray(jax.jit(
        lambda zz: event_driven_map(cfg, params, key, zz,
                                    evolve_backend="pallas"))(z))
    assert np.isfinite(f_s).all()
    np.testing.assert_allclose(f_s, f_u, rtol=0, atol=2e-6)
