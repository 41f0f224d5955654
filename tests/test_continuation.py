"""Pseudo-arclength continuation: bordered system, tangents, branch walk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import ModelConfig, NewtonConfig
from armadillocudalinearinterpolation.analysis.continuation import (
    continue_branch, initial_tangent, next_tangent, make_extended_residual,
    arclength_step)


def test_initial_and_next_tangent():
    t0 = initial_tangent(3, 1.0)
    assert t0.shape == (4,)
    np.testing.assert_allclose(np.asarray(t0), [0, 0, 0, 1])
    # secant keeps orientation
    y0 = jnp.zeros(4)
    y1 = jnp.array([0.0, 0.0, 0.0, -0.5])
    t1 = next_tangent(y1, y0, t0)
    assert float(jnp.dot(t1, t0)) > 0  # flipped to keep walking the same way
    np.testing.assert_allclose(float(jnp.linalg.norm(t1)), 1.0, rtol=1e-12)


def test_extended_residual_has_arc_row(cfg, key, z_ref):
    G = make_extended_residual(cfg, key, 0.0)
    y = jnp.concatenate([z_ref, jnp.asarray(13.0589)[None]])
    t = initial_tangent(3, 1.0)
    g = G(y, y, t, jnp.asarray(0.0))
    assert g.shape == (4,)
    # at ds=0 and y=y_prev the arc row vanishes identically
    assert float(g[-1]) == 0.0


def test_arclength_walks_branch(cfg, key):
    """A few steps along the known branch: beta increases, points converge,
    and the wave speed grows with beta (matches the natural-sweep artifact)."""
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    steps = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=3)
    assert len(steps) == 3
    betas = [float(s.y[-1]) for s in steps]
    assert betas[0] > 13.0589 and betas == sorted(betas)
    assert all(float(s.residual_norm) < 1e-8 for s in steps)
    cs = [float(s.y[0]) for s in steps]
    assert cs == sorted(cs)  # dc/dbeta > 0 on this stretch


def test_arclength_step_rejects_then_shrinks(cfg, key):
    """An absurd step size fails the corrector; continue_branch must retry
    with a smaller ds rather than emit an unconverged point."""
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    steps = continue_branch(cfg, key, Z0, 13.0589, ds=50.0, n_steps=1,
                            ncfg=NewtonConfig(tolerance=1e-9,
                                              max_iterations=6,
                                              fd_mode="exact"))
    # either it converged after shrinking, or gave up cleanly — never a
    # non-finite / unconverged accepted step
    for s in steps:
        assert bool(s.converged)
        assert np.isfinite(np.asarray(s.y)).all()


def test_cli_arclength(capsys, tmp_path):
    from armadillocudalinearinterpolation.cli.driver import main
    # no --quiet: per-step progress lines are the thing being asserted
    # (the --quiet contract suppresses them, uniformly across walkers)
    rc = main(["--neurons", "512", "--realisations", "4",
               "--dtype", "float64", "--cpu",
               "--guess", "0.32623663", "0.71936722", "1.36899475",
               "--arclength", "--ds", "0.3", "--steps", "2",
               "--fd-mode", "exact", "--tol", "1e-9",
               "--checkpoint", str(tmp_path / "arc")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arc step 0" in out and "arc step 1" in out
    from armadillocudalinearinterpolation.utils.checkpoint import (
        ContinuationCheckpoint)
    steps = ContinuationCheckpoint(tmp_path / "arc").load_all()
    assert len(steps) == 2 and steps[-1].beta > 13.0589


def test_arclength_in_sigma(cfg, key):
    """Continuation in the heterogeneity std-dev (the reference's
    commented-out experiment direction, Driver.cu:76-84): walk sigma up
    from the homogeneous fixed point at fixed beta."""
    from armadillocudalinearinterpolation.analysis.continuation import (
        continue_branch)
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    steps = continue_branch(cfg, key, Z0, 13.0589, sigma=0.0, param="sigma",
                            ds=0.2, n_steps=2)
    assert len(steps) == 2
    sigmas = [float(s.y[-1]) for s in steps]
    assert sigmas[0] > 0.0 and sigmas == sorted(sigmas)
    assert all(float(s.residual_norm) < 1e-8 for s in steps)


def test_arclength_jit_cache_reuse_and_identity_guard(cfg, key):
    """A shared jit_cache walks twice without re-tracing (the enumerator's
    pattern) and rejects a cache built for a different walk setup."""
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    cache = {}
    s1 = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=1,
                         jit_cache=cache)
    assert len(s1) == 1 and bool(s1[0].converged)
    step_obj = cache["step"]
    s2 = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=1,
                         direction=-1.0, jit_cache=cache)
    assert cache["step"] is step_obj          # program reused, not rebuilt
    assert len(s2) == 1 and bool(s2[0].converged)
    assert float(s2[0].y[-1]) < 13.0589 < float(s1[0].y[-1])

    with pytest.raises(ValueError, match="jit_cache"):
        continue_branch(cfg, key, Z0, 13.0589, sigma=0.5, n_steps=1,
                        jit_cache=cache)      # different held value


@pytest.mark.slow
def test_arclength_frozen_corrector_matches_exact(cfg, key):
    """fd_mode="frozen" routes the walk through the fused frozen-outcome FD
    corrector (one schedule pass + one batched 9-point replay per corrector
    iteration, no jacfwd).  On the same branch it must accept the same
    points as the exact-mode corrector to deep agreement — the frozen map
    is the smooth piece exact mode differentiates."""
    Z0 = jnp.array([0.32623663, 0.71936722, 1.36899475], jnp.float64)
    ncfg_x = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    ncfg_f = NewtonConfig(tolerance=1e-9, max_iterations=12,
                          fd_mode="frozen", fd_epsilon=1e-5)
    ref = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=2,
                          ncfg=ncfg_x, evolve_backend="replay")
    froz = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=2,
                           ncfg=ncfg_f)
    assert len(froz) == len(ref) == 2
    for a, b in zip(froz, ref):
        assert bool(a.converged)
        assert float(a.residual_norm) <= 1e-9
        np.testing.assert_allclose(np.asarray(a.y), np.asarray(b.y),
                                   atol=5e-8)

    # "frozen-fwd" — the staged solver's DEFAULT stencil — must route to
    # the same corrector instead of falling through to the generic solver
    # and raising (round-3 review finding).  The bordered corrector always
    # differences its central stencil, so one step suffices as the guard.
    ncfg_ff = NewtonConfig(tolerance=1e-9, max_iterations=12,
                           fd_mode="frozen-fwd", fd_epsilon=1e-5)
    ff = continue_branch(cfg, key, Z0, 13.0589, ds=0.3, n_steps=1,
                         ncfg=ncfg_ff)
    assert bool(ff[0].converged)
    np.testing.assert_allclose(np.asarray(ff[0].y), np.asarray(ref[0].y),
                               atol=5e-8)


def test_generic_solvers_reject_frozen_mode():
    """fd_mode="frozen" must fail loudly in the generic solvers instead of
    silently taking the forward-FD branch."""
    from armadillocudalinearinterpolation import (newton_solve,
                                                      newton_solve_host)
    F = lambda x: x * x - 2.0
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=5, fd_mode="frozen")
    with pytest.raises(ValueError, match="frozen"):
        newton_solve(F, jnp.ones((1,)), ncfg)
    with pytest.raises(ValueError, match="frozen"):
        newton_solve_host(F, jnp.ones((1,)), ncfg)
