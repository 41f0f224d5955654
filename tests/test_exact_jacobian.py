"""Exact forward-mode Jacobian: IFT custom-JVP at the event-time root,
``jacfwd`` through the full map, the "exact" Newton mode, the host-driven
solver, and the small dense solve (all on the CPU fp64 oracle path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, make_residual_fn,
    newton_solve, newton_solve_host)
from armadillocudalinearinterpolation.model import emap as _emap
from armadillocudalinearinterpolation.model.events import (
    event_time, fire_decision, membrane_fun)
from armadillocudalinearinterpolation.model.lift import lift
from armadillocudalinearinterpolation.solvers.newton import (
    central_fd_jacobian)
from armadillocudalinearinterpolation.solvers.linalg import solve_dense


@pytest.fixture(scope="module")
def tight_cfg():
    # Tight root tolerance so FD-vs-JVP comparisons aren't limited by the
    # inner Newton's stopping error.
    return ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                       root_tol=1e-13)


def _firing_state(tight_cfg):
    """A lifted state with a healthy mix of firing / non-firing lanes."""
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    U = jnp.array([0.3262, 0.0, 0.7194, 1.3690], jnp.float64)
    v0, s0 = lift(tight_cfg, params, U)
    beta = jnp.full_like(v0, 13.0589)
    return v0, s0, beta


def test_event_time_jvp_matches_fd_on_firing_lanes(tight_cfg):
    v0, s0, beta = _firing_state(tight_cfg)
    dec = np.asarray(fire_decision(v0, s0, beta, tight_cfg))
    assert dec.any() and not dec.all()  # mix of firers and non-firers

    eps = 1e-7
    for argi in range(3):
        args = [v0, s0, beta]

        def f(x, argi=argi, args=args):
            a = list(args)
            a[argi] = x
            return event_time(*a, tight_cfg)

        x = args[argi]
        fd = (f(x + eps) - f(x - eps)) / (2 * eps)
        jv = jax.jvp(f, (x,), (jnp.ones_like(x),))[1]
        # compare on lanes where the FD stencil stays on one smooth branch:
        # the fire decision must hold at BOTH perturbed points, not just at
        # x (which would be tautologically equal to `dec` — a lane whose
        # decision flips inside the stencil differences against the +100
        # no-fire sentinel and produces an O(1/eps) garbage quotient)
        def dec_at(xp, argi=argi, args=args):
            a = list(args)
            a[argi] = xp
            return np.asarray(fire_decision(*a, tight_cfg))

        both = dec & dec_at(x + eps) & dec_at(x - eps)
        assert both.any()   # the guard must leave something to compare
        np.testing.assert_allclose(np.asarray(jv)[both], np.asarray(fd)[both],
                                   rtol=1e-5, atol=1e-7)
        # non-firers: constant sentinel, zero tangent
        assert np.all(np.asarray(jv)[~dec] == 0.0)


def test_event_time_jvp_is_ift_consistent(tight_cfg):
    """The tangent satisfies the linearised root equation
    f_t * dt + f_v * dv = 0 at the converged root."""
    v0, s0, beta = _firing_state(tight_cfg)
    dec = np.asarray(fire_decision(v0, s0, beta, tight_cfg))
    t, dt = jax.jvp(lambda v: event_time(v, s0, beta, tight_cfg),
                    (v0,), (jnp.ones_like(v0),))
    # on firing lanes the primal is the root itself: f(t) ~ 0
    resid = np.asarray(membrane_fun(t, v0, s0, beta, tight_cfg))
    assert np.max(np.abs(resid[dec])) < 1e-10


def test_jacfwd_map_matches_central_fd(tight_cfg):
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    key = jax.random.PRNGKey(0)
    F = make_residual_fn(tight_cfg, params, key, evolve_backend="xla")
    Z = jnp.array([0.3262, 0.7194, 1.3690], jnp.float64)
    J_exact = jax.jacfwd(F)(Z)
    J_fd = central_fd_jacobian(F, Z, 1e-7)
    np.testing.assert_allclose(np.asarray(J_exact), np.asarray(J_fd),
                               atol=5e-7)


def test_newton_exact_mode_converges(tight_cfg):
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    key = jax.random.PRNGKey(0)
    F = make_residual_fn(tight_cfg, params, key, evolve_backend="xla")
    ncfg = NewtonConfig(tolerance=1e-10, max_iterations=10, fd_mode="exact")
    res = jax.jit(lambda z: newton_solve(F, z, ncfg))(
        jnp.array([0.3310, 0.6914, 1.3557], jnp.float64))
    assert bool(res.converged)
    assert float(res.residual_norm) < 1e-10
    # quadratic tail: last pre-convergence step gains > 3 digits
    h = np.asarray(res.residual_history)
    it = int(res.iterations)
    assert h[it - 1] / max(h[it], 1e-16) > 1e3


def test_host_solver_matches_fused_solver(tight_cfg):
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    key = jax.random.PRNGKey(0)
    F = make_residual_fn(tight_cfg, params, key, evolve_backend="xla")
    Z0 = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)
    ncfg = NewtonConfig(tolerance=1e-10, max_iterations=10, fd_epsilon=1e-7)
    fused = jax.jit(lambda z: newton_solve(F, z, ncfg))(Z0)
    hosted = newton_solve_host(F, Z0, ncfg)
    assert bool(hosted.converged)
    np.testing.assert_allclose(np.asarray(hosted.solution),
                               np.asarray(fused.solution), rtol=1e-9)
    # serial-FD variant takes the identical FD stencil -> identical path
    serial = newton_solve_host(F, Z0, ncfg, serial_fd=True)
    np.testing.assert_allclose(np.asarray(serial.solution),
                               np.asarray(hosted.solution), rtol=1e-12)


def test_solve_dense_matches_numpy():
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 6):
        A = rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        x = solve_dense(jnp.asarray(A), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   rtol=1e-10, atol=1e-12)
    # multi-rhs + jit + pivoting stress (leading zero pivot)
    A = jnp.array([[0.0, 1.0], [1.0, 0.0]])
    B = jnp.array([[1.0, 2.0], [3.0, 4.0]])
    X = jax.jit(solve_dense)(A, B)
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(A, B))


def test_frozen_jacobian_polish_quadratic():
    from armadillocudalinearinterpolation import frozen_jacobian_polish
    F = lambda x: x * x - jnp.array([4.0, 9.0])
    x0 = jnp.array([2.1, 3.1])
    J = jax.jacfwd(F)(x0)
    res = frozen_jacobian_polish(F, x0, J, max_iterations=20, tolerance=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.solution), [2.0, 3.0],
                               rtol=1e-8)
    # keep-best: reported norm is the norm AT the returned solution
    assert float(jnp.linalg.norm(F(res.solution))) == pytest.approx(
        float(res.residual_norm))


def test_frozen_jacobian_polish_keeps_best_on_noisy_residual():
    from armadillocudalinearinterpolation import frozen_jacobian_polish
    # a residual with a hard floor: the second component is never zero,
    # and jumps discontinuously — |F| >= 0.04 everywhere
    def F(x):
        return jnp.stack([x[0],
                          0.05 + 0.01 * jnp.sign(jnp.sin(997.0 * x[0]))])
    x0 = jnp.array([0.35, -0.2])
    J = jnp.eye(2)
    res = frozen_jacobian_polish(F, x0, J, max_iterations=6, tolerance=1e-12)
    # never converges, but returns the best visited iterate faithfully
    assert not bool(res.converged)
    assert 0.04 <= float(res.residual_norm) <= float(jnp.linalg.norm(F(x0)))
    assert float(jnp.linalg.norm(F(res.solution))) == pytest.approx(
        float(res.residual_norm))
