"""Staged hybrid-precision Newton (solvers/staged.py).

On the CPU the fp32 stage runs the XLA evolve; the accurate stage runs
native float64 with exact Jacobians by default — the path a GPU takes —
or, explicitly, the df64 schedule replay with the frozen stencil modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, make_residual_fn, newton_solve,
    newton_solve_frozen, newton_solve_staged)

Z0 = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)


@pytest.mark.slow
def test_frozen_batched_matches_single(key):
    """frozen_schedule_map_batched (the flat-tiled replay the fused FD
    Jacobians evaluate through) must reproduce per-point
    frozen_schedule_map to ~1 ulp.  NOT bitwise: the (P*R)-row and R-row
    replays are different XLA programs (shape-dependent fusion), which is
    worth ~4e-16 even at sigma = 0 (measured); at sigma > 0 the lax.cond
    branch choice is additionally global over the tiled batch instead of
    per point (~1e-15 per event).  Either is far below the 1e-7-grade
    FD-stencil differences the batched path exists to resolve."""
    from armadillocudalinearinterpolation.model.emap import (
        compute_discrete_outcome, frozen_schedule_map,
        frozen_schedule_map_batched)

    cfg = ModelConfig(n_neurons=256, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=1024)
    eps = 1e-5
    pts = jnp.stack([Z0,
                     Z0 + jnp.array([eps, 0.0, 0.0]),
                     Z0 - jnp.array([0.0, eps, 0.0]),
                     Z0 + jnp.array([0.0, 0.0, eps])])
    for sigma, atol in [(0.0, 1e-13), (0.1, 1e-9)]:
        params = MapParams.create(13.0589, sigma, dtype="float64")
        sched, n_ev, ii = jax.jit(
            lambda z: compute_discrete_outcome(cfg, params, key, z))(Z0)
        batched = jax.jit(
            lambda ps: frozen_schedule_map_batched(
                cfg, params, key, ps, sched, n_ev, ii))(pts)
        single = jax.jit(
            lambda z: frozen_schedule_map(cfg, params, key, z,
                                          sched, n_ev, ii))
        singles = jnp.stack([single(p) for p in pts])
        np.testing.assert_allclose(np.asarray(batched), np.asarray(singles),
                                   rtol=0, atol=atol)


@pytest.mark.slow
def test_frozen_fd_matches_jacfwd_and_solves(key):
    """The frozen-schedule fused FD Jacobian is jacfwd-grade.

    Freezing the discrete outcome (firing schedule + seeding indices) and
    central-differencing the surrounding smooth piece at eps <= 1e-4 must
    reproduce the jacfwd-exact Jacobian: the frozen map IS the function the
    replay's stop_gradient makes jacfwd differentiate.  (The earlier
    ROADMAP-recorded "FD misses the staircase" failure was an eps = 1e-3
    artifact — at that radius probes cross discrete-outcome boundaries.)
    """
    from armadillocudalinearinterpolation.model.emap import (
        compute_discrete_outcome, frozen_schedule_map)

    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.0, dtype="float64")

    F = make_residual_fn(cfg, params, key, evolve_backend="replay")
    J_exact = jax.jit(jax.jacfwd(F))(Z0)

    sched, n_ev, ii = jax.jit(
        lambda z: compute_discrete_outcome(cfg, params, key, z))(Z0)
    Ff = jax.jit(lambda z: frozen_schedule_map(cfg, params, key, z,
                                               sched, n_ev, ii))
    # the frozen map equals the full replay map AT the freezing point.
    # Compare compiled-vs-compiled (same precedent as the shard_map
    # equality test): eager op-by-op dispatch differs from XLA's whole-
    # program rewrite at the ~1e-13 level, and this Z0 sits near enough
    # to a discrete event-classification boundary that the 1e-13
    # arithmetic difference once flipped an outcome and moved the eager
    # residual by 3e-7 while both jitted paths stayed bitwise equal.
    np.testing.assert_allclose(np.asarray(Ff(Z0)), np.asarray(jax.jit(F)(Z0)),
                               rtol=0, atol=1e-12)
    eps = 1e-5
    cols = []
    for i in range(3):
        e = jnp.zeros_like(Z0).at[i].set(eps)
        cols.append((Ff(Z0 + e) - Ff(Z0 - e)) / (2 * eps))
    J_fd = jnp.stack(cols, axis=1)
    rel = float(jnp.max(jnp.abs(J_fd - J_exact)) / jnp.max(jnp.abs(J_exact)))
    assert rel < 1e-5, rel

    # the standalone fused solver converges and its root checks out through
    # an independent replay oracle — a FRESH jitted program (independent of
    # the solver's internal caches), not an eager evaluation: this
    # trajectory passes near a grazing event, where the ~1e-13 eager-vs-
    # compiled arithmetic difference flips a discrete outcome and moves
    # the eager residual ~3e-7 (the map's event-reordering discontinuity
    # scale), swamping the 1e-9 root quality the check is about.
    res = newton_solve_frozen(
        cfg, params, key, Z0,
        NewtonConfig(tolerance=1e-7, max_iterations=8, fd_mode="frozen",
                     fd_epsilon=1e-5))
    assert bool(res.converged)
    assert int(res.iterations) <= 6
    assert float(jnp.linalg.norm(jax.jit(F)(res.solution))) <= 1.5e-7
    # a 0-iteration re-solve from the root still exports a REAL Jacobian
    res0 = newton_solve_frozen(
        cfg, params, key, res.solution,
        NewtonConfig(tolerance=1e-6, max_iterations=8, fd_mode="frozen",
                     fd_epsilon=1e-5))
    assert int(res0.iterations) == 0
    assert not np.allclose(np.asarray(res0.jacobian), np.eye(3), atol=1e-3)
    # ... and that Jacobian is jacfwd-grade AT the root (same traced program
    # as J_exact, new point)
    J_root = jax.jit(jax.jacfwd(F))(res.solution)
    rel0 = float(jnp.max(jnp.abs(res0.jacobian - J_root))
                 / jnp.max(jnp.abs(J_root)))
    assert rel0 < 1e-5, rel0


@pytest.mark.slow
def test_frozen_fwd_stencil(key):
    """fd_mode='frozen-fwd': the one-sided (n+1)-point stencil variant.

    Standalone: converges to the same root as central from the Driver.cu
    guess.  Staged: at this rough small-ensemble config the fp32 hand-off
    sits ON a discrete-outcome boundary and stage 2 once escaped to the
    GENUINE coexisting fast-family root (0.49, 0.58, 11.07) ~10 away from
    the slow-family guess — the staged rescue's basin-distance guard must
    detect the escape and return the slow-family root near the guess."""
    from armadillocudalinearinterpolation.model.emap import \
        make_residual_fn as mk

    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    res_f = newton_solve_frozen(
        cfg, params, key, Z0,
        NewtonConfig(tolerance=5e-8, max_iterations=8, fd_mode="frozen-fwd",
                     fd_epsilon=1e-6))
    res_c = newton_solve_frozen(
        cfg, params, key, Z0,
        NewtonConfig(tolerance=5e-8, max_iterations=8, fd_mode="frozen",
                     fd_epsilon=1e-5))
    assert bool(res_f.converged) and bool(res_c.converged)
    np.testing.assert_allclose(np.asarray(res_f.solution),
                               np.asarray(res_c.solution), atol=1e-6)

    ncfg2 = NewtonConfig(tolerance=5e-8, max_iterations=6,
                         fd_mode="frozen-fwd", fd_epsilon=1e-6)
    res = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-8,
                              stage2_ncfg=ncfg2)
    assert bool(res.converged)
    sol = np.asarray(res.solution)
    assert sol[0] > 0 and np.all(sol[0] * sol[1:] > 0) \
        and np.all(sol[0] * sol[1:] < 2 * cfg.half_width), sol
    # same FAMILY as the direct frozen solve from the same guess — the
    # basin_radius rescue must have pulled the fast-family escape back
    # (fast family: c ~ 0.5, z_2 ~ 10-15).  Exact root identity is NOT
    # asserted: the map has coexisting same-speed solutions ~0.04 apart
    # in spike spacing at this rough R=8 sigma=0.1 config (the staged
    # docstring's documented ambiguity), and which one the fp32 hand-off
    # lands nearest depends on the stage-1 realisation (it shifted when
    # stage 1 started sharing the accurate stages' f64 draw).
    assert abs(sol[0] - float(res_c.solution[0])) < 0.01      # same speed
    assert float(np.max(np.abs(sol - np.asarray(Z0)))) < 1.0  # in basin_radius
    np.testing.assert_allclose(sol, np.asarray(res_c.solution), atol=6e-2)
    # and the root checks out through an independent compiled replay oracle
    F = jax.jit(mk(cfg, params, key, evolve_backend="replay"))
    assert float(jnp.linalg.norm(F(res.solution))) < 1.5e-8


@pytest.mark.slow
def test_staged_solve_reaches_target(key):
    # sigma=0: the deterministic map — at R=8 the heterogeneous map's FD
    # landscape is too rough for the fp32 stage to hand off cleanly (the
    # staged recipe's operating regime is the reference ensemble scale)
    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    cache = {}
    res = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-7,
                              jit_cache=cache)
    assert bool(res.converged)
    assert float(res.residual_norm) <= 1e-7
    # independently verifiable, through BOTH accurate backends: the staged
    # result must be a root of the true f64 map, not a replay artifact.
    # (It may be a different coexisting root than a plain f64 solve from
    # Z0 finds: at this scale the map has two same-speed 3-spike solutions
    # ~0.04 apart in spike spacing, and the fp32 stage's hand-off picks
    # the basin it lands nearest — both are genuine fixed points.)
    F_rep = make_residual_fn(cfg, params, key, evolve_backend="replay")
    F_xla = make_residual_fn(cfg, params, key)
    assert float(jnp.linalg.norm(F_rep(res.solution))) <= 2e-7
    assert float(jnp.linalg.norm(F_xla(res.solution))) <= 2e-7
    # on the slow wave family: speed continuous with the reference guess
    ref = jax.jit(lambda z: newton_solve(
        F_xla, z, NewtonConfig(tolerance=1e-9, max_iterations=12,
                               fd_epsilon=1e-7)))(Z0)
    assert abs(float(res.solution[0]) - float(ref.solution[0])) < 0.01

    # a second solve through the same cache re-traces nothing and still
    # converges (the sweep use-case)
    res2 = newton_solve_staged(cfg, params, key, Z0 + 1e-3, tolerance=1e-7,
                               jit_cache=cache)
    assert bool(res2.converged)

    # sweep semantics: (params, key) are traced arguments of the cached
    # programs — a DIFFERENT beta and key through the SAME cache must solve
    # the new map, not replay step 0's baked-in constants.  The residual
    # check goes through a fresh, cache-free oracle at the new parameters.
    params_b = MapParams.create(13.4589, 0.0, dtype="float64")
    key_b = jax.random.split(key)[0]
    res3 = newton_solve_staged(cfg, params_b, key_b, res.solution,
                               tolerance=1e-7, jit_cache=cache)
    assert bool(res3.converged)
    F_b = make_residual_fn(cfg, params_b, key_b)
    assert float(jnp.linalg.norm(F_b(res3.solution))) <= 2e-7
    # higher beta -> faster wave on this family; at minimum, a different map
    # must give a measurably different root
    assert abs(float(res3.solution[0]) - float(res.solution[0])) > 1e-4


@pytest.mark.slow
def test_staged_fast_family_not_hijacked(key):
    """A solve warm-started ON the coexisting fast wave family must stay
    there.  The fast family (artifacts/enumerated_branches/branch_2..4;
    its fold is what --track-fold solves) lives at z_2 ~ 11 with c ~ 0.49
    at beta = 13.0589 — spike TIME offsets inside one temporal period
    (c * z_2 = 5.47 < 2L = 6).  An earlier round-3 domain guard tested
    ``z < 2L`` directly and misclassified every fast-family root as
    degenerate, paying a useless rescue per solve and risking silent
    replacement by a slow-family root; the corrected guard tests the
    POSITIONS ``c * z`` and the rescue triggers on basin distance instead.
    """
    cfg = ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    # the verified fast-family root at this (N, beta): |F| = 8.5e-11
    z_fast = jnp.array([0.49423453, 0.57798655, 11.06999273], jnp.float64)
    guess = z_fast + jnp.array([1e-3, -1e-3, 5e-3], jnp.float64)
    res = newton_solve_staged(
        cfg, params, key, guess, tolerance=1e-7,
        stage2_ncfg=NewtonConfig(tolerance=5e-7, max_iterations=6,
                                 fd_mode="frozen-fwd", fd_epsilon=1e-6))
    assert bool(res.converged)
    sol = np.asarray(res.solution)
    # still the fast wave, not hijacked to the slow family (c ~ 0.326)
    np.testing.assert_allclose(sol, np.asarray(z_fast), atol=0.02)
    # and in-domain under the position semantics
    assert sol[0] > 0 and np.all(sol[0] * sol[1:] > 0) \
        and np.all(sol[0] * sol[1:] < 2 * cfg.half_width), sol


@pytest.mark.slow
def test_staged_guards_and_jacobian(key):
    """Round-3 code-review fixes: cache identity is enforced, a 0-iteration
    accurate stage still returns a REAL Jacobian (not the identity
    placeholder — stability analysis eigendecomposes it), and "pallas"
    resolves to the differentiable native-f64 backend instead of
    crashing."""
    import pytest

    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    cache = {}
    # loose target: the fp32 hand-off (~1e-5 here) already satisfies the
    # stage-2 capture tolerance (5e-3), so the accurate stage does 0
    # iterations — the exported Jacobian must be recomputed, not I
    res = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-3,
                              evolve_backend="pallas",  # -> native f64
                              jit_cache=cache)
    assert bool(res.converged)
    assert not np.allclose(np.asarray(res.jacobian), np.eye(3), atol=1e-3)

    # same cache at a different tolerance bakes a different root_tol into
    # cfg -> must fail loudly instead of silently reusing stale programs
    with pytest.raises(ValueError, match="jit_cache"):
        newton_solve_staged(cfg, params, key, Z0, tolerance=1e-7,
                            jit_cache=cache)

    # a frozen stage-2 mode with a non-replay accurate backend must be
    # refused: newton_solve_frozen runs the df64 replay unconditionally,
    # so stage 2 would converge on a residual the polish/converged flag
    # never see (they use the requested backend's, ~1e-8 away)
    with pytest.raises(ValueError, match="replay"):
        newton_solve_staged(
            cfg, params, key, Z0, tolerance=1e-7, evolve_backend="xla",
            stage2_ncfg=NewtonConfig(tolerance=5e-7, max_iterations=6,
                                     fd_mode="frozen", fd_epsilon=1e-5))


def test_frozen_cache_identity_guard(key):
    """A jit_cache built for a different (cfg, mesh) must be refused: the
    cached schedule/fused programs close over them, so silent reuse would
    solve the WRONG problem (round-3 review finding — every other cache-
    sharing entry point already had this guard)."""
    import pytest

    cfg_a = ModelConfig(n_neurons=256, n_real=2, dtype="float64")
    cfg_b = cfg_a.with_(root_tol=1e-12)        # traced-constant difference
    ncfg = NewtonConfig(tolerance=1e-6, max_iterations=0, fd_mode="frozen",
                        fd_epsilon=1e-5)
    # seed the cache as a solve under cfg_a would (no full solve needed:
    # the guard must trip BEFORE any program in the cache is reused)
    cache = {"_frozen_identity": ("frozen", cfg_a, None, "real")}
    params = MapParams.create(13.0589, 0.0, dtype="float64")
    with pytest.raises(ValueError, match="different"):
        newton_solve_frozen(cfg_b, params, key, Z0, ncfg, jit_cache=cache)
    # same identity passes the guard and records it via setdefault
    cache2 = {}
    try:
        newton_solve_frozen(cfg_a, params, key, Z0, ncfg, jit_cache=cache2)
    finally:
        assert cache2["_frozen_identity"] == ("frozen", cfg_a, None, "real")


@pytest.mark.slow
def test_staged_stage1_shares_the_draw(key):
    """The fp32 stage must solve the SAME stochastic realisation as the
    accurate stages: jax.random.normal(key, dtype=f32) is a different bit
    stream than the f64 draw from the same key (measured delta up to ~5
    sigma), so stage 1 draws at the accurate dtype and casts (round-3
    review finding).  Checked by evaluating the cached stage-1 program at
    the accurate root: with the shared draw its entry residual is at the
    fp32 noise floor; with an independent f32 draw it is at the
    Monte-Carlo-difference scale (~1e-2 at R=8, sigma=0.1)."""
    cfg = ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=2048)
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    cache = {}
    res = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-7,
                              jit_cache=cache)
    assert bool(res.converged)
    params32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    r32 = cache["stage1"](res.solution.astype(jnp.float32), params32, key)
    entry = float(r32.residual_history[0])
    assert entry < 2e-3, (
        f"stage-1 residual at the accurate root is {entry:.2e} — "
        "MC-difference scale; the fp32 stage is solving a different "
        "realisation than the accurate stages")


def test_scored_winner_nan_fill_retries_like_ev():
    """ADVICE r4: a scored backtracking winner whose schedule-reusing fill
    returns a non-finite Jacobian must be re-evaluated through the same
    fresh-evaluate + eps/8 retry path ``ev`` uses — NOT installed into the
    loop state (recovery would otherwise wait a full iteration for the
    NaN-best refresh).  Synthetic 1-D arctan problem: the full Newton step
    from x0=3 overshoots (|F| grows), so halved trials are *scored* and a
    scored trial wins -> the fill path runs; we poison its first call."""
    from armadillocudalinearinterpolation.solvers.staged import (
        frozen_newton_loop)

    dt_ = jnp.float64
    calls = {"fill": 0, "evaluate": 0}

    def evaluate(z, ep):
        calls["evaluate"] += 1
        f = jnp.arctan(z)
        jac = (1.0 / (1.0 + z * z))[:, None]
        return f, jac

    def score(z):
        return jnp.arctan(z), ("sched",)

    def fill(z, ep, aux):
        calls["fill"] += 1
        assert aux == ("sched",)
        f = jnp.arctan(z)
        if calls["fill"] == 1:
            return f, jnp.full((1, 1), jnp.nan, dt_)
        return f, (1.0 / (1.0 + z * z))[:, None]

    ncfg = NewtonConfig(tolerance=1e-10, max_iterations=12, damping=1.0,
                        print_output=False)
    res = frozen_newton_loop(evaluate, jnp.array([3.0], dt_), ncfg, dt_,
                             jnp.asarray(1e-6, dt_), backtrack=True,
                             score=score, fill=fill)
    assert bool(res.converged)
    assert np.isfinite(np.asarray(res.jacobian)).all()
    # the poisoned fill happened, and the retry re-evaluated fresh
    assert calls["fill"] >= 1
    assert calls["evaluate"] >= 2
    # no NaN ever entered the recorded history (the loop state stayed sane)
    hist = np.asarray(res.residual_history)
    assert np.isfinite(hist[: int(res.iterations) + 1]).all()


@pytest.mark.parametrize("backend,programs", [
    ("auto", {"stage1", "F", "J"}),
    ("replay", {"stage1", "F", "sched", "fused_fwd", "score"}),
])
def test_staged_aot_warmup_matches_and_prewarms(backend, programs):
    """staged_aot_warmup must (a) report a trace/compile breakdown for
    every program of the default recipe of each accurate path (native f64
    with an exact stage 2; the df64 replay with frozen-fwd), (b) leave the
    cache in a state the subsequent newton_solve_staged accepts (same
    identity) and reuses, and (c) not change the solve's result vs an
    un-warmed cache."""
    from armadillocudalinearinterpolation import staged_aot_warmup

    cfg = ModelConfig(n_neurons=256, n_real=8, dtype="float64",
                      root_tol=1e-12, max_events=1024)
    params = MapParams.create(13.0589, 0.1, dtype="float64")
    key = jax.random.PRNGKey(0)

    cache = {}
    bd = staged_aot_warmup(cfg, params, key, Z0, tolerance=1e-7,
                           evolve_backend=backend, jit_cache=cache)
    assert set(bd["programs"]) == programs
    for p in bd["programs"].values():
        assert p["trace_s"] >= 0.0 and p["compile_s"] >= 0.0
    assert bd["compile_wall_s"] <= sum(
        p["compile_s"] for p in bd["programs"].values()) + 1.0
    # the warmed cache must be accepted by the solve (identity match) and
    # the programs must be the SAME objects (cache hits, not rebuilds)
    sub_keys = sorted(programs - {"stage1"})
    progs_before = [cache["stage1"]] + [cache["stage2_cache"][k]
                                        for k in sub_keys]
    res_w = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-7,
                                evolve_backend=backend, jit_cache=cache)
    progs_after = [cache["stage1"]] + [cache["stage2_cache"][k]
                                       for k in sub_keys]
    assert all(a is b for a, b in zip(progs_before, progs_after))
    res_u = newton_solve_staged(cfg, params, key, Z0, tolerance=1e-7,
                                evolve_backend=backend)
    np.testing.assert_allclose(np.asarray(res_w.solution),
                               np.asarray(res_u.solution), atol=1e-12)
    # a warmup against a DIFFERENT setup must be rejected like any other
    # cache-identity mismatch
    with pytest.raises(ValueError, match="different"):
        staged_aot_warmup(cfg, params, key, Z0, tolerance=1e-9,
                          evolve_backend=backend, jit_cache=cache)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("requested,want", [
    ("auto", "xla"), ("pallas", "xla"), ("xla", "xla"),
    ("replay", "replay")])
def test_accurate_backend_is_one_path(monkeypatch, platform, requested,
                                      want):
    """The accurate stage resolves the same way on every platform: native
    f64 unless the replay is asked for by name."""
    from armadillocudalinearinterpolation.model.emap import accurate_backend
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert accurate_backend(requested) == want
