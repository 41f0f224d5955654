"""Schedule replay (model/replay.py): f64-grade evolve at f32 arithmetic.

Oracle: the fully-f64 windowed batched evolve / map on the CPU backend.
The replay must reproduce its crossing times and residuals to ~1e-10 while
computing exclusively in f32 pairs, and must be forward-differentiable
(VERDICT r2 items #1 and #2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import armadillocudalinearinterpolation as alt
from armadillocudalinearinterpolation.model import lift as liftm
from armadillocudalinearinterpolation.model import replay
from armadillocudalinearinterpolation.model.emap import (
    event_driven_map, make_residual_fn, sample_beta, z_to_u)
from armadillocudalinearinterpolation.model.evolve_batched import (
    evolve_ensemble_batched)

Z64 = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def cfg():
    return alt.ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                           root_tol=1e-12, max_events=2048)


@pytest.fixture(scope="module")
def pieces(cfg):
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    beta = sample_beta(cfg, params, KEY)
    init_ind = liftm.initial_spike_indices(cfg, Z64)
    v0, s0 = liftm.lift(cfg, params, z_to_u(Z64))
    return params, beta, init_ind, v0, s0


def test_replay_matches_f64_evolve(cfg, pieces):
    _, beta, init_ind, v0, s0 = pieces
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)
    rep = replay.replay_events(cfg, sched, res64.n_events, v0, s0, beta,
                               init_ind)
    assert bool(jnp.all(rep.accept == res64.accept))
    assert int(jnp.sum(rep.crossed_ind != res64.crossed_ind)) == 0
    assert int(jnp.sum(rep.last_ind != res64.last_ind)) == 0
    assert float(jnp.max(jnp.abs(rep.crossed_time - res64.crossed_time))) \
        < 1e-10
    assert float(jnp.max(jnp.abs(rep.last_time - res64.last_time))) < 1e-10


def test_replay_wide_beta_matches_f64_evolve(cfg):
    """Large heterogeneity spread: |beta - beta[lane 0]| reaches ~3, so the
    per-event bound delta_max * dt crosses SMALL_EXP_BOUND and the decay's
    lax.cond falls back to the full range-reduced exp on those events
    (0.08 / 3 ~ 0.027, well inside the inter-event dt range at N=512).
    The replay must stay 1e-10-grade against the f64 oracle through the
    mixed small/fallback branch sequence."""
    params = alt.MapParams.create(13.0589, 0.0, dtype="float64")
    beta0 = sample_beta(cfg, params, KEY)
    phase = 2.0 * jnp.pi * jnp.arange(cfg.n_neurons) / cfg.n_neurons
    beta = beta0 + 3.0 * jnp.sin(phase)          # lane 0 offset exactly 0
    init_ind = liftm.initial_spike_indices(cfg, Z64)
    v0, s0 = liftm.lift(cfg, params, z_to_u(Z64))
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)
    rep = replay.replay_events(cfg, sched, res64.n_events, v0, s0, beta,
                               init_ind)
    assert bool(jnp.any(res64.accept)), "degenerate: no realisation accepted"
    assert bool(jnp.all(rep.accept == res64.accept))
    assert int(jnp.sum(rep.crossed_ind != res64.crossed_ind)) == 0
    assert float(jnp.max(jnp.abs(rep.crossed_time - res64.crossed_time))) \
        < 1e-10
    assert float(jnp.max(jnp.abs(rep.last_time - res64.last_time))) < 1e-10


def test_replay_backend_residual_matches_f64(cfg):
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    f_ref = event_driven_map(cfg, params, KEY, Z64, evolve_backend="xla")
    f_rep = event_driven_map(cfg, params, KEY, Z64, evolve_backend="replay")
    assert float(jnp.max(jnp.abs(f_ref - f_rep))) < 1e-10


def test_replay_f32_inputs_beat_plain_f32_evolution(cfg, pieces):
    """With f32 inputs the replay still evolves in df64 internally — its
    crossing times must sit orders of magnitude closer to the f64
    evolution OF THE SAME INPUTS than the plain f32 evolution does.

    (All three paths share bitwise-identical f32 initial state and rates,
    so the comparison isolates evolution arithmetic, not input rounding.)
    """
    _, beta, init_ind, v0, s0 = pieces
    v32 = v0.astype(jnp.float32)
    s32 = s0.astype(jnp.float32)
    b32 = beta.astype(jnp.float32)
    cfg32 = cfg.with_(dtype="float32", root_tol=1e-6)
    # f64 oracle evolution of the f32-rounded inputs
    ref = evolve_ensemble_batched(
        cfg, None, v32.astype(jnp.float64), s32.astype(jnp.float64),
        b32.astype(jnp.float64), init_ind)
    plain = evolve_ensemble_batched(cfg32, None, v32, s32, b32, init_ind)
    rep = replay.evolve_ensemble_replay(cfg32, v32, s32, b32, init_ind)
    err_plain = float(jnp.max(jnp.abs(
        plain.crossed_time.astype(jnp.float64) - ref.crossed_time)))
    err_rep = float(jnp.max(jnp.abs(
        rep.crossed_time.astype(jnp.float64) - ref.crossed_time)))
    # replay is limited only by the final f32 rounding of the times
    # (~3e-7 at t ~ 5); the plain f32 loop accumulates far past that
    assert err_rep < 1e-6
    assert err_rep < 0.05 * err_plain


def test_schedule_overflow_rejects_rows(cfg, pieces):
    _, beta, init_ind, v0, s0 = pieces
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)
    # pretend the log overflowed: n_sched > E must reject every such row
    fake_n = res64.n_events.at[0].set(sched.shape[1] + 5)
    rep = replay.replay_events(cfg, sched, fake_n, v0, s0, beta, init_ind)
    assert not bool(rep.accept[0])
    assert bool(jnp.all(rep.accept[1:] == res64.accept[1:]))


def test_replay_invariant_to_schedule_padding(cfg, pieces):
    """The bounded while-loop stops at max(n_sched): steps past a row's
    event count are fully live-masked, so growing the schedule buffer
    (extra dead tail) must not change a single bit of the result."""
    _, beta, init_ind, v0, s0 = pieces
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)
    rep = replay.replay_events(cfg, sched, res64.n_events, v0, s0, beta,
                               init_ind)
    pad = jnp.zeros((sched.shape[0], 256), jnp.int32)
    cfg_wide = cfg.with_(max_events=cfg.max_events + 256)
    rep_wide = replay.replay_events(cfg_wide, jnp.concatenate([sched, pad], 1),
                                    res64.n_events, v0, s0, beta, init_ind)
    for a, b in zip(jax.tree.leaves(rep), jax.tree.leaves(rep_wide)):
        assert bool(jnp.all(a == b))


@pytest.mark.slow
def test_replay_exp_modes(cfg, pieces):
    """cfg.replay_exp_mode: the three small-exp strategies must agree.

    "fast" (exp_fast hardcoded) is exact everywhere, so it must match
    "cond" (the per-event-branch reference strategy; the package default
    is "hoisted" since the on-chip A/B) on both the small-sigma batch and the
    wide-beta batch that forces cond's fallback branch.  "small"
    (exp_small hardcoded) must match on the small-sigma batch where the
    |z| bound holds on every event — and on the wide-beta batch it must
    REJECT (not silently mis-evolve) every row that crosses the bound."""
    _, beta, init_ind, v0, s0 = pieces
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)

    def run(mode, b=beta, s=sched, n=None):
        c = cfg.with_(replay_exp_mode=mode)
        return jax.jit(lambda: replay.replay_events(
            c, s, res64.n_events if n is None else n, v0, s0, b, init_ind))()

    ref = run("cond")
    for mode in ("small", "fast", "hoisted"):
        rep = run(mode)
        assert bool(jnp.all(rep.accept == ref.accept)), mode
        assert float(jnp.max(jnp.abs(rep.crossed_time - ref.crossed_time))) \
            < 1e-12, mode
        assert float(jnp.max(jnp.abs(rep.last_time - ref.last_time))) \
            < 1e-12, mode

    # wide heterogeneity: |z| = |delta * dt| crosses SMALL_EXP_BOUND
    params0 = alt.MapParams.create(13.0589, 0.0, dtype="float64")
    beta_w = sample_beta(cfg, params0, KEY) + 3.0 * jnp.sin(
        2.0 * jnp.pi * jnp.arange(cfg.n_neurons) / cfg.n_neurons)
    res_w, sched_w = evolve_ensemble_batched(cfg, None, v0, s0, beta_w,
                                             init_ind,
                                             record_schedule=cfg.max_events)
    ref_w = run("cond", b=beta_w, s=sched_w, n=res_w.n_events)
    for mode in ("fast", "hoisted"):
        # both are exact everywhere — "hoisted" must have taken its
        # whole-loop exp_fast rerun here (the bound trips on this batch)
        m_w = run(mode, b=beta_w, s=sched_w, n=res_w.n_events)
        assert bool(jnp.all(m_w.accept == ref_w.accept)), mode
        assert float(jnp.max(jnp.abs(m_w.crossed_time
                                     - ref_w.crossed_time))) < 1e-10, mode
    small_w = run("small", b=beta_w, s=sched_w, n=res_w.n_events)
    # every row crossing the bound is rejected; none is silently wrong
    assert not bool(jnp.any(small_w.accept & ~ref_w.accept))
    changed = small_w.accept != ref_w.accept
    assert bool(jnp.any(changed)), \
        "degenerate: wide-beta batch never crossed the small-exp bound"
    ok = small_w.accept
    if bool(jnp.any(ok)):
        d = jnp.abs(small_w.crossed_time - ref_w.crossed_time)[ok]
        assert float(jnp.max(d)) < 1e-10


def test_separable_kick_tables_match_direct(cfg):
    """The separable A_i B_j kick factorisation must reproduce the direct
    per-event df64 exponential to pair precision for every firing lane —
    including the wrap-around (ring-minimum) side and the self-kick i = j."""
    from armadillocudalinearinterpolation.model.replay import (
        _build_kick_tables, _kick_weight_df, _mexhat_df)
    from armadillocudalinearinterpolation.utils import df64 as D

    N = cfg.n_neurons
    tabs = _build_kick_tables(cfg)
    lane = jnp.arange(N, dtype=jnp.int32)[None, :]
    # firing lanes covering interior, edges, and exact half-ring distance
    js = jnp.asarray([0, 1, 7, N // 2 - 1, N // 2, N // 2 + 1, N - 2, N - 1],
                     jnp.int32)
    w_sep = jax.jit(lambda j: D.to_f64(_kick_weight_df(tabs, j, lane, cfg)))(
        js)
    d = jnp.abs(lane - js[:, None]).astype(jnp.float32)
    dist = jnp.minimum(d, jnp.float32(N) - d) * jnp.float32(cfg.dx)
    w_dir = jax.jit(lambda ds: D.to_f64(_mexhat_df(ds, cfg)))(dist)
    # both are ~2^-47-grade approximations of the same double value; their
    # difference is bounded by the sum of the two error envelopes
    scale = float(jnp.max(jnp.abs(w_dir)))
    assert float(jnp.max(jnp.abs(w_sep - w_dir))) < 1e-12 * scale


def test_separable_kick_tables_nonpositive_amplitudes(cfg):
    """Zero and negative coupling amplitudes must evaluate exactly, not
    raise: the tables fold |a| dx and reapply the sign statically (a
    round-3 review fix — the earlier guard hard-failed a2 = 0 configs the
    direct ``_mexhat_df`` path always evolved correctly)."""
    from armadillocudalinearinterpolation.model.replay import (
        _build_kick_tables, _kick_weight_df, _mexhat_df)
    from armadillocudalinearinterpolation.utils import df64 as D

    N = cfg.n_neurons
    lane = jnp.arange(N, dtype=jnp.int32)[None, :]
    js = jnp.asarray([0, 3, N // 2, N - 1], jnp.int32)
    d = jnp.abs(lane - js[:, None]).astype(jnp.float32)
    dist = jnp.minimum(d, jnp.float32(N) - d) * jnp.float32(cfg.dx)
    for a1, a2 in ((cfg.a1, 0.0), (0.0, 0.0), (-cfg.a1, cfg.a2),
                   (cfg.a1, -cfg.a2)):
        c = cfg.with_(a1=a1, a2=a2)
        tabs = _build_kick_tables(c)
        w_sep = jax.jit(
            lambda j: D.to_f64(_kick_weight_df(tabs, j, lane, c)))(js)
        w_dir = jax.jit(lambda ds: D.to_f64(_mexhat_df(ds, c)))(dist)
        scale = max(float(jnp.max(jnp.abs(w_dir))), 1.0)
        assert float(jnp.max(jnp.abs(w_sep - w_dir))) < 1e-12 * scale, \
            (a1, a2)


@pytest.mark.slow
def test_jacfwd_through_replay_matches_fd(cfg):
    """VERDICT r2 #2 done-criterion: jacfwd-vs-FD agreement.

    The exact Jacobian flows through the replay scan (IFT tangents at the
    scalar roots, stop_gradient on the schedule pass); central differences
    on the f64 XLA path are the independent check.
    """
    from armadillocudalinearinterpolation.solvers.newton import (
        central_fd_jacobian)
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    # pin the per-event-branch reference strategy explicitly: the package
    # default is "hoisted" since the on-chip A/B, and a default-cfg
    # reference here would make the hoisted assertion below compare the
    # hoisted program against itself
    F_rep = make_residual_fn(cfg.with_(replay_exp_mode="cond"), params,
                             KEY, evolve_backend="replay")
    F_ref = make_residual_fn(cfg, params, KEY, evolve_backend="xla")
    J_exact = jax.jacfwd(F_rep)(Z64)
    J_fd = central_fd_jacobian(F_ref, Z64, 1e-6)
    assert float(jnp.max(jnp.abs(J_exact - J_fd))) < 1e-4

    # the "hoisted" exp mode's top-level cond (while_loop inside a branch)
    # must stay forward-differentiable AND numerically identical: at this
    # sigma the bound never trips, so its jacfwd IS the exp_small loop's
    F_h = make_residual_fn(cfg.with_(replay_exp_mode="hoisted"), params,
                           KEY, evolve_backend="replay")
    J_h = jax.jacfwd(F_h)(Z64)
    assert float(jnp.max(jnp.abs(J_h - J_exact))) < 1e-10


def test_replay_jvp_f32_primal_bitwise(cfg, pieces):
    """cfg.replay_jvp='f32' wraps the SAME df64 primal in a custom JVP —
    undifferentiated evaluations must be bitwise identical to the df64
    default (ROADMAP 1b / VERDICT r4 #5)."""
    _, beta, init_ind, v0, s0 = pieces
    res64, sched = evolve_ensemble_batched(cfg, None, v0, s0, beta, init_ind,
                                           record_schedule=cfg.max_events)
    rep_a = replay.replay_events(cfg, sched, res64.n_events, v0, s0, beta,
                                 init_ind)
    rep_b = replay.replay_events(cfg.with_(replay_jvp="f32"), sched,
                                 res64.n_events, v0, s0, beta, init_ind)
    for a, b in zip(jax.tree.leaves(rep_a), jax.tree.leaves(rep_b)):
        assert bool(jnp.all(a == b))


def test_replay_jvp_f32_jacfwd_matches_df64(cfg):
    """The f32-tangent custom JVP's map Jacobian vs machine-grade df64
    jacfwd: agreement is set by the f32 re-evolution's trajectory drift,
    measured ~1.5e-4 relative at this config (the config.py contract)."""
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    F_df = make_residual_fn(cfg, params, KEY, evolve_backend="replay")
    F_f32 = make_residual_fn(cfg.with_(replay_jvp="f32"), params, KEY,
                             evolve_backend="replay")
    J_df = jax.jacfwd(F_df)(Z64)
    J_f32 = jax.jacfwd(F_f32)(Z64)
    scale = float(jnp.max(jnp.abs(J_df)))
    assert float(jnp.max(jnp.abs(J_df - J_f32))) < 1e-3 * scale
    # and it must be usably far from zero-tangent degeneracy
    assert float(jnp.max(jnp.abs(J_f32))) > 0.1


@pytest.mark.slow
def test_jacfwd_cols_matches_jacfwd(cfg):
    """jacfwd_cols (sequential jvp columns — the package's exact-mode
    Jacobian form, instead of jax.jacfwd's vmapped tangents through the
    replay loop) must agree with jax.jacfwd in both tangent
    modes: to numerical noise for df64 tangents, to f32-reassociation
    drift over the trajectory (~1e-5 at this scale) for f32 tangents."""
    from armadillocudalinearinterpolation.solvers.newton import (
        jacfwd_cols)
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    small = cfg.with_(n_neurons=256, max_events=1024)
    for mode, tol in (("df64", 1e-10), ("f32", 2e-4)):
        F = make_residual_fn(small.with_(replay_jvp=mode), params, KEY,
                             evolve_backend="replay")
        J_ref = jax.jacfwd(F)(Z64)
        J_cols = jacfwd_cols(F)(Z64)
        assert J_cols.shape == J_ref.shape
        assert float(jnp.max(jnp.abs(J_ref - J_cols))) < tol, mode


def test_replay_jvp_f32_beta_tangent(cfg):
    """dF/dbeta — the continuation/fold-tracking tangent — must flow
    through the f32 custom JVP (the rule forwards the beta tangent into
    the f32 re-evolution; a dropped tangent would return exactly 0)."""
    import functools

    def F_of_beta(cfgx, b):
        params = alt.MapParams(beta=b, sigma=jnp.asarray(0.1, jnp.float64))
        F = make_residual_fn(cfgx, params, KEY, evolve_backend="replay")
        return F(Z64)

    b0 = jnp.asarray(13.0589, jnp.float64)
    for_mode = {}
    for mode in ("df64", "f32"):
        cfgx = cfg.with_(replay_jvp=mode)
        _, dF = jax.jvp(functools.partial(F_of_beta, cfgx), (b0,),
                        (jnp.ones_like(b0),))
        for_mode[mode] = np.asarray(dF)
    scale = np.max(np.abs(for_mode["df64"]))
    assert scale > 1e-3          # the sweep's dF/dbeta is O(0.1) here
    assert np.max(np.abs(for_mode["df64"] - for_mode["f32"])) < 1e-3 * scale


@pytest.mark.slow
def test_newton_converges_on_replay_backend(cfg):
    """Exact-mode Newton on the replay backend: the differentiable fast
    path must drive the residual to 1e-9 (reference contract:
    NewtonSolver.cpp:40-161 at double precision)."""
    params = alt.MapParams.create(13.0589, 0.0, dtype="float64")
    F = make_residual_fn(cfg, params, KEY, evolve_backend="replay")
    ncfg = alt.NewtonConfig(tolerance=1e-9, max_iterations=10,
                            fd_mode="exact")
    res = alt.newton_solve(F, Z64, ncfg)
    assert bool(res.converged)
    assert float(res.residual_norm) <= 1e-9
    # same fixed point as the f64 oracle path finds (verify-skill values)
    sol = np.asarray(res.solution)
    assert np.allclose(sol, [0.32623663, 0.71936722, 1.36899475], atol=5e-5)


def test_pallas_schedule_source_interpret(cfg, pieces):
    """The GPU kernel's schedule pass (through the Pallas interpreter here)
    must produce a schedule the replay accepts, matching the XLA pass's
    event counts."""
    from armadillocudalinearinterpolation.model import evolve_pallas
    _, beta, init_ind, v0, s0 = pieces
    cfg32 = cfg.with_(dtype="float32", root_tol=1e-6)
    res_p, sched_p = evolve_pallas.evolve_ensemble_pallas(
        cfg32, v0.astype(jnp.float32), s0.astype(jnp.float32),
        beta.astype(jnp.float32), init_ind, record_schedule=2048,
        interpret=True)
    res_x, sched_x = evolve_ensemble_batched(
        cfg32, None, v0.astype(jnp.float32), s0.astype(jnp.float32),
        beta.astype(jnp.float32), init_ind, record_schedule=2048)
    assert bool(jnp.all(res_p.n_events == res_x.n_events))
    # identical f32 arithmetic orders are not guaranteed between the two
    # passes; near-tie flips are allowed but must be rare
    n = int(res_x.n_events[0])
    match = int(jnp.sum(sched_p[:, :n] == sched_x[:, :n]))
    assert match > 0.99 * sched_x[:, :n].size
    rep = replay.replay_events(cfg, sched_p.astype(jnp.int32),
                               res_p.n_events, v0, s0, beta, init_ind)
    assert bool(jnp.all(rep.accept))


def test_replay_large_sigma_consistency(cfg):
    """At sigma = 1.0 (strong heterogeneity, some rejected realisations)
    the replay must still agree with the f64 oracle on accepted rows and
    never produce NaN."""
    params = alt.MapParams.create(13.0589, 1.0, dtype="float64")
    f_ref = event_driven_map(cfg, params, KEY, Z64, evolve_backend="xla")
    f_rep = event_driven_map(cfg, params, KEY, Z64, evolve_backend="replay")
    assert bool(jnp.all(jnp.isfinite(f_rep)))
    # grazing-event schedule flips (f32 pass vs f64) bound the agreement:
    # the commutator scale at N=512, far above df64 arithmetic error
    assert float(jnp.max(jnp.abs(f_ref - f_rep))) < 1e-5


@pytest.mark.slow
def test_replay_loop_scan_matches_while(key):
    """cfg.replay_loop='scan' (fixed-length scan, the measured-and-rejected
    jacfwd A/B variant — config.py) must match the bounded-while default
    bitwise, values and jacfwd Jacobians both."""
    params = alt.MapParams.create(13.0589, 0.1, dtype="float64")
    z = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)
    outs = {}
    for loop in ("while", "scan"):
        cfg = alt.ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                              root_tol=1e-12, max_events=2048,
                              replay_loop=loop)
        F = alt.make_residual_fn(cfg, params, key, evolve_backend="replay")
        outs[loop] = (np.asarray(F(z)), np.asarray(jax.jacfwd(F)(z)))
    np.testing.assert_array_equal(outs["while"][0], outs["scan"][0])
    np.testing.assert_array_equal(outs["while"][1], outs["scan"][1])


@pytest.mark.parametrize("route", ["replay_events", "evolve_ensemble_replay",
                                   "map", "newton_solve_frozen"])
def test_replay_refused_on_gpu(monkeypatch, cfg, pieces, route):
    """Every route into the df64 replay fails loudly on a GPU backend (its
    program takes minutes per evaluation there) instead of hanging."""
    params, beta, init_ind, v0, s0 = pieces
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    sched = jnp.zeros((cfg.n_real, cfg.max_events), jnp.int32)
    n_ev = jnp.zeros((cfg.n_real,), jnp.int32)
    calls = {
        "replay_events": lambda: replay.replay_events(
            cfg, sched, n_ev, v0, s0, beta, init_ind),
        "evolve_ensemble_replay": lambda: replay.evolve_ensemble_replay(
            cfg, v0, s0, beta, init_ind),
        "map": lambda: event_driven_map(cfg, params, KEY, Z64,
                                        evolve_backend="replay"),
        "newton_solve_frozen": lambda: alt.newton_solve_frozen(
            cfg, params, KEY, Z64,
            alt.NewtonConfig(tolerance=1e-6, max_iterations=1,
                             fd_mode="frozen", fd_epsilon=1e-5)),
    }
    with pytest.raises(NotImplementedError, match="GPU"):
        calls[route]()
