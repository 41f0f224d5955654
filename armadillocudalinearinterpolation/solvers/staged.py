"""Staged hybrid-precision Newton: the library form of the 1e-8 recipe.

The reference gets deep tolerances for free from a native-double solver
(``NewtonSolver.cpp:40-161``); here the same accuracy is
reached in three stages, each cheaper per iteration than a direct
accurate solve:

  1. **fp32 fast stage**: fused :func:`..solvers.newton.newton_solve` with
     the f32 evolve (the GPU kernel on a GPU) takes the iterate to the f32
     residual floor (~2e-5).
  2. **accurate stage**: host-driven Newton on the native float64 map
     (``evolve_backend="auto"``/``"xla"``) with exact Jacobians
     (``fd_mode="exact"``: ``jacfwd_cols`` through the event-time IFT
     JVP), driven to ``0.9 * tolerance``.  With an explicit
     ``evolve_backend="replay"`` (df64 schedule replay, CPU only) the
     default is ``"frozen-fwd"`` instead — one fused ``(n+1)``-point
     frozen-schedule replay per iteration (:func:`newton_solve_frozen`) —
     stopping inside the polish's capture range (``5 * tolerance``).
  3. **frozen-Jacobian polish**: best-iterate quasi-Newton
     (:func:`..solvers.newton.frozen_jacobian_polish`) walks the
     event-reordering jump landscape down to the target.

``chip_smoke.py`` phase 5 times the whole recipe at N=4096, cold and warm.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig, MapParams, NewtonConfig
from ..model.emap import (accurate_backend, compute_discrete_outcome,
                          event_driven_map, frozen_schedule_map_batched)
from .criterion import residual_norm_criterion
from .linalg import solve_dense
from .newton import (NewtonResult, frozen_jacobian_polish, jacfwd_cols,
                     newton_solve, newton_solve_host, _print_footer,
                     _print_header, _print_iteration)


def _ensure_frozen_programs(cache: dict, cfg: ModelConfig, n: int, dt_,
                            fwd: bool, mesh, mesh_axis: str) -> None:
    """Populate ``cache`` with the frozen solver's three jitted programs
    (idempotent).  Shared by :func:`newton_solve_frozen` and the AOT
    warmup (:func:`staged_aot_warmup`) so both build the SAME program
    objects — the warmup's compiled executables are only useful if the
    solve's cache lookups hit them."""
    if "sched" not in cache:
        # mesh: the discovery evolve partitions over the ensemble like the
        # stencil replay it feeds (it used to run replicated under a mesh)
        cache["sched"] = jax.jit(
            lambda z, p, k: compute_discrete_outcome(
                cfg, p, k, z, mesh=mesh, mesh_axis=mesh_axis))
    # (no mesh suffix: the identity guard pins one mesh per cache,
    # so a suffix could never disambiguate anything)
    fused_key = "fused_fwd" if fwd else "fused"
    if fused_key not in cache:
        def _fused(z, ep, sched, n_ev, ii, p, k):
            e = ep * jnp.eye(n, dtype=dt_)
            pts = (jnp.concatenate([z[None, :], z[None, :] + e])  # (n+1, n)
                   if fwd else
                   jnp.concatenate([z[None, :], z[None, :] + e,
                                    z[None, :] - e]))             # (2n+1, n)
            # flat stencil*R-row replay, NOT vmap(frozen_schedule_map):
            # under vmap the replay's per-event lax.cond runs both exp
            # branches (see frozen_schedule_map_batched)
            vals = frozen_schedule_map_batched(cfg, p, k, pts,
                                               sched, n_ev, ii,
                                               row_mesh=mesh,
                                               row_axis=mesh_axis)
            f = vals[0]
            jac = ((vals[1:] - f).T / ep if fwd
                   else (vals[1:n + 1] - vals[n + 1:]).T / (2.0 * ep))
            return f, jac
        cache[fused_key] = jax.jit(_fused)

    # Residual-only scoring program for backtracking trials (VERDICT r3
    # #7): a losing trial needs F(x_try) — ONE replay row — to be scored,
    # not the full (n+1)/(2n+1)-row fused stencil.  Mode-independent (no
    # eps, no stencil), so one cached program serves both fd modes.
    if "score" not in cache:
        def _score(z, sched, n_ev, ii, p, k):
            vals = frozen_schedule_map_batched(cfg, p, k, z[None, :],
                                               sched, n_ev, ii,
                                               row_mesh=mesh,
                                               row_axis=mesh_axis)
            return vals[0]
        cache["score"] = jax.jit(_score)


def newton_solve_frozen(cfg: ModelConfig, params: MapParams, key: jax.Array,
                        x0: jax.Array, ncfg: NewtonConfig, *,
                        jit_cache: Optional[dict] = None,
                        mesh=None, mesh_axis: str = "real") -> NewtonResult:
    """Host-driven Newton on the replay backend with a FUSED residual +
    frozen-schedule central-FD Jacobian — jacfwd accuracy without jacfwd.
    Runs the df64 replay, so it is refused on a GPU
    (:func:`..model.replay.require_replay_platform`).

    Per iteration: one f32 schedule pass at ``x`` discovers the discrete
    outcome (firing order + seeding indices,
    :func:`..model.emap.compute_discrete_outcome`); one batched replay
    launch evaluates the frozen smooth piece
    (:func:`..model.emap.frozen_schedule_map`) at the ``2n + 1`` points
    ``[x, x ± eps e_i]`` — yielding ``F(x)`` *exactly* (same schedule) and a
    central-FD Jacobian that matches the jacfwd-exact one to ~3e-7 relative
    at ``eps = 1e-5`` (measured at N=512 f64; the frozen map IS the smooth
    piece jacfwd differentiates, so the agreement is structural, not luck —
    the earlier "FD misses the staircase" failure (ROADMAP) was an
    ``eps = 1e-3`` artifact: at that radius the probes cross discrete-outcome
    boundaries; at ``eps ≤ 1e-4`` they do not).

    Why this beats ``fd_mode="exact"``: jacfwd through the replay scan
    costs many forward evaluations (differentiating the df64 carry chains
    is intrinsically wide) and requires the backend to define JVPs; here
    the Jacobian is ``2n`` *forward* replays batched into one launch (n=3:
    7 points, no JVP machinery), plus the cheap f32
    schedule pass.  Unlike :func:`..solvers.newton.newton_solve_host`, a
    0-iteration solve still exports a REAL Jacobian (the fused launch always
    computes one), so downstream stability analysis never sees an identity
    placeholder.

    Args:
      cfg: model config at the accurate dtype (the replay runs df64
        internally regardless).
      params, key: traced map parameters / CRN key — safe to vary across
        calls sharing ``jit_cache``.
      x0: initial iterate.
      ncfg: solver parameters; ``fd_epsilon`` should be ~1e-5 (set by
        :func:`newton_solve_staged` when it routes here).  ``fd_mode``
        selects the stencil: ``"frozen-fwd"`` = one-sided forward FD —
        ``n + 1`` stencil points instead of ``2n + 1`` (4/7 the replay
        rows per iteration at n=3) at ~3e-6 relative Jacobian accuracy
        (measured N=512 f64 at eps=1e-7; truncation ~30*eps, the df64
        noise floor only bites below 1e-8) — still far better than
        Newton needs to converge, while central's ~1.2e-7 floor is the
        better choice when the exported Jacobian feeds eigenvalue
        analysis near criticality.  Anything else = central (default).
      jit_cache: optional dict shared across calls — holds the jitted
        schedule-pass and fused-FD programs (the replay trace is ~13 s at
        N=4096; a sweep pays it once).
      mesh: optional :class:`jax.sharding.Mesh` — shard the fused stencil
        replay's flat ``stencil * n_real`` row axis over ``mesh_axis``
        (GSPMD; see :func:`..model.emap.frozen_schedule_map_batched`).
        The stencil spreads across devices like extra realisations: the
        replay loop itself needs no collectives.  A cache
        serves exactly ONE ``(cfg, mesh)`` setup — enforced by the
        identity guard below (the cached schedule/fused programs bake
        the mesh constraint in); use a fresh cache per setup.
      mesh_axis: mesh axis name for the rows (default ``"real"``).
    """
    cache = jit_cache if jit_cache is not None else {}
    n = x0.shape[0]
    dt_ = cfg.jdtype
    fwd = ncfg.fd_mode == "frozen-fwd"
    # Clamp the radius into the measured-valid window (N=512 f64, relative
    # error of the FD Jacobian vs jacfwd): eps=1e-3 crosses discrete-outcome
    # boundaries (error ~1, the ROADMAP "staircase" failure); central:
    # 1e-4 → 5e-5, 1e-5..1e-7 → ~1.2e-7 (the smooth piece's own curvature
    # floor); forward: truncation ~30*eps (2.99e-5 at 1e-6, 3e-6 at 1e-7),
    # so its window sits a decade lower.  A default-config fd_epsilon
    # (1e-2, tuned for the fp32 stage) must not leak in; below the lower
    # edge the df64 noise floor (~1e-13 abs) starts to bite.
    lo, hi, dflt = (1e-8, 1e-5, 1e-6) if fwd else (1e-7, 1e-4, 1e-5)
    # out-of-window radii reset to the DEFAULT, not the window edge: a
    # leaked fp32-stage epsilon (1e-2) clamped to `hi` would still sit at
    # the worst-error end of the window
    eps = jnp.asarray(ncfg.fd_epsilon
                      if lo <= ncfg.fd_epsilon <= hi else dflt, dt_)

    # The cached programs bake in cfg (schedule pass + replay closures)
    # and the mesh constraint; eps/params/key are traced arguments and
    # fd_mode gets its own fused key, so those may vary across calls.
    ident = ("frozen", cfg, mesh, mesh_axis)
    if cache.setdefault("_frozen_identity", ident) != ident:
        raise ValueError(
            "jit_cache was built for a different (cfg, mesh) — its cached "
            "schedule/fused programs close over them.  Use a fresh cache "
            "for a different setup.")

    _ensure_frozen_programs(cache, cfg, n, dt_, fwd, mesh, mesh_axis)
    fused_key = "fused_fwd" if fwd else "fused"

    def evaluate(z, ep):
        sched, n_ev, ii = cache["sched"](z, params, key)
        return cache[fused_key](z, ep, sched, n_ev, ii, params, key)

    def score(z):
        # returns the residual AND the discovered schedule so a winning
        # scored trial's Jacobian fill-in (``fill``) reuses it instead of
        # re-running the f32 discovery evolve at the same point
        sched, n_ev, ii = cache["sched"](z, params, key)
        return (cache["score"](z, sched, n_ev, ii, params, key),
                (sched, n_ev, ii))

    def fill(z, ep, aux):
        sched, n_ev, ii = aux
        return cache[fused_key](z, ep, sched, n_ev, ii, params, key)

    return frozen_newton_loop(evaluate, x0.astype(dt_), ncfg, dt_, eps,
                              backtrack=True, score=score, fill=fill)


def frozen_newton_loop(evaluate, x0: jax.Array, ncfg: NewtonConfig,
                       dt_, eps, *, backtrack: bool,
                       score=None, fill=None) -> NewtonResult:
    """Shared host Newton loop over a fused ``evaluate(x, eps) -> (F, J)``
    program — the policy layer of :func:`newton_solve_frozen` and the
    bordered arclength corrector
    (:func:`..analysis.continuation.make_arclength_step_frozen`), kept in
    ONE place so hardening lands in both (a round-3 review finding: the two
    copies had already drifted).

    Both callers share: the non-finite-Jacobian retry at an 8x tighter
    radius (an FD probe across a fire/no-fire boundary gets rejected by the
    replay's consistency guard and poisons its column — NaN when every
    realisation drops), the residual history/print plumbing, and the
    divergence cutoff (``ncfg.divergence_factor``; NaN-inclusive, fires
    before paying the next evaluation).

    ``backtrack`` selects the step policy — a deliberate fork, not drift:

    * ``True`` (converging solves, :func:`newton_solve_frozen`):
      backtracking step trials — full step, up to 3 halvings while the
      residual grows, best candidate wins — plus a tighter-eps Jacobian
      refresh retry when every candidate is worse (an FD probe across an
      event-reordering boundary fabricates a finite-but-huge Jacobian
      entry; re-differencing at ``eps / 8`` is 8x less likely to straddle
      it).  Costs nothing on the usual monotone path.  When ``score`` is
      given (a residual-only ``z -> F(z)`` program), trials after the
      first are *scored* instead of fully evaluated — one replay row per
      losing trial instead of the (n+1)/(2n+1)-row fused stencil — and
      the winning candidate's (F, J) is then computed by one fused launch
      (skipped when the first, already-fused trial wins).  The monotone
      path is unchanged: exactly one fused launch per iteration.
    * ``False`` (continuation walkers): plain damped steps.  Walkers probe
      PAST branch ends by design and count on failing correctors being
      cheap (the divergence cutoff stops them in ~2 iterations, measured
      ~6x on boundary-walk collapse phases); backtracking would spend up
      to 4 evaluations per iteration trying to rescue a step that SHOULD
      fail.
    """
    test = residual_norm_criterion(ncfg.tolerance)

    def ev(z, ep):
        f_, j_ = evaluate(z, ep)
        if not bool(jnp.all(jnp.isfinite(j_))):
            f_, j_ = evaluate(z, ep / 8.0)
        return f_, j_

    if ncfg.print_output:
        _print_header(ncfg.max_iterations, ncfg.tolerance)

    x = x0
    f, jac = ev(x, eps)
    norm = jnp.linalg.norm(f)
    norm0 = float(norm)
    history = [float(norm)]
    if ncfg.print_output:
        _print_iteration(0, norm)
    converged = bool(test(norm))
    it = 0

    def attempt(x, direction, norm_ref):
        """Backtracking step trial (see ``backtrack=True`` above); returns
        the best ``(norm, x, f, jac, norm_arr)`` candidate seen.  Measured
        motivation: a rough fp32 hand-off at N=512 R=8 sigma=0.1 sent the
        first full Newton step 2.2e-2 -> 3.9 and onward to a root in the
        wrong basin.  Trials after the first use the residual-only
        ``score`` program when available (hybrid scoring, VERDICT r3 #7);
        a scored winner's Jacobian is filled in by one fused launch at
        the end."""
        best = None
        scale = float(ncfg.damping)
        for i in range(4):
            x_try = x + jnp.asarray(scale, dt_) * direction
            if i == 0 or score is None:
                f_new, jac_new, aux = *ev(x_try, eps), None
            else:
                (f_new, aux), jac_new = score(x_try), None
            n_try = jnp.linalg.norm(f_new)
            n_val = float(n_try)
            # replace a NaN best with any finite candidate (NaN compares
            # False against everything, so `n_val < best[0]` alone would
            # keep a NaN first try forever)
            if (best is None or best[0] != best[0]
                    or (n_val == n_val and n_val < best[0])):
                best = (n_val, x_try, f_new, jac_new, n_try, aux)
            if n_val == n_val and n_val <= norm_ref:
                break
            scale *= 0.5
        if best[3] is None:
            # a scored trial won: one replay launch (reusing the score's
            # discovered schedule via ``fill`` when available) supplies its
            # Jacobian and the authoritative (F, |F|), keeping the loop
            # state self-consistent
            if fill is not None and best[5] is not None:
                f_b, jac_b = fill(best[1], eps, best[5])
                if not bool(jnp.all(jnp.isfinite(jac_b))):
                    # same non-finite-Jacobian retry contract as ``ev``:
                    # a stencil point straddling an event-reordering
                    # boundary can poison the schedule-reusing fill; a
                    # fresh evaluate (with its own eps/8 fallback) keeps
                    # the loop from installing a NaN Jacobian that the
                    # fused-trial path would have refreshed
                    f_b, jac_b = ev(best[1], eps)
            else:
                f_b, jac_b = ev(best[1], eps)
            n_b = jnp.linalg.norm(f_b)
            best = (float(n_b), best[1], f_b, jac_b, n_b, None)
        return best

    while it < ncfg.max_iterations and not converged:
        if (ncfg.divergence_factor != float("inf")
                and not (float(norm) <= ncfg.divergence_factor * norm0)):
            break    # runaway iterate (NaN-inclusive): stop paying
        if backtrack:
            best = attempt(x, solve_dense(jac, -f), float(norm))
            if not (best[0] <= float(norm)):
                # Every backtracked candidate made things worse (or NaN):
                # refresh residual + Jacobian AT x with the tighter radius
                # and retry once; if that still fails, accept the best
                # candidate seen — on the jump landscape a transient
                # increase can be unavoidable, and the capture-range
                # staging hands off to the polish early anyway.
                f_r, jac_r = evaluate(x, eps / 8.0)
                if bool(jnp.all(jnp.isfinite(jac_r))):
                    best_r = attempt(x, solve_dense(jac_r, -f_r),
                                     float(norm))
                    if best_r[0] == best_r[0] and not (best_r[0] >= best[0]):
                        best = best_r
            _, x, f, jac, norm, _ = best
        else:
            x = x + jnp.asarray(ncfg.damping, dt_) * solve_dense(jac, -f)
            f, jac = ev(x, eps)
            norm = jnp.linalg.norm(f)
        it += 1
        history.append(float(norm))
        if ncfg.print_output:
            _print_iteration(it, norm)
        converged = bool(test(norm))

    if ncfg.print_output:
        _print_footer(it, converged)

    hist = jnp.full((ncfg.max_iterations + 1,), jnp.nan, dt_)
    hist = hist.at[:len(history)].set(jnp.asarray(history, dt_))
    return NewtonResult(solution=x, converged=jnp.asarray(converged),
                        iterations=jnp.int32(it), residual_norm=norm,
                        residual_history=hist, jacobian=jac, residual=f)


def _resolve_staged(cfg: ModelConfig, tolerance: float,
                    stage1_ncfg, stage2_ncfg, stage2_tolerance,
                    evolve_backend: str):
    """Resolve the staged recipe's defaults (shared by
    :func:`newton_solve_staged` and :func:`staged_aot_warmup` so the
    warmup builds programs under EXACTLY the solve's identity)."""
    # The accurate stage differentiates the map (exact mode) and solves in
    # f64, which the raw GPU kernel can do neither of (fp32-only, no JVP)
    # — resolve "auto"/"pallas" at the library boundary to the native-f64
    # XLA evolve.  An explicit frozen stage 2 runs only on the df64 replay,
    # so it is the caller's request for that backend.
    frozen = ("frozen", "frozen-fwd")
    if (stage2_ncfg is not None and stage2_ncfg.fd_mode in frozen
            and evolve_backend in ("auto", "pallas")):
        evolve_backend = "replay"
    evolve_backend = accurate_backend(evolve_backend)
    # The event-time roots must resolve far below the residual target —
    # crossing times feed the restriction lerp directly, so root error is
    # residual error.  Tighten a default-config root_tol (1e-6, the
    # reference's parameters.hpp value) to 1e-4x the target; an already
    # tighter caller value is kept.
    cfg = cfg.with_(root_tol=min(cfg.root_tol, 1e-4 * tolerance))
    cfg32 = cfg.with_(dtype="float32",
                      root_tol=max(cfg.root_tol, 1e-6))
    if stage1_ncfg is None:
        stage1_ncfg = NewtonConfig(tolerance=tolerance, max_iterations=6,
                                   fd_epsilon=1e-3, fd_mode="central")
    if stage2_tolerance is None:
        if stage2_ncfg is None and evolve_backend != "replay":
            # The default stage-2 on a non-replay backend is EXACT mode
            # (see below), which should drive all the way to the polish
            # target: with machine-grade Jacobians one extra quadratic
            # iteration is cheaper than the frozen-Jacobian polish
            # crawling linearly from the 5x capture range (capture-range
            # staging once took 54 iterations, the polish grinding its
            # whole 40-iteration budget, against 12 direct-to-0.9x; callers
            # building an explicit exact stage2_ncfg should set its
            # tolerance the same way — bench.py's exact variant does).
            # The frozen modes keep the capture range: their stencil
            # Jacobian is cheap per iteration but not quadratic-grade at
            # the floor.
            stage2_tolerance = 0.9 * tolerance
        else:
            stage2_tolerance = 5.0 * tolerance
    if stage2_ncfg is None:
        # budget 6, but the stage stops at stage2_tolerance — from a good
        # fp32 hand-off (~2e-5 at reference scale) that is 1-2 iterations;
        # the slack only spends when the fp32 floor is high (small
        # ensembles), where damped Newton needs the extra steps (a
        # divergence cutoff here was tried and rejected: an early
        # transient overshoot is normal from a rough hand-off, and
        # cutting it off hands the polish a diverged iterate).
        # Native f64 (the default backend) takes exact jacfwd Jacobians.
        # The frozen modes run the df64 REPLAY unconditionally
        # (newton_solve_frozen's whole design is the frozen-schedule
        # replay), so they are the default only under an explicit
        # evolve_backend="replay": "frozen-fwd", one (n+1)-point stencil
        # replay per iteration at ~3e-6 Jacobian accuracy, with
        # newton_solve_frozen's backtracking + eps-refresh hardening.
        mode = "frozen-fwd" if evolve_backend == "replay" else "exact"
        stage2_ncfg = NewtonConfig(tolerance=stage2_tolerance,
                                   max_iterations=8 if mode == "exact"
                                   else 6, fd_mode=mode,
                                   fd_epsilon=1e-6)

    if (stage2_ncfg.fd_mode in ("frozen", "frozen-fwd")
            and evolve_backend != "replay"):
        raise ValueError(
            f"stage2_ncfg.fd_mode={stage2_ncfg.fd_mode!r} runs the df64 "
            f"replay unconditionally, but evolve_backend="
            f"{evolve_backend!r} was requested — stage 2 would converge "
            "on the replay residual while the polish and the final "
            "converged flag use the requested backend's (they differ by "
            "the ~1e-8 replay-vs-f64 delta).  Use evolve_backend='replay' "
            "with the frozen modes, or fd_mode='exact'/'central' with "
            "this backend.")
    return cfg, cfg32, stage1_ncfg, stage2_ncfg, evolve_backend


def _ensure_stage1_program(cache: dict, cfg: ModelConfig, cfg32: ModelConfig,
                           stage1_ncfg: NewtonConfig, mesh,
                           mesh_axis: str) -> None:
    """Populate ``cache["stage1"]`` (idempotent): the jitted fp32 fused
    Newton solve ``(z32, params32, key) -> NewtonResult``."""
    if "stage1" in cache:
        return
    from ..model import emap as _emap
    from ..model.restrict import masked_ensemble_mean

    dt_acc = cfg.jdtype

    def _draw32(p32, k):
        # ONE stochastic realisation across every stage (the docstring
        # contract): the heterogeneity draw happens at the ACCURATE
        # dtype and is cast to f32.  jax.random.normal(key, dtype=f32)
        # is a different bit stream than the f64 draw from the same
        # key, so sampling per-stage made the fp32 stage solve a
        # DIFFERENT realisation of the map at sigma > 0 — an O(MC
        # difference) hand-off error instead of O(f32 rounding)
        # (round-3 review finding).
        p_acc = jax.tree.map(lambda x: jnp.asarray(x, dt_acc), p32)
        return _emap.sample_beta(cfg, p_acc, k).astype(jnp.float32)

    use_pal = (mesh is None
               and _emap.select_pallas_evolve(cfg32, "auto"))
    if mesh is None:
        cst32 = None
    else:
        from ..parallel.sharding import ensemble_constraint
        cst32 = ensemble_constraint(mesh, mesh_axis)

    def _F32(z, p, k):
        beta = _draw32(p, k)
        if cst32 is not None:
            beta = cst32(beta)
        U, _, _, _, res, positions = _emap.run_pipeline(
            cfg32, p, z, beta, use_pallas=use_pal)
        u_mean, _ = masked_ensemble_mean(positions, res.accept)
        return _emap.assemble_residual(cfg32, U, u_mean)

    def _stage1(z, p, k):
        return newton_solve(lambda zz: _F32(zz, p, k), z, stage1_ncfg)
    cache["stage1"] = jax.jit(_stage1)


def _ensure_accurate_residual(cache: dict, cfg: ModelConfig,
                              evolve_backend: str, mesh, mesh_axis: str):
    """Populate and return ``cache["F_acc"]`` (idempotent): the accurate
    residual ``(z, params, key) -> f`` with (params, key) as TRACED
    arguments — closing over them would bake one step's values into the
    cached jaxprs as constants and silently pin a sweep to step 0's map."""
    if "F_acc" not in cache:
        if mesh is None:
            def _F_acc(z, p, k):
                return event_driven_map(cfg, p, k, z,
                                        evolve_backend=evolve_backend)
        else:
            # (z, p, k) -> f with the ensemble GSPMD-constrained: the same
            # traced map as ``event_driven_map``, partitioned by XLA
            from ..parallel.sharding import make_gspmd_map_fn
            _F_acc = make_gspmd_map_fn(cfg, mesh, mesh_axis, evolve_backend)
        cache["F_acc"] = _F_acc
    return cache["F_acc"]


def staged_aot_warmup(cfg: ModelConfig, params: MapParams, key: jax.Array,
                      Z0: jax.Array, *,
                      tolerance: float = 1e-8,
                      stage1_ncfg: Optional[NewtonConfig] = None,
                      stage2_ncfg: Optional[NewtonConfig] = None,
                      stage2_tolerance: Optional[float] = None,
                      evolve_backend: str = "auto",
                      jit_cache: Optional[dict] = None,
                      mesh=None, mesh_axis: str = "real",
                      max_workers: int = 5) -> dict:
    """Ahead-of-time trace + PARALLEL compile of every device program a
    :func:`newton_solve_staged` call with the same arguments will use.

    The reference pays ~zero compile (``nvcc`` ahead of time,
    ``NewtonSolver.cpp:40-161`` just runs); here a cold staged solve
    traces and compiles ~5 distinct programs before its first Newton
    step.  Tracing is Python (GIL-bound — runs serially here by design),
    but XLA compilation releases the GIL, so the programs' compiles
    overlap in a thread pool.

    Populates ``jit_cache`` with the SAME program objects the solve will
    look up (via the shared ``_ensure_*`` helpers), so the following
    ``newton_solve_staged(..., jit_cache=jit_cache)`` starts fully warm:
    ``jax.jit``'s AOT path (``.lower().compile()``) inserts the
    executable into the function's dispatch cache (verified on this
    JAX version — the first post-AOT call pays execution only).

    Returns a breakdown dict::

        {"programs": {name: {"trace_s": ..., "compile_s": ...}},
         "trace_total_s": ..., "compile_wall_s": ..., "total_s": ...}

    ``compile_wall_s`` is the wall-clock of the parallel-compile phase —
    compare with ``sum(compile_s)`` for the overlap factor.
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    cache = jit_cache if jit_cache is not None else {}
    (cfg, cfg32, stage1_ncfg, stage2_ncfg, evolve_backend) = _resolve_staged(
        cfg, tolerance, stage1_ncfg, stage2_ncfg, stage2_tolerance,
        evolve_backend)
    ident = (cfg, evolve_backend, stage1_ncfg, stage2_ncfg, mesh, mesh_axis)
    if cache.setdefault("_identity", ident) != ident:
        raise ValueError(
            "jit_cache was built for a different (cfg, evolve_backend, "
            "stage configs, mesh).  Use a fresh cache.")
    dt_acc = cfg.jdtype
    n = int(Z0.shape[0])
    params32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    z32 = Z0.astype(jnp.float32)
    z64 = Z0.astype(dt_acc)

    _ensure_stage1_program(cache, cfg, cfg32, stage1_ncfg, mesh, mesh_axis)
    F_acc = _ensure_accurate_residual(cache, cfg, evolve_backend, mesh,
                                      mesh_axis)
    sub = cache.setdefault("stage2_cache", {})
    # the polish / host-Newton programs share the F identity contract of
    # newton_solve_host / frozen_jacobian_polish
    sub.setdefault("_F_identity", F_acc)
    sub.setdefault("F", jax.jit(F_acc))

    frozen = stage2_ncfg.fd_mode in ("frozen", "frozen-fwd")
    work = [("stage1", cache["stage1"], (z32, params32, key)),
            ("F", sub["F"], (z64, params, key))]
    if frozen:
        fwd = stage2_ncfg.fd_mode == "frozen-fwd"
        sub.setdefault("_frozen_identity", ("frozen", cfg, mesh, mesh_axis))
        _ensure_frozen_programs(sub, cfg, n, dt_acc, fwd, mesh, mesh_axis)
        # the stencil programs consume the schedule pass's outputs: get
        # their exact shapes/dtypes without running anything
        sh = jax.eval_shape(sub["sched"], z64, params, key)
        sched_d, n_ev_d, ii_d = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), sh)
        eps_d = jnp.asarray(stage2_ncfg.fd_epsilon, dt_acc)
        fused_key = "fused_fwd" if fwd else "fused"
        work += [("sched", sub["sched"], (z64, params, key)),
                 (fused_key, sub[fused_key],
                  (z64, eps_d, sched_d, n_ev_d, ii_d, params, key)),
                 ("score", sub["score"],
                  (z64, sched_d, n_ev_d, ii_d, params, key))]
    elif stage2_ncfg.fd_mode == "exact":
        sub.setdefault("J", jax.jit(jacfwd_cols(F_acc)))
        work.append(("J", sub["J"], (z64, params, key)))

    t_all0 = _time.perf_counter()
    out = {"programs": {}}
    lowered = {}
    for name, prog, args in work:
        t0 = _time.perf_counter()
        lowered[name] = prog.lower(*args)
        out["programs"][name] = {"trace_s": round(
            _time.perf_counter() - t0, 2)}
    out["trace_total_s"] = round(sum(p["trace_s"]
                                     for p in out["programs"].values()), 2)

    def _compile(name):
        t0 = _time.perf_counter()
        lowered[name].compile()
        return round(_time.perf_counter() - t0, 2)

    t0 = _time.perf_counter()
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {name: ex.submit(_compile, name) for name in lowered}
        for name, fut in futs.items():
            out["programs"][name]["compile_s"] = fut.result()
    out["compile_wall_s"] = round(_time.perf_counter() - t0, 2)
    out["total_s"] = round(_time.perf_counter() - t_all0, 2)
    return out


def newton_solve_staged(cfg: ModelConfig, params: MapParams, key: jax.Array,
                        Z0: jax.Array, *,
                        tolerance: float = 1e-8,
                        stage1_ncfg: Optional[NewtonConfig] = None,
                        stage2_ncfg: Optional[NewtonConfig] = None,
                        stage2_tolerance: Optional[float] = None,
                        polish_iterations: int = 40,
                        evolve_backend: str = "auto",
                        jit_cache: Optional[dict] = None,
                        basin_radius: float = 1.0,
                        mesh=None, mesh_axis: str = "real") -> NewtonResult:
    """Solve the event-driven map to ``tolerance`` via the staged recipe.

    Args:
      cfg: model config at the *accurate* dtype (``float64``; the fp32
        stage derives its own config via ``cfg.with_(dtype="float32")``).
      params, key: map parameters and the common-random-numbers key
        (shared by every stage — the stages walk ONE realisation of the
        stochastic map).
      Z0: initial guess (any float dtype).
      tolerance: final residual-norm target (in the accurate backend).
      stage1_ncfg: fp32 stage solver config; default 6 damped iterations
        of central FD at the f32-appropriate epsilon 1e-3.
      stage2_ncfg: accurate-stage config; default ``fd_mode="exact"``
        (``jacfwd_cols`` through the native-f64 map, up to 8 iterations).
        Under ``evolve_backend="replay"`` the default is
        ``fd_mode="frozen-fwd"``: the one-sided frozen-schedule stencil
        through :func:`newton_solve_frozen`, one batched ``(n+1)``-point
        replay per iteration, ~3e-6 relative Jacobian accuracy;
        ``"frozen"`` is its central ``(2n+1)``-point form (~3e-7).  The
        frozen modes run only on the replay: passing one with
        ``evolve_backend="auto"`` selects the replay, with ``"xla"`` it
        raises.  ``fd_mode="central"`` is plain central FD on the full
        map.
      stage2_tolerance: override for the stage-2 stopping norm (default
        ``0.9 * tolerance`` for the default exact stage, ``5 *
        tolerance`` otherwise: the polish's capture range).
      polish_iterations: frozen-Jacobian polish budget (each is one map
        evaluation).
      evolve_backend: accurate-stage backend (``"xla"`` = native f64;
        ``"replay"`` = df64 schedule replay, refused on a GPU);
        ``"auto"``/``"pallas"`` resolve to native f64
        (:func:`..model.emap.accurate_backend`) — the raw GPU kernel is
        fp32-only and defines no JVP.
      basin_radius: max-norm distance from ``Z0`` beyond which a converged
        result still triggers the rescue pass (basin fidelity — the map
        has coexisting wave families ~10 apart in the time-offset
        coordinates, and distance from the guess is the only signal that
        separates "converged in the caller's basin" from "escaped to the
        other family or a period alias"; see the rescue block).  The
        default 1.0 sits far above warm-sweep drift (~0.05 per 0.1 in
        beta) and far below the family separation.  ``float("inf")``
        disables the distance trigger (cold exploratory solves where any
        root is welcome).
      jit_cache: optional dict shared across calls (parameter sweeps)
        so re-solves pay zero re-tracing — ``params``/``key`` are traced
        arguments of every cached program, so the cache stays valid as
        they change step to step.  ``cfg`` (including the ``root_tol``
        derived from ``tolerance``), the stage configs, and the backend
        must be identical on every call — enforced with a ``ValueError``
        (the cached programs bake them in).
      mesh: optional :class:`jax.sharding.Mesh` — run the WHOLE recipe
        with the realisation ensemble sharded over ``mesh_axis`` (GSPMD):
        the fp32 stage's map constrains its ``beta`` rows (XLA evolve —
        a ``pallas_call`` cannot be partitioned), the frozen stage shards
        its fused stencil rows (:func:`newton_solve_frozen` ``mesh``),
        and the accurate residual behind the exact stage and the polish
        constrains its ensemble the same way.  GSPMD partitions the SAME
        traced program, so results match the unsharded solve to
        reduction-order rounding; the replay's f32 schedule pass is
        pinned to the XLA backend under a mesh.
      mesh_axis: mesh axis name for realisations (default ``"real"``).

    Returns:
      :class:`NewtonResult` whose ``solution``/``residual_norm`` come
      from the best polished iterate; ``iterations`` is the total across
      all three stages; ``converged`` reflects the final target.

    Basin note: the contract is "a root of the accurate map to
    ``tolerance``", not "the same root a direct f64 solve from ``Z0``
    finds".  The map can have coexisting same-speed solutions ~0.04
    apart in spike spacing (and a coexisting fast wave family ~10 away
    in the time-offset coordinates); at reference ensemble scales the
    fp32 stage hands off within ~2e-5 of a root and the staging
    preserves the basin, but at small/noisy configs it may land in a
    neighbouring one.  If the staged pipeline ends above ``tolerance``,
    out of the gauge domain, or farther than ``basin_radius`` from
    ``Z0``, a rescue pass re-solves from ``Z0`` directly on the accurate
    backend (basin-faithful, cached programs) and the better result wins
    (converged-in-domain-nearer first, then deeper residual).  Verify
    the returned ``residual_norm`` (it is a plain, independently
    recomputable ``|F|``) and the wave speed ``solution[0]`` if basin
    identity matters.
    """
    cache = jit_cache if jit_cache is not None else {}
    (cfg, cfg32, stage1_ncfg, stage2_ncfg, evolve_backend) = _resolve_staged(
        cfg, tolerance, stage1_ncfg, stage2_ncfg, stage2_tolerance,
        evolve_backend)
    dt_acc = cfg.jdtype
    params32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)

    # The cached programs bake in everything resolved above — a cache built
    # under a different identity would silently solve the wrong problem
    # (e.g. a tightened `tolerance` changes root_tol inside cfg).  Fail
    # loudly.
    ident = (cfg, evolve_backend, stage1_ncfg, stage2_ncfg, mesh, mesh_axis)
    if cache.setdefault("_identity", ident) != ident:
        raise ValueError(
            "jit_cache was built for a different (cfg, evolve_backend, "
            "stage configs, mesh) — including the root_tol derived from "
            "`tolerance`.  Use a fresh cache for a different setup.")

    _ensure_stage1_program(cache, cfg, cfg32, stage1_ncfg, mesh, mesh_axis)
    r32 = cache["stage1"](Z0.astype(jnp.float32), params32, key)
    jax.block_until_ready(r32.solution)
    # fp32 FD Newton can blow up on rough small-ensemble landscapes; a
    # non-finite OR 0-iteration stage 1 falls back to the caller's guess
    # AT FULL PRECISION (no f32 round-trip — a warm-started f64 sweep
    # guess carries digits the f32 stage never saw, and a 0-iteration
    # "solution" is exactly that guess rounded to f32; stage 2's exact
    # Jacobians are the robust solver, just slower per iteration)
    if (bool(jnp.all(jnp.isfinite(r32.solution)))
            and int(r32.iterations) > 0):
        handoff = r32.solution.astype(dt_acc)
        stage1_iters = int(r32.iterations)
    else:
        handoff = Z0.astype(dt_acc)
        stage1_iters = 0

    F_acc = _ensure_accurate_residual(cache, cfg, evolve_backend, mesh,
                                      mesh_axis)
    sub = cache.setdefault("stage2_cache", {})

    def accurate_solve(x_start):
        """df64 Newton + frozen-Jacobian polish from ``x_start``; returns
        ``(pol, jac, iters)`` with every program drawn from ``sub``."""
        if stage2_ncfg.fd_mode in ("frozen", "frozen-fwd"):
            # fused residual + frozen-schedule FD Jacobian (one schedule
            # pass + one (2n+1)- or (n+1)-wide batched replay per
            # iteration); its residual IS the replay residual, consistent
            # with the polish below (_resolve_staged allows the frozen
            # modes only with evolve_backend == "replay")
            res = newton_solve_frozen(cfg, params, key, x_start,
                                      stage2_ncfg, jit_cache=sub,
                                      mesh=mesh, mesh_axis=mesh_axis)
        else:
            res = newton_solve_host(F_acc, x_start, stage2_ncfg,
                                    jit_cache=sub, F_args=(params, key))
        # a diverged Newton stage (non-finite iterate) must not poison the
        # polish: restart it from x_start with the exported Jacobian
        # (evaluated before the divergence)
        x2 = res.solution
        if not bool(jnp.all(jnp.isfinite(x2))):
            x2 = x_start
        jac = res.jacobian
        if (int(res.iterations) == 0
                and stage2_ncfg.fd_mode not in ("frozen", "frozen-fwd")):
            # (the frozen modes are exempt: their fused launch always
            # computes a real Jacobian, even on a 0-iteration solve)
            # Newton met ITS (capture-range) tolerance at entry without a
            # single step, so it exported the identity placeholder —
            # useless to the polish (which would stall above the final
            # target) AND wrong for any consumer of the returned
            # ``jacobian`` (stability analysis eigendecomposes it).
            # Compute one real Jacobian (the same cached program the
            # stage would have used).
            if stage2_ncfg.fd_mode == "exact":
                Jf = sub.setdefault("J", jax.jit(jacfwd_cols(F_acc)))
                jac = Jf(x2, params, key)
            else:
                from .newton import central_fd_jacobian
                jac = central_fd_jacobian(
                    lambda z: sub["F"](z, params, key), x2,
                    stage2_ncfg.fd_epsilon)
        pol = frozen_jacobian_polish(F_acc, x2, jac,
                                     max_iterations=polish_iterations,
                                     tolerance=0.9 * tolerance,
                                     jit_cache=sub, F_args=(params, key))
        return pol, jac, int(res.iterations) + int(pol.iterations)

    def _in_domain(z) -> bool:
        """Gauge-domain validity of a root.  ``Z[1:]`` are spike TIME
        offsets (the reference seeds spike ``m`` at ring position
        ``-c * U[m]``, ``EventDrivenMap.cu:364-372``), so one unwrapped
        temporal period of the wave is ``2L / c`` — the domain test is on
        the POSITIONS ``c * z_i in (0, 2L)``, not on ``z_i`` directly.
        The distinction is load-bearing: the genuine FAST wave family
        (``artifacts/enumerated_branches/branch_2..4``, the branch whose
        fold ``--track-fold`` solves) lives at ``z_2 ~ 10-15`` with
        ``c ~ 0.5`` — position 5.5 < 2L = 6, inside one period — and a
        ``z < 2L`` test would misclassify every root on it as degenerate
        (an earlier round-3 state did exactly that).  What this rejects:
        non-finite iterates, ``c <= 0``, and period aliases
        (``c * z`` outside ``(0, 2L)`` — the map being periodic, those
        are at best wrapped copies of an in-domain root)."""
        import numpy as np
        zz = np.asarray(z)
        if not (np.all(np.isfinite(zz)) and zz[0] > 0.0):
            return False
        pos = zz[0] * zz[1:]
        return bool(np.all(pos > 0.0)
                    and np.all(pos < 2.0 * cfg.half_width))

    def _dist(z) -> float:
        """Max-norm distance from the caller's guess (inf if non-finite)."""
        import numpy as np
        zz = np.asarray(z, float)
        if not np.all(np.isfinite(zz)):
            return float("inf")
        return float(np.max(np.abs(zz - np.asarray(Z0, float))))

    pol, jac, acc_iters = accurate_solve(handoff)
    if ((not (float(pol.residual_norm) <= tolerance)
         or not _in_domain(pol.solution)
         or _dist(pol.solution) > basin_radius) and stage1_iters > 0):
        # Rescue pass: on rough small-ensemble landscapes the fp32 stage
        # can hand off into the wrong basin (observed at N=512, R=8 with a
        # cold guess 0.2 away in beta) or stage 2 can escape the guess's
        # basin entirely — measured at N=512 R=8 sigma=0.1, a hand-off
        # sitting ON a discrete-outcome boundary sent stage 2 to the
        # coexisting FAST-family root (0.49, 0.58, 11.07), |F| = 3e-13,
        # genuine and in-domain but ~10 away from the caller's slow-family
        # guess.  Domain tests cannot catch that (both roots are valid
        # waves); the ``basin_radius`` distance trigger can.  Re-solve
        # from the CALLER'S guess on the accurate backend — slower per
        # iteration but basin-faithful.  Skipped when stage 1 already
        # started there (stage1_iters == 0 fallback).  The convergence
        # guard is NaN-inclusive (`not <=`, NOT `>`): an all-rejected map
        # returns a NaN norm, exactly the hand-off the rescue exists for.
        pol_r, jac_r, iters_r = accurate_solve(Z0.astype(dt_acc))
        acc_iters += iters_r
        nr, n0 = float(pol_r.residual_norm), float(pol.residual_norm)
        # a converged in-domain rescue beats a result that is out-of-domain
        # or farther from the caller's guess (basin fidelity); otherwise
        # deeper residual wins (NaN-aware)
        if (nr <= tolerance and _in_domain(pol_r.solution)
                and (not _in_domain(pol.solution)
                     or _dist(pol_r.solution) < _dist(pol.solution))):
            pol, jac = pol_r, jac_r
        elif nr < n0 or (nr == nr and n0 != n0):  # deeper, or rescue is
            pol, jac = pol_r, jac_r               # finite where pol is NaN

    # convenience handle for callers (bench's independent residual check):
    # the accurate-backend residual at THIS call's (params, key), through
    # the cached jit.  Overwritten per call by design.
    cache["F_acc_fn"] = lambda z: sub["F"](z, params, key)
    total_iters = stage1_iters + acc_iters
    return NewtonResult(
        solution=pol.solution,
        converged=jnp.asarray(float(pol.residual_norm) <= tolerance),
        iterations=jnp.int32(total_iters),
        residual_norm=pol.residual_norm,
        residual_history=pol.residual_history,
        jacobian=jac,
        residual=pol.residual)
