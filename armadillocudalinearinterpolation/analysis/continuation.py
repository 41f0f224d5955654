"""Pseudo-arclength continuation of map fixed points (beyond the reference).

The reference's production loop (commented out, ``Driver.cu:86-114``)
steps ``beta`` naively (``beta += 0.1``) and therefore cannot pass folds —
round-1 artifacts show the natural-parameter sweep dying at the branch ends
(``beta ~ 19.3`` and ``~ 3.1``, see ``artifacts/README.md``).  Pseudo-arclength
embeds the parameter into the unknowns, ``y = (Z, beta)``, and solves

    F(Z; beta) = 0                       (n equations)
    <y - y_prev, tangent> - ds = 0       (arclength normalisation)

so the solver walks the branch *through* folds, where ``dZ/dbeta`` blows up
but ``dy/ds`` stays finite.  The Jacobian of the extended system is exact:
``jax.jacfwd`` flows through the whole event loop, and ``∂F/∂beta`` comes
from the same implicit-function-theorem JVP as ``∂F/∂Z``
(:func:`..model.events.event_time`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig, MapParams, NewtonConfig
from ..model.emap import event_driven_map
from ..solvers.newton import newton_solve, NewtonResult

# f32 dots are pinned to full precision: a GPU may run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


class ArcStep(NamedTuple):
    """One converged point on the branch."""

    y: jax.Array              # (n + 1,): (Z..., beta)
    tangent: jax.Array        # (n + 1,) unit tangent used for the next step
    converged: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


def make_extended_residual_held(cfg: ModelConfig, key: jax.Array,
                                *, param: str = "beta",
                                evolve_backend: str = "auto"):
    """Like :func:`make_extended_residual`, but the held parameter is a
    *call-time* (traced) argument: ``G(y, y_prev, tangent, ds, fixed)``.

    One jitted consumer then serves every held value without re-tracing —
    the boundary tracker's bracket probes re-use a single compiled step
    across its whole sigma schedule (each f64 extended-system trace is
    seconds-class, and the per-sigma re-jit measurably doubled per-point
    overhead).
    """
    if param not in ("beta", "sigma"):
        raise ValueError(f"param must be 'beta' or 'sigma', got {param!r}")
    dt_ = cfg.jdtype

    def G(y: jax.Array, y_prev: jax.Array, tangent: jax.Array,
          ds: jax.Array, fixed: jax.Array) -> jax.Array:
        Z, p = y[:-1], y[-1].astype(dt_)
        fixed = jnp.asarray(fixed, dt_)
        if param == "beta":
            params = MapParams(beta=p, sigma=fixed)
        else:
            params = MapParams(beta=fixed, sigma=p)
        f = event_driven_map(cfg, params, key, Z,
                             evolve_backend=evolve_backend)
        arc = jnp.dot(y - y_prev, tangent, precision=_HIGHEST) - ds
        return jnp.concatenate([f, arc[None].astype(f.dtype)])

    return G


def make_extended_residual(cfg: ModelConfig, key: jax.Array, fixed,
                           *, param: str = "beta",
                           evolve_backend: str = "auto"
                           ) -> Callable[[jax.Array, jax.Array, jax.Array, jax.Array], jax.Array]:
    """Residual of the bordered system ``G(y) = (F(Z; p), arc(y))``.

    ``param`` selects the continuation parameter: ``"beta"`` (the mean
    synaptic rate, the reference's sweep axis) or ``"sigma"`` (the
    heterogeneity std-dev — the reference's commented-out experiment,
    ``Driver.cu:76-84``, as a genuine continuation axis).  ``fixed`` is the
    held value of the other parameter.  Both partials flow through the same
    IFT event-time JVP (``d beta_draw/d sigma`` is the frozen noise, so
    ``dF/dsigma`` is exact under common random numbers).
    """
    dt_ = cfg.jdtype
    Gh = make_extended_residual_held(cfg, key, param=param,
                                     evolve_backend=evolve_backend)
    fixed = jnp.asarray(fixed, dt_)

    def G(y: jax.Array, y_prev: jax.Array, tangent: jax.Array,
          ds: jax.Array) -> jax.Array:
        return Gh(y, y_prev, tangent, ds, fixed)

    return G


def arclength_step(G, y_prev: jax.Array, tangent: jax.Array, ds,
                   ncfg: NewtonConfig) -> NewtonResult:
    """One predictor-corrector step: Euler predictor + Newton corrector.

    ``ncfg.fd_mode='exact'`` is the natural choice (the bordered Jacobian
    ``[dF/dZ  dF/dbeta; tangent^T]`` comes out of one jacfwd evaluation);
    finite differences work too.
    """
    ds = jnp.asarray(ds, y_prev.dtype)
    y0 = y_prev + ds * tangent

    def ext(y):
        return G(y, y_prev, tangent, ds)

    return newton_solve(ext, y0, ncfg)


def initial_tangent(n: int, direction: float = 1.0, dtype=jnp.float64
                    ) -> jax.Array:
    """Start along the parameter axis (the naive sweep's direction)."""
    t = jnp.zeros((n + 1,), dtype).at[-1].set(direction)
    return t


def next_tangent(y_new: jax.Array, y_prev: jax.Array, old_tangent: jax.Array
                 ) -> jax.Array:
    """Secant tangent, oriented to keep walking the same way."""
    d = y_new - y_prev
    t = d / jnp.linalg.norm(d)
    flip = jnp.dot(t, old_tangent, precision=_HIGHEST) < 0
    return jnp.where(flip, -t, t)


def key_fingerprint(key: jax.Array) -> tuple:
    """Hashable identity of a PRNG key (raw uint32 or typed), for cache
    identity tuples — the key is BAKED into cached residual programs."""
    try:
        data = jax.random.key_data(key)
    except TypeError:       # raw uint32 key array
        data = key
    return tuple(np.asarray(data).ravel().tolist())


def _params_of(param: str, p, fixed, dt_):
    p = jnp.asarray(p, dt_)
    fixed = jnp.asarray(fixed, dt_)
    return (MapParams(beta=p, sigma=fixed) if param == "beta"
            else MapParams(beta=fixed, sigma=p))


def make_arclength_step_frozen(cfg: ModelConfig, key: jax.Array, fixed,
                               param: str, ncfg: NewtonConfig, *,
                               mesh=None, mesh_axis: str = "real"):
    """Host-driven bordered corrector with a fused frozen-outcome FD
    Jacobian — drop-in for :func:`make_arclength_step_jit` when
    ``ncfg.fd_mode == "frozen"``.

    Per corrector iteration: one f32 schedule pass at the current ``y``
    discovers the discrete outcome, then ONE batched ``(2(n+1) + 1)``-point
    frozen replay (:func:`..model.emap.frozen_schedule_map`) yields the map
    residual and central-FD partials in BOTH ``Z`` and the walked parameter
    (the heterogeneity draw is frozen noise under common random numbers, so
    the parameter direction is smooth in the same piece).  The frozen map
    is the function jacfwd-through-the-replay differentiates, so the
    bordered Jacobian is jacfwd-grade (~5e-7 relative at eps = 1e-5,
    measured up to sigma = 0.5; tests/test_staged.py) at a fraction of the
    jacfwd cost and with no JVP requirement.  The arclength row is exact:
    its Jacobian row IS the tangent.

    The evolve backend is implicit (the frozen map evaluates the df64
    replay); the outer loop runs on the host with one short device program
    per step — the same bounded-dispatch rationale as
    :func:`..solvers.newton.newton_solve_host`.  ``mesh`` shards the fused
    stencil's flat row axis over ``mesh_axis`` (GSPMD; see
    :func:`..model.emap.frozen_schedule_map_batched`) — multi-chip
    boundary/branch walks.
    """
    from ..model.emap import (compute_discrete_outcome,
                              frozen_schedule_map_batched)
    from ..solvers.staged import frozen_newton_loop

    dt_ = cfg.jdtype
    n1 = cfg.n_spikes + 1
    # radius clamp: same measured-valid window as newton_solve_frozen
    # (eps = 1e-3 crosses discrete-outcome boundaries; > 1e-4 degrades)
    eps_f = ncfg.fd_epsilon
    eps_f = 1e-5 if (eps_f > 1e-4 or eps_f < 1e-7) else eps_f

    @jax.jit
    def sched_at(y):
        params = _params_of(param, y[-1], fixed, dt_)
        # mesh: the discovery evolve partitions over the ensemble like
        # the stencil replay it feeds
        return compute_discrete_outcome(cfg, params, key, y[:-1],
                                        mesh=mesh, mesh_axis=mesh_axis)

    @jax.jit
    def fused(y, ep, y_prev, tangent, ds, sched, n_ev, ii):
        e = ep * jnp.eye(n1, dtype=dt_)
        pts = jnp.concatenate([y[None, :], y[None, :] + e,
                               y[None, :] - e])              # (2n1+1, n1)

        # flat (2n1+1)*R-row replay, NOT vmap(frozen_schedule_map): under
        # vmap the replay's per-event lax.cond runs both exp branches (see
        # frozen_schedule_map_batched).  The walked parameter varies per
        # point, so the params pytree carries a leading point axis.
        params_s = jax.vmap(
            lambda t: _params_of(param, t, fixed, dt_))(pts[:, -1])
        Fv = frozen_schedule_map_batched(cfg, params_s, key, pts[:, :-1],
                                         sched, n_ev, ii,
                                         params_batched=True,
                                         row_mesh=mesh, row_axis=mesh_axis)
        JF = (Fv[1:n1 + 1] - Fv[n1 + 1:]).T / (2.0 * ep)     # (n, n1)
        arc = jnp.dot(y - y_prev, tangent, precision=_HIGHEST) - ds
        G = jnp.concatenate([Fv[0], arc[None].astype(Fv.dtype)])
        J = jnp.concatenate([JF, tangent[None, :]], axis=0)  # (n1, n1)
        return G, J

    def step(y_prev, tangent, ds) -> NewtonResult:
        y_prev = jnp.asarray(y_prev, dt_)
        tangent = jnp.asarray(tangent, dt_)
        ds = jnp.asarray(ds, dt_)
        ep = jnp.asarray(eps_f, dt_)
        y = y_prev + ds * tangent                            # Euler predictor

        def evaluate(yy, e_):
            sched, n_ev, ii = sched_at(yy)
            return fused(yy, e_, y_prev, tangent, ds, sched, n_ev, ii)

        # shared host loop (non-finite-J retry, divergence cutoff, result
        # assembly); backtrack=False — walkers probe past branch ends by
        # design and count on failing correctors being cheap
        return frozen_newton_loop(evaluate, y, ncfg, dt_, ep,
                                  backtrack=False)

    return step


def make_arclength_step_jit(cfg: ModelConfig, key: jax.Array, fixed,
                            param: str, ncfg: NewtonConfig,
                            evolve_backend: str):
    """One jitted corrector ``(y_prev, tangent, ds) -> NewtonResult`` for a
    walk at held parameter ``fixed`` — the shared program behind
    :func:`continue_branch` and the enumerator's end probes."""
    G = jax.jit(make_extended_residual(cfg, key, fixed, param=param,
                                       evolve_backend=evolve_backend))
    return jax.jit(lambda y_prev, tangent, ds_: arclength_step(
        G, y_prev, tangent, ds_, ncfg))


def continue_branch(cfg: ModelConfig, key: jax.Array, Z0, beta0, *,
                    sigma=0.0, param: str = "beta",
                    ds: float = 0.1, n_steps: int = 100,
                    direction: float = 1.0,
                    ncfg: Optional[NewtonConfig] = None,
                    evolve_backend: str = "auto",
                    min_ds: float = 1e-4, max_ds: float = 0.5,
                    grow: float = 1.3, shrink: float = 0.5,
                    max_step_factor: Optional[float] = 4.0,
                    tangent0: Optional[jax.Array] = None,
                    callback=None, reject_hook=None,
                    jit_cache: Optional[dict] = None,
                    mesh=None, mesh_axis: str = "real") -> list[ArcStep]:
    """Walk a solution branch with adaptive pseudo-arclength steps.

    Starts from a converged point ``(Z0, beta0)`` and returns the list of
    accepted :class:`ArcStep`.  The step size halves on a failed corrector
    (and retries) and grows after fast convergence, so folds — where the
    corrector works hardest — are traversed with small steps and straight
    stretches go fast.

    Args:
      param: continuation axis — ``"beta"`` walks the mean rate holding
        ``sigma`` fixed; ``"sigma"`` walks the heterogeneity std-dev holding
        ``beta0`` fixed (start value = ``sigma``).
      max_step_factor: reject a converged corrector point farther than
        ``factor * ds`` from the previous point and retry with a smaller
        step.  The arclength constraint only pins the *projection along the
        tangent*, so near a fold Newton can otherwise tunnel to a different
        solution branch entirely (observed: the slow->fast wave-family jump
        at ``beta ~ 16``, kept as ``artifacts/arclength_branches``).  Pass
        ``None`` to allow such jumps (branch discovery mode).
      callback: optional ``f(step_index, ArcStep)`` called per accepted point
        (the CLI uses this for logging/checkpointing).
      reject_hook: optional ``f(y)`` called with every corrector solution
        that *converged* but was rejected by ``max_step_factor`` — i.e. an
        observed tunnel to a distant solution (usually another wave
        family).  The branch enumerator harvests these as discovery seeds.
    """
    dt_ = cfg.jdtype
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                            fd_mode="exact")
    # walking beta holds sigma fixed and vice versa; the free value seeds y
    fixed, free0 = ((sigma, beta0) if param == "beta" else (beta0, sigma))
    # the held value is BAKED into the corrector program (unlike the walked
    # one, which lives in y) — callers sharing a jit_cache across walks
    # (the branch enumerator) must keep the whole walk setup identical
    if mesh is not None and ncfg.fd_mode not in ("frozen", "frozen-fwd"):
        # only the frozen bordered corrector takes a mesh (its fused
        # stencil shards natively); silently walking unsharded would hand
        # the caller a different program than the one they asked for
        raise ValueError(
            "mesh-sharded branch walks need a frozen corrector: pass "
            "ncfg with fd_mode='frozen' (or 'frozen-fwd'), or drop the "
            "mesh")
    cache = jit_cache if jit_cache is not None else {}
    ident = (cfg, param, float(fixed), ncfg, evolve_backend,
             key_fingerprint(key), mesh, mesh_axis)
    if cache.setdefault("_identity", ident) != ident:
        raise ValueError(
            "jit_cache was built for a different walk setup (cfg, param, "
            "held value, ncfg, evolve_backend, PRNG key, or mesh differ); "
            "use a fresh cache.")
    if "step" not in cache:
        if ncfg.fd_mode in ("frozen", "frozen-fwd"):
            # fused frozen-outcome FD corrector (host loop, replay map);
            # evolve_backend is implicit there.  frozen-fwd — the staged
            # solver's default stencil — routes to the same corrector:
            # the bordered system always differences its central stencil.
            cache["step"] = make_arclength_step_frozen(
                cfg, key, fixed, param, ncfg, mesh=mesh,
                mesh_axis=mesh_axis)
        else:
            cache["step"] = make_arclength_step_jit(cfg, key, fixed, param,
                                                    ncfg, evolve_backend)
    step_jit = cache["step"]

    y = jnp.concatenate([jnp.asarray(Z0, dt_),
                         jnp.asarray(free0, dt_)[None]])
    # tangent0 lets a resumed walk keep its direction (e.g. the secant of
    # the last two checkpointed points) instead of restarting along +param
    tangent = (jnp.asarray(tangent0, dt_) if tangent0 is not None
               else initial_tangent(y.shape[0] - 1, direction, dt_))
    out: list[ArcStep] = []
    cur_ds = float(ds)

    for i in range(n_steps):
        while True:
            res = step_jit(y, tangent, jnp.asarray(cur_ds, dt_))
            ok = bool(res.converged) and bool(
                jnp.all(jnp.isfinite(res.solution)))
            if ok and max_step_factor is not None:
                dist = float(jnp.linalg.norm(res.solution - y))
                ok = dist <= max_step_factor * cur_ds
                if not ok and reject_hook is not None:
                    reject_hook(np.asarray(res.solution))
            if ok or cur_ds <= min_ds:
                break
            cur_ds = max(min_ds, cur_ds * shrink)
        if not ok:
            break  # branch end / solver failure even at min step
        tangent = next_tangent(res.solution, y, tangent)
        y = res.solution
        step = ArcStep(y=y, tangent=tangent, converged=res.converged,
                       iterations=res.iterations,
                       residual_norm=res.residual_norm)
        out.append(step)
        if callback is not None:
            callback(i, step)
        if int(res.iterations) <= 3:
            cur_ds = min(max_ds, cur_ds * grow)
    return out
