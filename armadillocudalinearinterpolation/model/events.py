"""Event-time root finder: next threshold crossing of the LIF trajectory.

Reference: ``fun`` / ``dfun`` / ``eventTime``
(``EventDrivenMap.cu:544-573``).  Between network events the
membrane evolves as

    v(t) = v0 e^{-t} + I (1 - e^{-t}) + s0 (e^{-beta t} - e^{-t}) / (1 - beta)

with the synaptic field decaying as ``s(t) = s0 e^{-beta t}``.  ``event_time``
solves ``v(t) = vth`` by Newton iteration from ``t = 0``, preceded by a
closed-form fire/no-fire decision; non-firing neurons return the sentinel
``|t| + 100`` which pushes them out of the subsequent min-reduction.

All functions are elementwise over arbitrary shapes (the per-thread scalar
code becomes vectorised array math) and masked instead of branching, so a
whole realisation's neurons share one bounded Newton loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import ModelConfig


def membrane_fun(t, v0, s0, beta, cfg: ModelConfig):
    """Residual ``v(t) - vth`` (``EventDrivenMap.cu:544-547``)."""
    emt = jnp.exp(-t)
    return (v0 * emt + cfg.drive * (1.0 - emt)
            + s0 * emt / (1.0 - beta) * (jnp.exp((1.0 - beta) * t) - 1.0)
            - cfg.vth)


def membrane_dfun(t, v0, s0, beta, cfg: ModelConfig):
    """Time derivative of :func:`membrane_fun` (``EventDrivenMap.cu:549-552``)."""
    emt = jnp.exp(-t)
    embt = jnp.exp(-t * (beta - 1.0))
    return (cfg.drive * emt - v0 * emt + s0 * emt * embt
            + (s0 * emt * (embt - 1.0)) / (beta - 1.0))


def fire_decision(v0, s0, beta, cfg: ModelConfig):
    """Closed-form test whether the trajectory can reach threshold.

    Transcribes the ``decision`` predicate at ``EventDrivenMap.cu:559``.  For
    ``s0 < 0`` the fractional power is NaN and the comparison is False —
    identical no-fire semantics to the CUDA float path.
    """
    q = jnp.power(s0 / (cfg.vth - cfg.drive), 1.0 / beta)
    rhs = (cfg.vth * q + cfg.drive * (1.0 - q)
           - (cfg.vth - cfg.drive) / (beta - 1.0)
           * (s0 / (cfg.vth - cfg.drive) - q))
    return v0 > rhs


@functools.partial(jax.custom_jvp, nondiff_argnums=(3,))
def event_time(v0, s0, beta, cfg: ModelConfig):
    """Next firing time per neuron, with no-fire sentinel.

    Masked bounded Newton replacing the data-dependent ``while`` at
    ``EventDrivenMap.cu:561-569``: all lanes iterate together under an
    activity mask until every lane has ``|f| <= tol`` or ``counter_max`` is
    reached.  Matches the reference contract exactly:

      * the initial residual is multiplied by ``decision`` so non-firers never
        iterate (stay at ``t = 0``);
      * firers iterate plain Newton (no damping/clamping);
      * the return is ``|t| + 100 * (1 - decision)`` (``:571``).
    """
    dt_ = jnp.result_type(v0, s0)
    decision = fire_decision(v0, s0, beta, cfg)
    t0 = jnp.zeros_like(v0)
    f0 = membrane_fun(t0, v0, s0, beta, cfg) * decision.astype(dt_)

    tol = jnp.asarray(cfg.root_tol, dt_)

    def cond(carry):
        t, f, k = carry
        return jnp.logical_and(jnp.any(jnp.abs(f) > tol), k < cfg.counter_max)

    def body(carry):
        t, f, k = carry
        active = jnp.abs(f) > tol
        df = membrane_dfun(t, v0, s0, beta, cfg)
        t_new = t - f / df
        t = jnp.where(active, t_new, t)
        f = jnp.where(active, membrane_fun(t, v0, s0, beta, cfg), f)
        return t, f, k + 1

    t, _, _ = jax.lax.while_loop(cond, body, (t0, f0, jnp.int32(0)))
    return jnp.abs(t) + 100.0 * (1.0 - decision.astype(dt_))


@event_time.defjvp
def _event_time_jvp(cfg: ModelConfig, primals, tangents):
    """Exact tangent of the event time via the implicit function theorem.

    The root ``t*`` of ``f(t*, v0, s0, beta) = 0`` satisfies

        dt*/dθ = -(∂f/∂θ) / (∂f/∂t)   at t = t*,

    so the tangent never differentiates *through* the Newton iteration — it is
    exact at the converged root (to ``O(root_tol)``), independent of the inner
    iteration count, and removes the finite-difference Jacobian's dominant
    noise source (VERDICT.md round 1, next-round item #1a).  The ``beta``
    partial makes ``∂F/∂beta`` available for pseudo-arclength continuation.

    Non-firing lanes return the constant sentinel ``100`` — zero tangent
    (the fire/no-fire ``decision`` is a discrete branch; within a smooth piece
    its derivative is zero, matching the map's piecewise structure).
    """
    v0, s0, beta = primals
    dv0, ds0, dbeta = tangents
    tau = event_time(v0, s0, beta, cfg)
    dt_ = jnp.result_type(v0, s0)
    decision = fire_decision(v0, s0, beta, cfg)
    # Recover the signed root for firers (the primal returns |t|; Newton's
    # root is the first up-crossing, t >= 0 in exact arithmetic, so |t| = t
    # on the smooth branch — use tau directly, masked to firers).
    t = jnp.where(decision, tau, jnp.zeros_like(tau))

    u = 1.0 - beta
    emt = jnp.exp(-t)
    ebt = jnp.exp(u * t)
    g = (ebt - 1.0) / u
    f_t = (cfg.drive * emt - v0 * emt + s0 * emt * ebt
           + (s0 * emt * (ebt - 1.0)) / (beta - 1.0))
    f_v = emt
    f_s = emt * g
    # d/dbeta [(e^{ut}-1)/u] with u = 1-beta:  ((e^{ut}-1) - t u e^{ut}) / u^2
    f_b = s0 * emt * ((ebt - 1.0) - t * u * ebt) / (u * u)

    dtan = -(f_v * dv0 + f_s * ds0 + f_b * dbeta) / f_t
    out_tan = jnp.where(decision, dtan, jnp.zeros_like(dtan)).astype(dt_)
    return tau, out_tan
