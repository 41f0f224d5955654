"""Batched (array-level) evolve with windowed root-finds — the f64 fast path.

:mod:`.evolve` maps one realisation's event loop over the ensemble with
``vmap``; that is the cleanest formulation, but it rules out the windowed
root-find optimisation: under ``vmap`` both branches
of a ``lax.cond`` execute (the batching rule turns it into a ``select``), so
the full-evaluation fallback would be paid every event.  This module writes
the loop at the ``(n_real, n_neurons)`` array level instead — one
``while_loop`` for the whole ensemble, finished rows masked — so the
fallback is a genuine scalar ``lax.cond``.

Semantics match :func:`.evolve.evolve_ensemble` exactly (same event order,
same bookkeeping; the loop runs until every row finishes, frozen rows are
masked).  The window is certified per event by the same ODE-comparison lower
bound: between kicks ``v' <= -v + I + max(s, 0)``, so an
out-of-window lane cannot cross threshold before

    t_lb = log((I + s+ - v) / (I + s+ - vth))     (+inf if I + s+ <= vth)

and a windowed minimum below ``min(t_lb)`` is the global minimum.  Primary
use: the fully-f64 Newton stage (evaluating the event-time Newton on N/8
lanes instead of N cuts its transcendentals by ~8x where f64 hurts most).

Reference contract: ``EvolveKernel`` (``EventDrivenMap.cu:575-674``);
the reference pays all-threads event cost (``:605-609``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .evolve import EvolveResult
from .events import event_time


class _Carry(NamedTuple):
    v: jax.Array             # (R, N)
    s: jax.Array             # (R, N)
    t: jax.Array             # (R,)
    last_ind: jax.Array      # (R, M) int32
    last_time: jax.Array     # (R, M)
    crossed_ind: jax.Array   # (R, M) int32
    crossed_time: jax.Array  # (R, M)
    crossed: jax.Array       # (R, M) bool
    n_events: jax.Array      # (R,) int32
    sched: jax.Array         # (R, E) int32 firing-lane log ((R, 0) if off)


def evolve_ensemble_batched(cfg: ModelConfig, w: jax.Array, v0: jax.Array,
                            s0: jax.Array, beta: jax.Array,
                            init_ind: jax.Array, *,
                            record_schedule: int = 0):
    """Ensemble evolve as one batched while_loop (windowed when
    ``cfg.evolve_window > 0``).  Drop-in for :func:`.evolve.evolve_ensemble`.

    Args:
      record_schedule: when > 0, also log the firing-lane index of every
        event into a ``(n_real, record_schedule)`` int32 buffer and return
        ``(result, schedule)`` — the input to the df64 schedule replay
        (:mod:`.replay`), which recomputes exact event times for a *known*
        firing order.  A realisation overflowing the buffer keeps running
        (physics unchanged) but its log is truncated; the replay detects
        this via ``n_events >= record_schedule`` and rejects the row.
    """
    del w  # the kick is recomputed analytically (same formula as the table)
    dt_ = v0.dtype
    R = cfg.n_real
    N = cfg.n_neurons
    M = cfg.n_spikes
    T = jnp.asarray(cfg.t_horizon, dt_)
    drive = jnp.asarray(cfg.drive, dt_)
    vth = jnp.asarray(cfg.vth, dt_)
    dx = jnp.asarray(cfg.dx, dt_)
    W = int(cfg.evolve_window)
    use_window = 0 < W < N
    pad_b = min(64, W // 4) if use_window else 0
    lane = jnp.arange(N, dtype=jnp.int32)[None, :]                # (1, N)

    init = _Carry(
        v=jnp.broadcast_to(v0, (R, N)).astype(dt_),
        s=jnp.broadcast_to(s0, (R, N)).astype(dt_),
        t=jnp.zeros((R,), dt_),
        last_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        last_time=jnp.zeros((R, M), dt_),
        crossed_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        crossed_time=jnp.full((R, M), 2.0 * cfg.t_horizon, dt_),
        crossed=jnp.zeros((R, M), bool),
        n_events=jnp.zeros((R,), jnp.int32),
        sched=jnp.zeros((R, max(record_schedule, 0)), jnp.int32),
    )

    def live_rows(c: _Carry):
        return jnp.logical_and(~jnp.all(c.crossed, axis=1), c.t < 2.0 * T)

    def select_full(c: _Carry):
        times = event_time(c.v, c.s, beta, cfg)                   # (R, N)
        return jnp.min(times, axis=1), jnp.argmin(times, axis=1).astype(
            jnp.int32)                                            # ties: lowest

    def select_windowed(c: _Carry):
        start = jnp.mod(jnp.min(c.last_ind, axis=1) - pad_b, N)   # (R,)
        widx = jnp.mod(start[:, None]
                       + jnp.arange(W, dtype=jnp.int32)[None, :], N)
        vw = jnp.take_along_axis(c.v, widx, axis=1)
        sw = jnp.take_along_axis(c.s, widx, axis=1)
        bw = jnp.take_along_axis(beta, widx, axis=1)
        times_w = event_time(vw, sw, bw, cfg)
        dt_w = jnp.min(times_w, axis=1)
        j_w = jnp.take_along_axis(
            widx, jnp.argmin(times_w, axis=1)[:, None], axis=1)[:, 0]

        # out-of-window certificate (one log per lane).  The ODE-comparison
        # bound needs the synapse to decay between kicks (beta > 0); a
        # non-positive heterogeneous draw (possible in principle for huge
        # sigma) voids the bound, so such lanes report t_lb = 0 and force
        # the exact full-evaluation fallback.
        cap = drive + jnp.maximum(c.s, 0.0)
        denom = cap - vth
        lb = jnp.where(denom > 0.0,
                       jnp.log(jnp.maximum(cap - c.v, 1e-300)
                               / jnp.maximum(denom, 1e-300)),
                       jnp.asarray(jnp.inf, dt_))
        lb = jnp.where(beta > 0.0, lb, 0.0)
        rel = jnp.mod(lane - start[:, None], N)
        lb_out = jnp.min(jnp.where(rel < W, jnp.asarray(jnp.inf, dt_), lb),
                         axis=1)
        certified = jnp.all(jnp.logical_or(dt_w <= lb_out, ~live_rows(c)))
        return jax.lax.cond(certified,
                            lambda _: (dt_w, j_w.astype(jnp.int32)),
                            lambda _: select_full(c), 0)

    def cond(c: _Carry):
        return jnp.any(live_rows(c))

    def body(c: _Carry) -> _Carry:
        live = live_rows(c)                                       # (R,)
        if use_window:
            dt, j = select_windowed(c)
        else:
            dt, j = select_full(c)
        dtc = dt[:, None]
        emt = jnp.exp(-dtc)
        v_new = (c.v * emt + drive * (1.0 - emt)
                 + c.s * emt / (1.0 - beta)
                 * (jnp.exp((1.0 - beta) * dtc) - 1.0))
        v_new = jnp.where(lane == j[:, None], 0.0, v_new)
        d = jnp.abs(lane - j[:, None])
        dist = jnp.minimum(d, N - d).astype(dt_) * dx
        wrow = (cfg.a1 * jnp.exp(-cfg.b1 * dist)
                - cfg.a2 * jnp.exp(-cfg.b2 * dist)) * dx
        s_new = c.s * jnp.exp(-beta * dtc) + beta * wrow
        t_new = c.t + dt

        livec = live[:, None]
        v = jnp.where(livec, v_new, c.v)
        s = jnp.where(livec, s_new, c.s)
        t = jnp.where(live, t_new, c.t)

        # classification to the nearest tracked trajectory (:622-644)
        m = jnp.argmin(jnp.abs(j[:, None] - c.last_ind), axis=1)  # (R,)
        onehot = jax.lax.broadcasted_iota(jnp.int32, (R, M), 1) == m[:, None]
        fresh = ~jnp.take_along_axis(c.crossed, m[:, None], axis=1)[:, 0]
        after = t_new > T
        is_cross = (fresh & after & live)[:, None] & onehot
        is_last = (fresh & ~after & live)[:, None] & onehot

        jc = j[:, None]
        tc = t_new[:, None]
        sched = c.sched
        if record_schedule > 0:
            # frozen rows must not clobber their last logged event, so the
            # write is value-masked (the column index stalls at n_events)
            rows = jnp.arange(R)
            col = jnp.minimum(c.n_events, record_schedule - 1)
            sched = sched.at[rows, col].set(
                jnp.where(live, j, sched[rows, col]))
        return _Carry(
            v=v, s=s, t=t,
            last_ind=jnp.where(is_last, jc, c.last_ind),
            last_time=jnp.where(is_last, tc, c.last_time),
            crossed_ind=jnp.where(is_cross, jc, c.crossed_ind),
            crossed_time=jnp.where(is_cross, tc, c.crossed_time),
            crossed=c.crossed | is_cross,
            n_events=c.n_events + live.astype(jnp.int32),
            sched=sched)

    out = jax.lax.while_loop(cond, body, init)
    result = EvolveResult(
        last_ind=out.last_ind, last_time=out.last_time,
        crossed_ind=out.crossed_ind, crossed_time=out.crossed_time,
        accept=jnp.all(out.crossed, axis=1), n_events=out.n_events)
    if record_schedule > 0:
        return result, out.sched
    return result
