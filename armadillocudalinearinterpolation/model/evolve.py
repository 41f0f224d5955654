"""Evolve: the event-driven network loop (the hot core of the map).

Reference: ``EvolveKernel`` (``EventDrivenMap.cu:575-674``).
One CUDA block = one Monte-Carlo realisation, one thread = one neuron; here a
realisation is a pure function over ``(n_neurons,)`` arrays inside a
``lax.while_loop``, and the ensemble is a ``vmap`` axis (JAX automatically
masks finished realisations inside a batched while loop, which reproduces the
reference's independent per-block exit semantics in lockstep form).

Per event:
  1. every neuron proposes its next firing time (:func:`..model.events.event_time`);
  2. an argmin reduction picks the realisation-wide next event
     (replacing the warp/block min-with-index shuffle at ``:843-881``;
     ties resolve to the lowest neuron index, documented deviation from the
     reference's implementation-defined shuffle order);
  3. all states advance analytically by ``dt``; the firing neuron resets to
     ``vr`` and every neuron receives the ring-coupling kick
     ``beta * w[|i - j|]`` (``:612-617``);
  4. the event is classified to the nearest tracked spike trajectory and
     recorded as last-before-``T`` or first-after-``T`` (``:622-644``; we use
     a true nearest-trajectory argmin rather than the reference's sequential
     increment, which mis-classifies when trajectory 2 is nearest but 1 was
     not — catalogued in SURVEY.md §7);
  5. the loop ends when all trajectories have crossed ``T`` or the bail-out
     ``t > 2T`` fires (``:601``); a realisation is *accepted* only if all
     trajectories crossed (``:669-672``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .coupling import coupling_row
from .events import event_time


class EvolveResult(NamedTuple):
    """Per-realisation spike bookkeeping after evolution to (past) ``T``."""

    last_ind: jax.Array      # (n_spikes,) int32 — last firing site before T
    last_time: jax.Array     # (n_spikes,) — last firing time before T
    crossed_ind: jax.Array   # (n_spikes,) int32 — first firing site after T
    crossed_time: jax.Array  # (n_spikes,) — first firing time after T
    accept: jax.Array        # () bool — all trajectories crossed T
    n_events: jax.Array      # () int32 — diagnostic event count


def evolve(cfg: ModelConfig, w: jax.Array, v0: jax.Array, s0: jax.Array,
           beta: jax.Array, init_ind: jax.Array) -> EvolveResult:
    """Run one realisation's event loop from ``t=0`` until all spikes cross ``T``.

    Args:
      cfg: static model config.
      w: ``(n_neurons,)`` ring coupling table (:func:`..model.coupling.coupling_kernel`).
      v0, s0: ``(n_neurons,)`` lifted initial state.
      beta: ``(n_neurons,)`` per-neuron synaptic rates (heterogeneous draw).
      init_ind: ``(n_spikes,)`` int32 initial spike indices.
    """
    dt_ = v0.dtype
    M = cfg.n_spikes
    T = jnp.asarray(cfg.t_horizon, dt_)

    class Carry(NamedTuple):
        v: jax.Array
        s: jax.Array
        t: jax.Array
        last_ind: jax.Array
        last_time: jax.Array
        crossed_ind: jax.Array
        crossed_time: jax.Array
        crossed: jax.Array  # (M,) bool — per-trajectory crossed flag
        n_events: jax.Array

    init = Carry(
        v=v0, s=s0, t=jnp.zeros((), dt_),
        last_ind=init_ind.astype(jnp.int32),
        last_time=jnp.zeros((M,), dt_),
        crossed_ind=init_ind.astype(jnp.int32),
        crossed_time=jnp.full((M,), 2.0 * cfg.t_horizon, dt_),
        crossed=jnp.zeros((M,), bool),
        n_events=jnp.int32(0),
    )

    def cond(c: Carry):
        # while (noCrossed < full mask) && (t < 2T)   (EventDrivenMap.cu:601)
        return jnp.logical_and(~jnp.all(c.crossed), c.t < 2.0 * T)

    def body(c: Carry) -> Carry:
        times = event_time(c.v, c.s, beta, cfg)
        j = jnp.argmin(times).astype(jnp.int32)   # lowest index wins ties
        dt = times[j]

        # Analytic advance by dt; firing neuron resets (EventDrivenMap.cu:612-617).
        # The neuron-id iota is generated INSIDE the loop body rather than
        # closed over as a module-level ``jnp.arange`` constant (identical
        # semantics; a captured constant once made compiles pathological).
        emt = jnp.exp(-dt)
        v = c.v * emt + cfg.drive * (1.0 - emt) \
            + c.s * emt / (1.0 - beta) * (jnp.exp((1.0 - beta) * dt) - 1.0)
        neuron_ids = jax.lax.broadcasted_iota(jnp.int32, (cfg.n_neurons,), 0)
        v = v * (neuron_ids != j).astype(dt_)
        s = c.s * jnp.exp(-beta * dt) + beta * coupling_row(w, j)

        t = c.t + dt

        # Classify the event to the nearest tracked trajectory (:624-629).
        m = jnp.argmin(jnp.abs(j - c.last_ind)).astype(jnp.int32)
        fresh = ~c.crossed[m]
        after_T = t > T
        is_cross = fresh & after_T
        is_last = fresh & ~after_T
        onehot = (jax.lax.broadcasted_iota(jnp.int32, (M,), 0) == m)

        crossed_time = jnp.where(onehot & is_cross, t, c.crossed_time)
        crossed_ind = jnp.where(onehot & is_cross, j, c.crossed_ind)
        crossed = c.crossed | (onehot & is_cross)
        last_time = jnp.where(onehot & is_last, t, c.last_time)
        last_ind = jnp.where(onehot & is_last, j, c.last_ind)

        return Carry(v=v, s=s, t=t, last_ind=last_ind, last_time=last_time,
                     crossed_ind=crossed_ind, crossed_time=crossed_time,
                     crossed=crossed, n_events=c.n_events + 1)

    out = jax.lax.while_loop(cond, body, init)
    return EvolveResult(
        last_ind=out.last_ind, last_time=out.last_time,
        crossed_ind=out.crossed_ind, crossed_time=out.crossed_time,
        accept=jnp.all(out.crossed), n_events=out.n_events)


def evolve_ensemble(cfg: ModelConfig, w: jax.Array, v0: jax.Array,
                    s0: jax.Array, beta: jax.Array, init_ind: jax.Array
                    ) -> EvolveResult:
    """Ensemble evolve: ``vmap`` over the realisation axis.

    Replaces the ``<<<noReal, nThreads>>>`` grid launch at
    ``EventDrivenMap.cu:196``.  ``v0``/``s0`` are shared across realisations
    (the lift is deterministic); ``beta`` is ``(n_real, n_neurons)`` and
    ``init_ind`` is shared ``(n_spikes,)``.
    """
    return jax.vmap(
        lambda b: evolve(cfg, w, v0, s0, b, init_ind))(beta)
