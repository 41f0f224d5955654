"""Lift: closed-form traveling-wave initial condition ``(v, s)``.

Reference: ``LiftKernel`` (``EventDrivenMap.cu:505-542``)
evaluates the analytic traveling-wave ansatz for membrane voltage ``v`` and
synaptic field ``s`` at every grid point, given wave speed ``c = U[0]`` and
spike time-offsets ``U[1..n_spikes]``.  The reference's branchless
``(cond)*expr`` idiom becomes ``jnp.where``; the ``#pragma unroll`` over
spikes becomes a static Python loop unrolled at trace time.

Axis convention: the reference's lift samples a *mirrored* coordinate
``x_i = L - dx*i`` while every other stage uses ``x_i = -L + dx*i``
(``EventDrivenMap.cu:513`` vs ``:117,781``).  We keep the same per-index
values (so every downstream index-based stage agrees with the reference) by
evaluating the closed forms at ``lift_x = -grid``.

The lift is deterministic and identical across realisations: the reference
evaluates it with the *mean* rate ``beta = par[0]`` (``EventDrivenMap.cu:516``),
not the per-realisation heterogeneous draw — heterogeneity enters only in
evolve.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig, MapParams


def _lift_voltage_term(x, c, u, beta, a, b):
    """One (a, b) exponential-pair contribution to the voltage profile.

    Transcribes the per-spike summand of ``LiftKernel``
    (``EventDrivenMap.cu:522-528``): the a1/b1 and a2/b2 pieces have
    identical structure with opposite sign, so they share this helper.
    Returns the pair ``(pos_branch, neg_branch)`` selected on ``x - c*u > 0``.
    """
    cb = c * b
    # x > c*u branch (ahead of the spike) — EventDrivenMap.cu:522-525
    boundary = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * jnp.exp(
        u * (1.0 + cb)) * jnp.exp(-b * c * u)
    homog = (a * beta * c / (1.0 - beta)) * jnp.exp(beta * u) * (
        1.0 / (beta + cb) + 1.0 / (cb - beta)) * (
            jnp.exp((x / c) * (1.0 - beta)) - jnp.exp(u * (1.0 - beta)))
    partic = (a * beta * c / ((cb - beta) * (1.0 - cb))) * jnp.exp(
        b * c * u) * (jnp.exp(x * (1.0 - cb) / c) - jnp.exp(c * u * (1.0 - cb) / c))
    pos = boundary + homog - partic
    # x <= c*u branch (behind the spike) — EventDrivenMap.cu:527-528
    neg = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * jnp.exp(
        x * (1.0 + cb) / c) * jnp.exp(-b * c * u)
    return pos, neg


def _lift_synapse_term(x, c, u, beta, a, b):
    """One (a, b) contribution to the synaptic profile (EventDrivenMap.cu:532-534)."""
    cb = c * b
    ahead = beta * a * (c / (beta + cb)) * jnp.exp(b * (x - c * u))
    behind = ((2.0 * a / b) * (beta / (1.0 - (beta * beta) / (cb * cb)))
              * jnp.exp(-(beta / c) * (x - c * u))
              - beta * a * (c / (cb - beta)) * jnp.exp(b * (c * u - x)))
    return ahead, behind


def lift(cfg: ModelConfig, params: MapParams, U: jax.Array
         ) -> Tuple[jax.Array, jax.Array]:
    """Closed-form lift of map state ``U = (c, u_1..u_M)`` to ``(v, s)``.

    Args:
      cfg: static model config.
      params: dynamic parameters (``beta`` mean rate).
      U: ``(n_spikes + 1,)`` gauge-fixed state: speed then spike offsets.

    Returns:
      ``(v, s)`` arrays of shape ``(n_neurons,)`` — the per-neuron membrane
      voltage and synaptic field at t=0 (``EventDrivenMap.cu:537-539``).
    """
    dt_ = cfg.jdtype
    i = jnp.arange(cfg.n_neurons, dtype=dt_)
    # Mirrored lift coordinate (see module docstring): x_i = L - dx*i.
    x = jnp.asarray(cfg.half_width, dt_) - jnp.asarray(cfg.dx, dt_) * i
    c = U[0].astype(dt_)
    beta = params.beta.astype(dt_)

    v_acc = jnp.zeros_like(x)
    s_acc = jnp.zeros_like(x)
    for m in range(1, cfg.n_spikes + 1):  # unrolled at trace time
        u = U[m].astype(dt_)
        ahead = (x - c * u) > 0.0

        p1, n1 = _lift_voltage_term(x, c, u, beta, cfg.a1, cfg.b1)
        p2, n2 = _lift_voltage_term(x, c, u, beta, cfg.a2, cfg.b2)
        dummy_v = jnp.where(ahead, p1 - p2, n1 - n2) * jnp.exp(-x / c)
        # Reset contribution of the spike itself (EventDrivenMap.cu:530).
        v_acc = v_acc + dummy_v - jnp.where(ahead, jnp.exp(-(x - c * u) / c), 0.0)

        s1a, s1b = _lift_synapse_term(x, c, u, beta, cfg.a1, cfg.b1)
        s2a, s2b = _lift_synapse_term(x, c, u, beta, cfg.a2, cfg.b2)
        behind_spike = (c * u - x) > 0.0
        s_acc = s_acc + jnp.where(behind_spike, s1a - s2a, s1b - s2b)

    v = jnp.asarray(cfg.drive, dt_) + v_acc
    # Clamp super-threshold sites to the reset value (EventDrivenMap.cu:538).
    v = v * (v < jnp.asarray(cfg.vth, dt_)).astype(dt_)
    return v, s_acc


def initial_spike_indices(cfg: ModelConfig, Z: jax.Array) -> jax.Array:
    """Grid index just left of each spike's initial position ``-c * Z[m]``.

    Vectorised replacement for the host-side downward scan at
    ``EventDrivenMap.cu:361-376``: spike 0 pins to the grid midpoint
    (``x = 0``); spike ``m >= 1`` takes the largest ``i`` with
    ``-L + dx*i < -Z[0] * Z[m]`` (strict, matching ``:367``).

    Returns ``(n_spikes,)`` int32.
    """
    c = Z[0]
    pos = -c * Z[1:cfg.n_spikes]  # spike positions for m = 1..M-1
    # largest i with -L + dx*i < p  <=>  i = ceil((p + L)/dx) - 1
    raw = jnp.ceil((pos + cfg.half_width) / cfg.dx).astype(jnp.int32) - 1
    idx = jnp.clip(raw, 0, cfg.n_neurons - 1)
    # The reference scans downward FROM the previous spike's index, so
    # ind[m] <= ind[m-1] always holds; reproduce that monotone constraint
    # (it only binds for unordered Z, where the plain closed form would
    # exceed the previous index).
    inds = [jnp.asarray(cfg.n_neurons // 2, jnp.int32)]
    for m in range(cfg.n_spikes - 1):
        inds.append(jnp.minimum(idx[m], inds[-1]))
    return jnp.stack(inds)
