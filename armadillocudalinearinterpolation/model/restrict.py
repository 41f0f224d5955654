"""Restrict: linear interpolation of spike crossings at the time horizon.

Reference: ``RestrictKernel`` (``EventDrivenMap.cu:769-785``)
— the "linear interpolation" of the repo title — plus the accept-counting and
masked Monte-Carlo averaging kernels (``:787-824``).

The reference's reduction pair has a catalogued bug: ``CountRealisationsKernel``
overwrites ``accept[0]`` with the total count before the averaging kernel
re-reads per-realisation flags, clobbering realisation 0's flag
(``EventDrivenMap.cu:801,817``).  Here count and mask are separate values, as
SURVEY.md §7 prescribes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .evolve import EvolveResult


def restrict_positions(cfg: ModelConfig, res: EvolveResult) -> jax.Array:
    """Interpolated crossing position ``x(T)`` per (realisation, spike).

    Converts event indices to ring positions ``x = -L + dx * ind`` and lerps
    between the last pre-``T`` and first post-``T`` events
    (``EventDrivenMap.cu:779-783``):

        x(T) = x0 + (T - t0) * (x1 - x0) / (t1 - t0)

    Args:
      res: batched :class:`EvolveResult` with leading realisation axis.

    Returns:
      ``(n_real, n_spikes)`` interpolated positions.
    """
    dt_ = res.last_time.dtype
    L = jnp.asarray(cfg.half_width, dt_)
    dx = jnp.asarray(cfg.dx, dt_)
    x0 = -L + dx * res.last_ind.astype(dt_)
    x1 = -L + dx * res.crossed_ind.astype(dt_)
    t0 = res.last_time
    t1 = res.crossed_time
    T = jnp.asarray(cfg.t_horizon, dt_)
    return x0 + (T - t0) * (x1 - x0) / (t1 - t0)


def masked_ensemble_mean(positions: jax.Array, accept: jax.Array
                         ) -> tuple[jax.Array, jax.Array]:
    """Monte-Carlo mean over accepted realisations.

    Replaces ``CountRealisationsKernel`` + ``realisationReductionKernelBlocks``
    (``EventDrivenMap.cu:787-824``).  Division by a zero accept-count yields
    NaN, matching the reference's ``average / accept[0]`` semantics (a solve
    at unphysical parameters fails loudly rather than silently).

    Args:
      positions: ``(n_real, n_spikes)`` restricted positions.
      accept: ``(n_real,)`` bool accept flags.

    Returns:
      ``(mean, count)``: ``(n_spikes,)`` masked mean and scalar accept count.
    """
    dt_ = positions.dtype
    mask = accept.astype(dt_)[:, None]
    count = jnp.sum(accept.astype(dt_))
    return jnp.sum(positions * mask, axis=0) / count, count
