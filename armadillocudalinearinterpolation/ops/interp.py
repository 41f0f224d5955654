"""Batched linear interpolation ops (XLA reference implementations).

The reference's "linear interpolation" is the restriction step
(``EventDrivenMap.cu:769-785``): a 1-D lerp of spike-crossing
positions at the time horizon.  The benchmark suite (BASELINE.json configs
1-2) additionally measures standalone batched 1-D lerp and 2-D bilinear
lookup-table ops, so they are first-class here.  They are plain ``jnp``
gathers and blends, compiled by XLA.

All functions are shape-polymorphic over leading query batch dims and safe
under ``jit``/``vmap``/``grad``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lerp(x0, x1, t):
    """Affine blend ``x0 + t*(x1-x0)`` — the primitive behind every op here."""
    return x0 + t * (x1 - x0)


def interp1d(xq: jax.Array, xp: jax.Array, fp: jax.Array) -> jax.Array:
    """Piecewise-linear interpolation at query points ``xq``.

    Semantics match ``arma::interp1`` / ``numpy.interp`` for strictly
    increasing nodes ``xp``: queries are clamped to the table range
    (constant extrapolation).

    Args:
      xq: queries, any shape ``(...,)``.
      xp: nodes, shape ``(n,)`` strictly increasing.
      fp: values at nodes, shape ``(n,)``.
    """
    n = xp.shape[0]
    # index of the right node of the bracketing interval, in [1, n-1]
    hi = jnp.clip(jnp.searchsorted(xp, xq, side="right"), 1, n - 1)
    lo = hi - 1
    x0, x1 = xp[lo], xp[hi]
    t = (jnp.clip(xq, xp[0], xp[-1]) - x0) / (x1 - x0)
    return lerp(fp[lo], fp[hi], t)


def lerp_uniform(xq: jax.Array, fp: jax.Array, x0: float, dx: float) -> jax.Array:
    """1-D lerp on a *uniform* grid ``x_i = x0 + i*dx`` (clamped).

    The uniform fast path avoids the ``searchsorted`` bisection: cell index is
    one fused multiply.  This is the op the restrict stage and the benchmark
    config-1 use.
    """
    n = fp.shape[0]
    u = (xq - x0) / dx
    i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, n - 2)
    t = jnp.clip(u - i0.astype(u.dtype), 0.0, 1.0)
    return lerp(fp[i0], fp[i0 + 1], t)


def bilinear(pts: jax.Array, grid: jax.Array) -> jax.Array:
    """Batched 2-D bilinear interpolation in *index* coordinates.

    Args:
      pts: ``(..., 2)`` query points ``(row, col)`` in [0, H-1] x [0, W-1]
        (clamped — constant extrapolation at the border).
      grid: ``(H, W)`` lookup table.

    Returns:
      ``(...,)`` interpolated values: the standard 4-corner weighted blend.
    """
    h, w = grid.shape
    r = jnp.clip(pts[..., 0], 0.0, h - 1.0)
    c = jnp.clip(pts[..., 1], 0.0, w - 1.0)
    r0 = jnp.clip(jnp.floor(r).astype(jnp.int32), 0, h - 2)
    c0 = jnp.clip(jnp.floor(c).astype(jnp.int32), 0, w - 2)
    tr = r - r0.astype(r.dtype)
    tc = c - c0.astype(c.dtype)
    g00 = grid[r0, c0]
    g01 = grid[r0, c0 + 1]
    g10 = grid[r0 + 1, c0]
    g11 = grid[r0 + 1, c0 + 1]
    top = lerp(g00, g01, tc)
    bot = lerp(g10, g11, tc)
    return lerp(top, bot, tr)


def bilinear_batched(pts: jax.Array, grids: jax.Array) -> jax.Array:
    """``vmap`` of :func:`bilinear` over a leading batch of grids.

    Args:
      pts: ``(B, Q, 2)`` queries per grid.
      grids: ``(B, H, W)`` stacked lookup tables (benchmark config 2:
        B=64, H=W=256, Q such that B*Q = 1M).
    """
    return jax.vmap(bilinear)(pts, grids)
