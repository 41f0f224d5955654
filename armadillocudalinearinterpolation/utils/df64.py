"""Double-float ("df64") arithmetic: f64-grade values as pairs of f32.

The classical error-free-transformation technique — Dekker/Knuth two-float
arithmetic (``hi + lo`` with ``|lo| <= ulp(hi)/2``) — as a complete
arithmetic layer: add/mul/div and a range-reduced Taylor ``exp``, all built
from IEEE f32 add/mul at f32 element width.  The df64 schedule replay
(:mod:`..model.replay`) runs on it.

Accuracy: ~2^-47 relative per operation (the pair carries 48 effective
mantissa bits), versus 2^-52 for true f64 — far below the event-driven
map's 1e-9 residual target and its ~1e-8 event-reordering discontinuity
floor.  Validated against numpy double in ``tests/test_df64.py`` on the CPU
and by ``chip_smoke.py`` phase 1 on the GPU, which also guards against the
compiler contracting ``a*b + c`` into an FMA inside the Dekker split (that
would break :func:`two_prod`'s error term).

All functions are elementwise over arbitrary shapes.  A ``DF`` is a
NamedTuple pytree, so it threads through ``lax.scan`` carries, ``vmap`` and
``jax.jvp`` untouched.  No function here branches on values: everything is
``where``-masked f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

_F32 = jnp.float32
# Dekker split constant for binary32: 2^ceil(24/2) + 1.
_SPLIT = 4097.0


class DF(NamedTuple):
    """A double-float value ``hi + lo`` (both f32, |lo| <= ulp(hi)/2)."""

    hi: jax.Array
    lo: jax.Array


Like = Union[DF, jax.Array, float]


# ---------------------------------------------------------------- primitives

def two_sum(a, b):
    """Knuth's error-free sum: ``a + b = s + err`` exactly (6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Error-free sum assuming ``|a| >= |b|`` (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Dekker split: ``a = hi + lo`` with both halves 12-bit-exact."""
    c = jnp.float32(_SPLIT) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's error-free product: ``a * b = p + err`` exactly.

    Uses the split algorithm rather than FMA (XLA exposes no fma primitive
    and must not be allowed to synthesise one here — the error term would
    collapse to zero; the df64 test suite checks this on every backend).
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ------------------------------------------------------------- construction

def df(hi, lo=None) -> DF:
    """Promote an f32 array (or hi/lo pair) to a :class:`DF`.

    An f64 array with no explicit ``lo`` routes through :func:`from_f64`
    (exact split) — a plain f32 cast would silently drop the low 29
    mantissa bits, degrading every downstream op to single precision,
    which is exactly what a caller handing df64 an f64 array is trying
    to avoid (round-3 review finding; ``model/replay.py`` used to carry
    its own ``to_df`` wrapper for this).
    """
    if lo is None and getattr(hi, "dtype", None) == jnp.float64:
        return from_f64(hi)
    hi = jnp.asarray(hi, _F32)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return DF(hi, jnp.asarray(lo, _F32))


def df_const(x: float, shape=()) -> DF:
    """A compile-time scalar constant split exactly into hi/lo parts.

    The hi part is wrapped in ``lax.optimization_barrier``: XLA's algebraic
    simplifier reassociates add/sub chains when one operand is a literal
    (measured: ``add(df_const(1.0), r)`` collapses its error term under jit,
    degrading the pair to plain f32 — the barrier makes the literal opaque
    so every error-free transformation survives compilation).  Tracer-only
    chains are not rewritten (verified in ``tests/test_df64.py``).
    """
    import numpy as np
    hi = float(np.float32(x))
    lo = float(np.float32(x - hi))
    return DF(jax.lax.optimization_barrier(jnp.full(shape, hi, _F32)),
              jnp.full(shape, lo, _F32))


def from_f64(x: jax.Array) -> DF:
    """Split an f64 array into a df64 pair (requires x64 enabled)."""
    hi = x.astype(_F32)
    return DF(hi, (x - hi.astype(x.dtype)).astype(_F32))


def to_f64(a: DF) -> jax.Array:
    """Recombine into f64 (requires x64 enabled)."""
    return a.hi.astype(jnp.float64) + a.lo.astype(jnp.float64)


def to_f32(a: DF) -> jax.Array:
    """Round to nearest f32 (hi absorbs lo by construction)."""
    return a.hi + a.lo


def _as_df(x: Like) -> DF:
    if isinstance(x, DF):
        return x
    if isinstance(x, (int, float)):
        return df_const(float(x))
    return df(x)


# --------------------------------------------------------------- arithmetic

def add(a: Like, b: Like) -> DF:
    """Accurate (IEEE-style) df64 add — stays precise under cancellation."""
    a, b = _as_df(a), _as_df(b)
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    s, e = quick_two_sum(s, e + t)
    return DF(*quick_two_sum(s, e + f))


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: Like, b: Like) -> DF:
    return add(_as_df(a), neg(_as_df(b)))


def mul(a: Like, b: Like) -> DF:
    a, b = _as_df(a), _as_df(b)
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DF(*quick_two_sum(p, e))


def mul_f32(a: DF, b) -> DF:
    """Multiply by a plain f32 value (cheaper than full :func:`mul`)."""
    p, e = two_prod(a.hi, b)
    e = e + a.lo * b
    return DF(*quick_two_sum(p, e))


def div(a: Like, b: Like) -> DF:
    """Long division: two quotient terms + residual correction (~1 ulp)."""
    a, b = _as_df(a), _as_df(b)
    q1 = a.hi / b.hi
    r = add(a, neg(mul_f32(b, q1)))
    q2 = r.hi / b.hi
    r = add(r, neg(mul_f32(b, q2)))
    q3 = r.hi / b.hi
    s, e = quick_two_sum(q1, q2)
    return DF(*quick_two_sum(s, e + q3))


def recip(b: Like) -> DF:
    return div(df_const(1.0), b)


def scale_pow2(a: DF, m) -> DF:
    """Multiply by an exact power of two ``2^m`` (error-free)."""
    m = m.astype(jnp.int32) if hasattr(m, "astype") else jnp.int32(m)
    return DF(jnp.ldexp(a.hi, m), jnp.ldexp(a.lo, m))


# -------------------------------------------------------------- comparisons

def less(a: DF, b: DF):
    """Exact ``a < b`` on normalised pairs (sign(hi+lo) = sign(hi) unless
    hi ties)."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def greater(a: DF, b: DF):
    return less(b, a)


def where(pred, a: DF, b: DF) -> DF:
    return DF(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


# ------------------------------------------------------------------- exp

_LN2 = 0.6931471805599453094172321214581766
# 1/k! for the Taylor tail, k = 2..13 (term 13 contributes ~0.3466^13/13!
# ~ 2.0e-16 relative — below the 2^-47 pair precision).
_INV_FACT = [1.0 / math.factorial(k) for k in range(2, 14)]


def exp(a: Like) -> DF:
    """df64 exponential: range reduction to ``|r| <= ln2/2`` + Taylor.

    ``a = m ln2 + r``; ``exp(r)`` by a 13-term Horner evaluation in df64
    arithmetic; scale by the exact ``2^m``.  Arguments beyond the f32
    exponent range flush to 0 / inf exactly as f32 does (the event-driven
    map only ever exponentiates decays, so the underflow side is the one
    that occurs — and a true result of 1e-46 is zero at every scale the
    map compares against).
    """
    a = _as_df(a)
    m = jnp.round(a.hi * jnp.float32(1.0 / _LN2))
    ln2 = df_const(_LN2)
    r = add(a, neg(mul_f32(ln2, m)))     # |r| <= ln2/2 + tiny

    # Horner: p = 1/13! ; p = p*r + 1/12! ; ... ; p = p*r + 1/2!
    p = df_const(_INV_FACT[-1])
    for c in reversed(_INV_FACT[:-1]):
        p = add(mul(p, r), df_const(c))
    # exp(r) = 1 + r + r^2 * p
    p = add(add(df_const(1.0), r), mul(mul(r, r), p))
    return scale_pow2(p, m)


def exp_fast(a: Like) -> DF:
    """df64 exp with a plain-f32 Horner tail — ~1.6x cheaper than :func:`exp`.

    After range reduction ``|r| <= ln2/2``, the Taylor terms ``k >= 8``
    contribute at most ``0.347^8/8! ~ 5e-9`` *relative* to the result, so
    they only need ~1e-7 accuracy themselves: the tail ``k = 8..13`` runs as
    a plain f32 Horner (6 mul+add instead of 6 df64 pairs at ~47 flops
    each), and the df64 Horner picks up at ``k = 7``.  Worst-case extra
    error vs :func:`exp` is ~7e-16 relative (tail value ~2.5e-5 with f32
    rounding ~2.5e-12, scaled by ``r^6 * r^2``) — below the pair's own
    2^-47.  Validated against numpy double in ``tests/test_df64.py``.

    Use where the exponential sits inside a longer df64 computation (the
    replay's per-event decays); keep :func:`exp` for one-shot table builds
    where the extra margin is free.
    """
    a = _as_df(a)
    m = jnp.round(a.hi * jnp.float32(1.0 / _LN2))
    ln2 = df_const(_LN2)
    r = add(a, neg(mul_f32(ln2, m)))     # |r| <= ln2/2 + tiny

    # f32 tail: sum_{k=8..13} r^(k-8)/k!  (Horner on the hi word only)
    rh = r.hi
    p32 = jnp.asarray(_INV_FACT[-1], _F32)
    for c in reversed(_INV_FACT[6:-1]):      # 1/12! .. 1/8!
        p32 = p32 * rh + jnp.asarray(c, _F32)
    # df64 Horner k = 7..2, seeded by the f32 tail
    p = df(p32)
    for c in reversed(_INV_FACT[:6]):        # 1/7! .. 1/2!
        p = add(mul(p, r), df_const(c))
    p = add(add(df_const(1.0), r), mul(mul(r, r), p))
    return scale_pow2(p, m)


# Largest |a| for which exp_small keeps full pair precision (see docstring).
SMALL_EXP_BOUND = 0.08


def exp_small(a: Like) -> DF:
    """df64 exp for ``|a| <= SMALL_EXP_BOUND`` — ~4x cheaper than exp_fast.

    No range reduction (the argument is already far inside ``ln2/2``), a
    plain-f32 Horner tail for ``k = 5..9`` and a df64 Horner only for
    ``k = 2..4``.  Error budget at the bound ``|a| = 0.08``:

      * truncation past k = 9: ``0.08^10/10! ~ 3e-18`` relative — nil;
      * f32 tail rounding: the k >= 5 terms contribute at most
        ``0.08^5/5! ~ 2.7e-8`` of the result, so their ~1e-7 relative f32
        error lands at ~2.7e-15 — at the pair's own 2^-47;
      * the k = 4 term (~1.7e-6 of the result) must be df64: in f32 it
        would leak ~1.7e-13, which is why the tail starts at 5.

    Measured (CPU, (64, 4096) f32): 20 ns/elt vs exp_fast's 87 — the
    difference between a range-reduced 6-step df64 Horner and a 3-step one.
    Callers must guarantee the bound; use :func:`exp_fast` otherwise (the
    replay's per-event decay selects between the two with a ``lax.cond``
    on a measured argument bound, ``model/replay.py``).
    """
    a = _as_df(a)
    rh = a.hi
    p32 = jnp.asarray(_INV_FACT[7], _F32)        # 1/9!
    for c in reversed(_INV_FACT[3:7]):           # 1/8! .. 1/5!
        p32 = p32 * rh + jnp.asarray(c, _F32)
    p = df(p32)
    for c in reversed(_INV_FACT[:3]):            # 1/4! .. 1/2!
        p = add(mul(p, a), df_const(c))
    return add(add(df_const(1.0), a), mul(mul(a, a), p))


def exp_neg_prod(b: DF, t: DF) -> DF:
    """``exp(-b * t)`` — the map's workhorse form (synaptic decay)."""
    return exp(neg(mul(b, t)))
