"""Double-float arithmetic (utils/df64.py) against numpy double.

The critical regression here is the jit one: XLA's algebraic simplifier
reassociates add/sub chains when one operand is a literal, which silently
collapses error-free transformations to plain f32 (measured before the
``df_const`` optimization-barrier fix: ``add(df_const(1.0), r)`` lost its
low word under jit while matching numpy eagerly).  Every check therefore
runs through ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation.utils import df64 as D


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(7)
    x = rng.uniform(-20.0, 3.0, 20000)
    y = rng.uniform(-5.0, 5.0, 20000)
    y[np.abs(y) < 1e-3] = 1.0
    return x, y


def _relerr(got, ref):
    return np.max(np.abs((np.asarray(got) - ref)
                         / np.maximum(np.abs(ref), 1e-300)))


def test_roundtrip_f64(samples):
    x, _ = samples
    xd = D.from_f64(jnp.asarray(x))
    # hi/lo split of a double keeps ~48 bits
    assert _relerr(D.to_f64(xd), x) < 2e-14


def test_arithmetic_jit(samples):
    x, y = samples
    xd, yd = D.from_f64(jnp.asarray(x)), D.from_f64(jnp.asarray(y))
    f = jax.jit(lambda a, b: (D.to_f64(D.add(a, b)), D.to_f64(D.mul(a, b)),
                              D.to_f64(D.div(a, b)),
                              D.to_f64(D.sub(a, b))))
    s, p, q, d = f(xd, yd)
    assert np.max(np.abs(np.asarray(s) - (x + y))) < 1e-12
    assert _relerr(p, x * y) < 1e-13
    assert _relerr(q, x / y) < 1e-13
    assert np.max(np.abs(np.asarray(d) - (x - y))) < 1e-12


def test_exp_jit(samples):
    x, _ = samples
    xd = D.from_f64(jnp.asarray(x))
    e = jax.jit(lambda a: D.to_f64(D.exp(a)))(xd)
    assert _relerr(e, np.exp(x)) < 1e-12


def test_exp_fast_jit(samples):
    """exp_fast (f32 Horner tail) must keep full df64 grade — the tail
    terms it demotes contribute < 6e-9 relative, so its extra error vs
    exp is ~7e-16, invisible at the 1e-12 assertion."""
    x, _ = samples
    xd = D.from_f64(jnp.asarray(x))
    e = jax.jit(lambda a: D.to_f64(D.exp_fast(a)))(xd)
    assert _relerr(e, np.exp(x)) < 1e-12
    # the replay's operating range: decay exponents -beta*dt in [-3, 0]
    y = np.linspace(-3.0, 0.0, 4097)
    ey = jax.jit(lambda a: D.to_f64(D.exp_fast(D.from_f64(a))))(
        jnp.asarray(y))
    assert _relerr(np.asarray(ey), np.exp(y)) < 1e-13


def test_exp_small_jit():
    """exp_small must be full df64 grade over its whole contract range
    |a| <= SMALL_EXP_BOUND, including the endpoints (the replay's
    lax.cond selects it by a measured bound, so the edge is reachable),
    and must agree with exp_fast there — the two are interchangeable
    branches of the same computation."""
    y = np.linspace(-D.SMALL_EXP_BOUND, D.SMALL_EXP_BOUND, 40001)
    yd = D.from_f64(jnp.asarray(y))
    e_small = jax.jit(lambda a: D.to_f64(D.exp_small(a)))(yd)
    e_fast = jax.jit(lambda a: D.to_f64(D.exp_fast(a)))(yd)
    assert _relerr(e_small, np.exp(y)) < 1e-13
    assert np.max(np.abs(np.asarray(e_small) - np.asarray(e_fast))
                  / np.exp(y)) < 2e-14
    # exactness at zero: exp_small(0) == 1 bitwise (the sigma = 0 replay
    # relies on the delta factor being exactly neutral)
    z = D.df(jnp.zeros(3))
    out = jax.jit(lambda a: D.exp_small(a))(z)
    assert np.all(np.asarray(out.hi) == 1.0)
    assert np.all(np.asarray(out.lo) == 0.0)


def test_jit_constant_reassociation_guard():
    """add(const, x) must keep its error term under jit (the XLA literal-
    reassociation regression the df_const barrier exists for)."""
    r = D.from_f64(jnp.asarray([1.3e-3, -2.7e-4, 5e-9]))
    got = jax.jit(lambda a: D.to_f64(D.add(D.df_const(1.0), a)))(r)
    ref = 1.0 + np.asarray([1.3e-3, -2.7e-4, 5e-9])
    assert np.max(np.abs(np.asarray(got) - ref)) < 1e-14


def test_exact_comparison_on_pairs():
    a = D.DF(jnp.float32(1.0), jnp.float32(1e-9))
    b = D.DF(jnp.float32(1.0), jnp.float32(2e-9))
    assert bool(D.less(a, b)) and not bool(D.less(b, a))
    assert bool(D.greater(b, a))


def test_mul_f32_and_scale_pow2():
    x = np.asarray([0.1, -3.7, 12.0])
    xd = D.from_f64(jnp.asarray(x))
    got = jax.jit(lambda a: D.to_f64(D.mul_f32(a, jnp.float32(3.0))))(xd)
    assert _relerr(got, 3.0 * x) < 1e-13
    got2 = jax.jit(lambda a: D.to_f64(D.scale_pow2(a, jnp.int32(-4))))(xd)
    assert _relerr(got2, x / 16.0) < 1e-15


def test_exp_underflow_and_range():
    """Decay exponentials can underflow f32: exp must flush to 0 cleanly
    (the map compares against O(1) scales) and stay finite everywhere.
    Below ~1e-31 the pair's low word goes subnormal and precision degrades
    gracefully to single-word f32 — acceptable, since such magnitudes are
    zero at every scale the map compares against."""
    x = jnp.asarray([-200.0, -87.0, -80.0, -60.0, 0.0, 80.0])
    e = np.asarray(jax.jit(lambda a: D.to_f64(D.exp(D.from_f64(a))))(x))
    ref = np.exp(np.asarray(x))
    assert e[0] == 0.0
    assert np.all(np.isfinite(e))
    np.testing.assert_allclose(e[1:4], ref[1:4], rtol=1e-6)   # lo subnormal
    np.testing.assert_allclose(e[3:], ref[3:], rtol=1e-12)


def test_where_and_neg():
    a = D.from_f64(jnp.asarray([1.0, 2.0]))
    b = D.from_f64(jnp.asarray([3.0, 4.0]))
    w = D.where(jnp.asarray([True, False]), a, b)
    np.testing.assert_allclose(np.asarray(D.to_f64(w)), [1.0, 4.0])
    np.testing.assert_allclose(np.asarray(D.to_f64(D.neg(a))), [-1.0, -2.0])


def test_df_routes_f64_arrays_through_exact_split():
    """df() (and hence every Like-accepting op) must not silently truncate
    an f64 array to single precision: the low mantissa bits go to the lo
    word via from_f64 (round-3 review finding — ops like D.exp(f64_array)
    used to degrade to ~1e-8 relative with no warning)."""
    x = jnp.asarray([1.0 + 1e-12, -0.9, 3.141592653589793])
    d = D.df(x)
    # the pair carries ~48 mantissa bits (2^-48 relative), far beyond the
    # ~2^-24 a plain f32 truncation would leave
    np.testing.assert_allclose(np.asarray(D.to_f64(d)), np.asarray(x),
                               rtol=8e-15)
    assert float(jnp.max(jnp.abs(d.lo))) > 0.0   # lo word carries bits
    # the arithmetic entry points route through the same split
    e = np.asarray(D.to_f64(D.exp(x)))
    np.testing.assert_allclose(e, np.exp(np.asarray(x)), rtol=1e-13)
    # f32 arrays keep the plain promote (lo == 0)
    d32 = D.df(x.astype(jnp.float32))
    assert float(jnp.max(jnp.abs(d32.lo))) == 0.0
