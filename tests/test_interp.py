"""Interp op tests: parity with numpy.interp (arma::interp1 semantics) and
bilinear blend identities (BASELINE.md configs 1-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation.ops import interp


def test_interp1d_matches_numpy_interp():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(-3, 3, 1000))
    xp[0], xp[-1] = -3.0, 3.0
    fp = np.sin(xp)
    xq = rng.uniform(-3.5, 3.5, 10000)  # includes out-of-range queries
    got = interp.interp1d(jnp.asarray(xq), jnp.asarray(xp), jnp.asarray(fp))
    want = np.interp(xq, xp, fp)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12)


def test_lerp_uniform_matches_interp1d():
    n = 1000
    x0, dx = -3.0, 6.0 / (n - 1)
    xp = x0 + dx * np.arange(n)
    fp = np.sin(xp)
    xq = np.random.default_rng(1).uniform(-3.5, 3.5, 5000)
    got = interp.lerp_uniform(jnp.asarray(xq), jnp.asarray(fp), x0, dx)
    want = np.interp(xq, xp, fp)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12)


def test_bilinear_exact_on_bilinear_function():
    # A function of the form a + b r + c q + d r q is reproduced exactly.
    h, w = 32, 48
    r, c = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = 2.0 + 0.5 * r - 0.25 * c + 0.125 * r * c
    pts = np.random.default_rng(2).uniform([0, 0], [h - 1, w - 1], (500, 2))
    got = interp.bilinear(jnp.asarray(pts), jnp.asarray(grid))
    want = 2.0 + 0.5 * pts[:, 0] - 0.25 * pts[:, 1] + 0.125 * pts[:, 0] * pts[:, 1]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_bilinear_clamps_at_border():
    grid = jnp.arange(12.0).reshape(3, 4)
    out = interp.bilinear(jnp.array([[-1.0, -5.0], [10.0, 10.0]]), grid)
    np.testing.assert_allclose(np.asarray(out), [0.0, 11.0])


def test_bilinear_batched_shapes_and_values():
    b, h, w, q = 3, 8, 8, 17
    rng = np.random.default_rng(3)
    grids = rng.normal(size=(b, h, w))
    pts = rng.uniform(0, 7, (b, q, 2))
    got = interp.bilinear_batched(jnp.asarray(pts), jnp.asarray(grids))
    assert got.shape == (b, q)
    for i in range(b):
        one = interp.bilinear(jnp.asarray(pts[i]), jnp.asarray(grids[i]))
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(one))


def test_interp_ops_are_jit_and_grad_safe():
    xp = jnp.linspace(-1, 1, 64)
    fp = jnp.sin(xp)
    g = jax.grad(lambda x: interp.interp1d(x, xp, fp))(jnp.asarray(0.3))
    # derivative of piecewise-linear interpolant ~ cos(0.3)
    assert abs(float(g) - np.cos(0.3)) < 1e-2


# --- the XLA ops as the only interpolation path: sizes, layouts, dtypes ---

@pytest.mark.parametrize("n", [1000, 4096, 65536])
def test_lerp_uniform_table_sizes(n):
    """Config-1 table sizes up to a table that no longer fits in cache."""
    xp = np.linspace(-3.0, 3.0, n)
    fp = np.sin(xp)
    xq = np.random.default_rng(n).uniform(-3.5, 3.5, 20000)
    got = interp.lerp_uniform(jnp.asarray(xq), jnp.asarray(fp), -3.0,
                              6.0 / (n - 1))
    np.testing.assert_allclose(np.asarray(got), np.interp(xq, xp, fp),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1000, 4096, 65536])
def test_interp1d_table_sizes(n):
    xp = np.sort(np.random.default_rng(n + 1).uniform(-3.0, 3.0, n))
    fp = np.cos(xp)
    xq = np.random.default_rng(n + 2).uniform(-3.5, 3.5, 20000)
    got = interp.interp1d(jnp.asarray(xq), jnp.asarray(xp), jnp.asarray(fp))
    np.testing.assert_allclose(np.asarray(got), np.interp(xq, xp, fp),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("cluster_width", [1e-1, 1e-3, 1e-6])
def test_interp1d_dense_cluster(cluster_width):
    """Non-uniform nodes with a dense cluster: the bisection must still
    find the bracketing cell where cells are tiny."""
    rng = np.random.default_rng(11)
    coarse = np.linspace(-3.0, 3.0, 200)
    cluster = 0.5 + cluster_width * np.sort(rng.uniform(0.0, 1.0, 800))
    xp = np.unique(np.concatenate([coarse, cluster]))
    fp = np.sin(3.0 * xp)
    xq = np.concatenate([rng.uniform(-3.2, 3.2, 5000),
                         0.5 + cluster_width * rng.uniform(0, 1, 5000)])
    got = interp.interp1d(jnp.asarray(xq), jnp.asarray(xp), jnp.asarray(fp))
    np.testing.assert_allclose(np.asarray(got), np.interp(xq, xp, fp),
                               rtol=0, atol=1e-12)


def _bilinear_host(grid, pts):
    g, p = np.asarray(grid, np.float64), np.asarray(pts, np.float64)
    h, w = g.shape
    r = np.clip(p[..., 0], 0, h - 1.0)
    c = np.clip(p[..., 1], 0, w - 1.0)
    r0 = np.clip(np.floor(r).astype(int), 0, h - 2)
    c0 = np.clip(np.floor(c).astype(int), 0, w - 2)
    tr, tc = r - r0, c - c0
    return ((1 - tr) * (1 - tc) * g[r0, c0] + (1 - tr) * tc * g[r0, c0 + 1]
            + tr * (1 - tc) * g[r0 + 1, c0] + tr * tc * g[r0 + 1, c0 + 1])


@pytest.mark.parametrize("shape", [(256, 256), (97, 131)])
def test_bilinear_f64_matches_host_double(shape):
    """The f64 leg of config 2 against a host float64 blend."""
    rng = np.random.default_rng(5)
    grid = rng.normal(size=shape)
    pts = rng.uniform([0, 0], [shape[0] - 1, shape[1] - 1], (4096, 2))
    got = interp.bilinear(jnp.asarray(pts), jnp.asarray(grid))
    np.testing.assert_allclose(np.asarray(got), _bilinear_host(grid, pts),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape", [(3, 5), (17, 250), (130, 7)])
def test_bilinear_batched_unaligned_shapes(shape):
    """Grid shapes that are neither square nor multiples of any tile."""
    rng = np.random.default_rng(sum(shape))
    b = 3
    grids = rng.normal(size=(b, *shape))
    pts = rng.uniform([0, 0], [shape[0] - 1, shape[1] - 1], (b, 333, 2))
    got = interp.bilinear_batched(jnp.asarray(pts), jnp.asarray(grids))
    assert got.shape == (b, 333)
    for i in range(b):
        np.testing.assert_allclose(np.asarray(got[i]),
                                   _bilinear_host(grids[i], pts[i]),
                                   rtol=0, atol=1e-12)


def test_lerp_uniform_clamps_outside_table():
    fp = jnp.asarray([1.0, 2.0, 4.0])
    out = interp.lerp_uniform(jnp.asarray([-10.0, 0.0, 2.0, 10.0]), fp,
                              0.0, 1.0)
    np.testing.assert_allclose(np.asarray(out), [1.0, 1.0, 4.0, 4.0])


def test_bilinear_clamps_each_axis_independently():
    grid = jnp.arange(12.0).reshape(3, 4)
    out = interp.bilinear(jnp.array([[-1.0, 1.5], [1.5, 9.0], [5.0, -2.0]]),
                          grid)
    np.testing.assert_allclose(np.asarray(out), [1.5, 9.0, 8.0])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("op", ["interp1d", "lerp_uniform", "bilinear",
                                "bilinear_batched"])
def test_interp_ops_preserve_dtype(op, dtype):
    xp = jnp.linspace(0.0, 1.0, 16, dtype=dtype)
    fp = jnp.sin(xp)
    xq = jnp.linspace(-0.1, 1.1, 7, dtype=dtype)
    grid = jnp.ones((4, 5), dtype)
    pts = jnp.full((6, 2), 1.5, dtype)
    out = {
        "interp1d": lambda: interp.interp1d(xq, xp, fp),
        "lerp_uniform": lambda: interp.lerp_uniform(xq, fp, 0.0, 1.0 / 15),
        "bilinear": lambda: interp.bilinear(pts, grid),
        "bilinear_batched": lambda: interp.bilinear_batched(
            pts[None], grid[None]),
    }[op]()
    assert out.dtype == dtype
