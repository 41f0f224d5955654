"""Small dense linear solve that works in every dtype on every backend.

The Newton direction solve is an ``n_spikes``-sized dense system
(``arma::solve(jacobian, -residual)``, ``NewtonSolver.cpp:101``
— n = 3 in the reference).  This module provides partial-pivot Gaussian
elimination with the loops unrolled at trace time (n is static and tiny),
which lowers to plain vector ops in any precision and fuses into the
surrounding Newton program instead of calling a library LU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 dots are pinned to full precision: a GPU may run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def solve_dense(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve ``A x = b`` by partial-pivot Gaussian elimination.

    Args:
      A: ``(n, n)`` matrix, n small (unrolled at trace time).
      b: ``(n,)`` or ``(n, k)`` right-hand side(s).

    Matches ``jnp.linalg.solve`` semantics for well-conditioned systems; a
    singular matrix yields inf/NaN (fails loudly, like the reference's
    ``arma::solve``).
    """
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {A.shape}")
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    M = jnp.concatenate([A.astype(B.dtype), B], axis=1)  # (n, n + k)

    for col in range(n):
        # partial pivot: swap row `col` with the max-|M[col:, col]| row
        p = col + jnp.argmax(jnp.abs(M[col:, col]))
        rc, rp = M[col], M[p]
        M = M.at[col].set(rp).at[p].set(rc)
        # eliminate below
        piv = M[col, col]
        factors = M[:, col] / piv
        mask = (jnp.arange(n) > col).astype(M.dtype)
        M = M - (mask * factors)[:, None] * M[col][None, :]

    # back substitution, unrolled
    k = M.shape[1] - n
    x = jnp.zeros((n, k), M.dtype)
    for row in range(n - 1, -1, -1):
        rhs = M[row, n:] - jnp.dot(M[row, row + 1:n], x[row + 1:],
                                    precision=_HIGHEST)
        x = x.at[row].set(rhs / M[row, row])
    return x[:, 0] if vec else x
