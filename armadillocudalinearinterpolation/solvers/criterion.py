"""Convergence criteria (swappable, reference ``ConvergenceCriterion``).

The reference's criterion object (``ConvergenceCriterion.cpp:11-15``)
is the absolute test ``||r||_2 <= tol``.  Here a criterion is any JAX-traceable
``(residual_norm) -> bool`` closure so solvers stay criterion-agnostic, as the
reference's solver is via its ``ConvergenceCriterion*`` member.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Criterion = Callable[[jax.Array], jax.Array]


def residual_norm_criterion(tolerance: float) -> Criterion:
    """Absolute residual-norm test ``||r|| <= tol`` (``ConvergenceCriterion.cpp:14``)."""
    def test(residual_norm: jax.Array) -> jax.Array:
        return residual_norm <= tolerance
    return test


def relative_criterion(tolerance: float, initial_norm: jax.Array) -> Criterion:
    """Relative test ``||r|| <= tol * ||r0||`` (extension beyond the reference)."""
    def test(residual_norm: jax.Array) -> jax.Array:
        return residual_norm <= tolerance * initial_norm
    return test
