"""Stability tests: the three criteria on known matrices, FD path, and the
equation-free identity shift (Stability.cpp:22-74)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    ProblemType, compute_eigenvalues, num_unstable_eigenvalues)
from armadillocudalinearinterpolation.analysis.stability import (
    count_unstable, eigvals)


def test_eigvals_general_matrix():
    """Non-symmetric matrix with known complex spectrum (rotation-ish)."""
    jac = jnp.array([[0.0, -2.0], [2.0, 0.0]])
    ev = np.sort_complex(np.asarray(eigvals(jac)))
    np.testing.assert_allclose(ev, [-2j, 2j], atol=1e-12)


def test_count_unstable_flow_vs_map():
    ev = jnp.asarray([3.0 + 0j, -0.5 + 0j, -0.2 + 0.99j])
    assert int(count_unstable(ev, ProblemType.FLOW)) == 1      # Re > 0
    assert int(count_unstable(ev, ProblemType.MAP)) == 2       # |.| > 1


def test_equation_free_adds_identity():
    """Linear problem F(u) = A u: equation-free spectrum is eig(A + I)."""
    A = jnp.array([[-0.5, 0.1], [0.0, -1.8]])
    F = lambda u: A @ u
    u0 = jnp.array([0.3, -0.2])
    ev_ef = np.sort_complex(np.asarray(
        compute_eigenvalues(F, u0, ProblemType.EQUATION_FREE, epsilon=1e-7)))
    want = np.sort_complex(np.linalg.eigvals(np.asarray(A) + np.eye(2)))
    np.testing.assert_allclose(ev_ef, want, atol=1e-5)
    # A+I has eigenvalues {0.5, -0.8}: stable as a map
    assert int(num_unstable_eigenvalues(
        F, u0, ProblemType.EQUATION_FREE, epsilon=1e-7)) == 0


def test_supplied_jacobian_bypasses_fd():
    """Solver-exported Jacobian is reused without re-evaluating F
    (the pJacobianExternal path, NewtonSolver.cpp:153-159)."""
    calls = []
    def F(u):
        calls.append(1)
        return u
    jac = jnp.array([[2.0, 0.0], [0.0, 3.0]])
    ev = compute_eigenvalues(F, jnp.zeros(2), ProblemType.MAP, jacobian=jac)
    assert not calls
    np.testing.assert_allclose(np.sort(np.asarray(ev).real), [2.0, 3.0])


def test_analytic_jacobian_fn_path():
    F = lambda u: u ** 2
    jfn = lambda u: jnp.diag(2 * u)
    ev = compute_eigenvalues(F, jnp.array([1.0, 2.0]), ProblemType.FLOW,
                             jacobian_fn=jfn)
    np.testing.assert_allclose(np.sort(np.asarray(ev).real), [2.0, 4.0])


def test_eigvals_under_jit():
    """pure_callback works inside jit (the host/device boundary documented in
    SURVEY.md §7 hard-part 4)."""
    f = jax.jit(lambda m: eigvals(m))
    ev = f(jnp.array([[1.0, 0.0], [0.0, 5.0]]))
    np.testing.assert_allclose(np.sort(np.asarray(ev).real), [1.0, 5.0])
