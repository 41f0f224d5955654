"""Linear-stability analysis of fixed points.

Reference: ``Stability`` (``Stability.cpp:22-111``): compute
the eigenvalues of the (finite-difference or analytic) Jacobian and count
unstable ones under three criteria:

  * ``flow``          — Re(lambda) > 0
  * ``map``           — |lambda| > 1
  * ``equation_free`` — add the identity first (the equation-free map is
    ``M(U) = U + F(U)``, so its linearisation is ``I + J``;
    ``Stability.cpp:66-71``), then the map test.

The tiny ``n_spikes x n_spikes`` general eigenproblem is evaluated on the
host (``numpy``, via ``pure_callback`` under tracing) — the same division of
labour as the reference, which runs Armadillo's ``eig_gen`` on the CPU next
to a GPU map.

The reference reads its FD epsilon uninitialised (``Stability.cpp:90``, never
set in either constructor — catalogued in SURVEY.md §7); here epsilon is an
explicit argument.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..solvers.newton import fd_jacobian


class ProblemType(enum.Enum):
    """Stability criterion selector (``Stability.hpp:13-18``)."""

    FLOW = "flow"
    MAP = "map"
    EQUATION_FREE = "equation_free"


def eigvals(jacobian: jax.Array) -> jax.Array:
    """Eigenvalues of a (small, dense, general) Jacobian.

    The eigendecomposition runs in fp64 on the host, exactly as the
    reference runs Armadillo's ``eig_gen`` on the CPU beside a GPU map.  A
    concrete (non-traced) Jacobian — the normal analysis path — is pulled to
    the host directly.  Under tracing (e.g. eigenvalues inside a jitted
    sweep) a ``pure_callback`` is emitted instead.  The complex dtype follows the x64
    flag (declaring complex128 with x64 disabled is itself an error).
    """
    n = jacobian.shape[0]
    cdtype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64

    def _host(jac) -> np.ndarray:
        j64 = np.asarray(jac, np.float64)
        if not np.isfinite(j64).all():
            # A failed solve (NaN residuals) should yield a NaN spectrum,
            # not a LinAlgError deep inside a sweep.
            return np.full((n,), np.nan + 1j * np.nan, np.dtype(cdtype))
        return np.linalg.eigvals(j64).astype(np.dtype(cdtype))

    if isinstance(jacobian, jax.core.Tracer):
        return jax.pure_callback(
            _host,
            jax.ShapeDtypeStruct((n,), cdtype),
            jacobian,
            vmap_method="sequential",
        )
    # Concrete path: stay on the host.
    return _host(jacobian)


def compute_eigenvalues(
    F: Callable[[jax.Array], jax.Array],
    u: jax.Array,
    problem_type: ProblemType = ProblemType.EQUATION_FREE,
    *,
    epsilon: float = 1e-2,
    jacobian_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
    jacobian: Optional[jax.Array] = None,
) -> jax.Array:
    """Eigenspectrum of the linearisation at ``u`` (``Stability.cpp:52-74``).

    Precedence mirrors the reference: an explicitly supplied ``jacobian``
    (the solver's export), else ``jacobian_fn`` (analytic), else finite
    differences at ``epsilon``.
    """
    if jacobian is None:
        if jacobian_fn is not None:
            jacobian = jacobian_fn(u)
        else:
            jacobian = fd_jacobian(F, u, F(u), epsilon)
    if problem_type is ProblemType.EQUATION_FREE:
        jacobian = jacobian + jnp.eye(jacobian.shape[0], dtype=jacobian.dtype)
    return eigvals(jacobian)


def count_unstable(eigenvalues,
                   problem_type: ProblemType):
    """Unstable-eigenvalue count under the given criterion (``Stability.cpp:27-34``).

    Accepts host (numpy) or device arrays; host spectra are counted with
    numpy so complex values never touch a backend without complex support.
    """
    xp = np if isinstance(eigenvalues, np.ndarray) else jnp
    if problem_type is ProblemType.FLOW:
        return xp.sum(xp.real(eigenvalues) > 0.0)
    return xp.sum(xp.abs(eigenvalues) > 1.0)


def num_unstable_eigenvalues(
    F: Callable[[jax.Array], jax.Array],
    u: jax.Array,
    problem_type: ProblemType = ProblemType.EQUATION_FREE,
    **kwargs,
) -> jax.Array:
    """Count unstable eigenvalues at ``u`` (``Stability.cpp:22-35``)."""
    ev = compute_eigenvalues(F, u, problem_type, **kwargs)
    return count_unstable(ev, problem_type)
