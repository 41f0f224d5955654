"""Two-parameter fold tracking (analysis/fold.py).

Pins the Moore-Spence extended system against the round-2 arclength
reference: the fast family's smooth fold at ``beta = 20.3245`` (sigma = 0,
N = 512, ``artifacts/README.md``), on the CPU fp64 oracle path.
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, make_residual_fn, solve_fold)
from armadillocudalinearinterpolation.analysis.fold import null_direction


@pytest.mark.slow
def test_fold_matches_arclength_reference(cfg, key):
    # near-fold point from the guarded arclength walk (artifacts)
    Z0 = jnp.asarray([0.59145, 0.57176, 10.07225], jnp.float64)
    beta0 = 20.32
    F = make_residual_fn(cfg, MapParams.create(beta0, 0.0, dtype="float64"),
                         key, evolve_backend="xla")
    J = jax.jacfwd(F)(Z0)
    sv = np.linalg.svd(np.asarray(J))[1]
    assert sv[-1] < 0.1 < sv[-2]          # near-singular: one vanishing sv
    v0 = null_direction(J)

    # 1e-6 keeps the test fast (~10 FD-Newton iterations); the full-depth
    # solve (tolerance 1e-8, 20 iterations) was measured at |H| = 3.2e-10
    # with the same fold location to 5e-5
    ncfg = NewtonConfig(tolerance=1e-6, max_iterations=12,
                        fd_epsilon=1e-6, fd_mode="central")
    pt = solve_fold(cfg, key, Z0, v0, beta0, 0.0, ncfg=ncfg)
    assert pt.converged
    # the walker rounded this fold at beta = 20.3245; Moore-Spence solves
    # for it directly
    assert abs(pt.beta - 20.3245) < 5e-3
    assert pt.residual_norm < 1e-6
    np.testing.assert_allclose(np.linalg.norm(pt.v), 1.0, rtol=1e-9)
    assert np.all(np.isfinite(pt.Z))
