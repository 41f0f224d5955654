"""Two-parameter existence-boundary tracking (analysis/boundary.py).

Pins the solvability-bisection mechanics on the CPU fp64 oracle path at the
known sigma = 0 boundary of the slow wave family (``beta* = 16.0144`` from
the round-2 arclength walk, ``artifacts/README.md``) at coarse tolerance so
the test stays fast.
"""

import jax.numpy as jnp
import pytest
import numpy as np

from armadillocudalinearinterpolation import (
    NewtonConfig, track_existence_boundary)


Z0 = jnp.asarray([0.32623663, 0.71936722, 1.36899475], jnp.float64)


def test_bracket_probe_lands_on_the_failure_side(cfg, key):
    """Direction must flow into the probe's beta.  The arc pin is unsigned
    and the signed offset lives in ds alone; signing both used to cancel,
    so a direction=-1 probe converged at beta* + tol (the interior side of
    a lower boundary) instead of beta* - tol."""
    from armadillocudalinearinterpolation.analysis.boundary import (
        _make_bracket_step, _verify_bracket)
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    step = _make_bracket_step(cfg, key, ncfg, "xla")
    # deep inside the family both probes converge, and the arc row forces
    # the probed beta EXACTLY tol away on the requested side
    for sgn in (+1.0, -1.0):
        res = step(jnp.concatenate([Z0, jnp.asarray([13.0589], jnp.float64)]),
                   jnp.concatenate([Z0, jnp.asarray([13.0589 + sgn * 0.05],
                                                    jnp.float64)]),
                   jnp.asarray(0.0, jnp.float64),
                   jnp.asarray(sgn * 0.05, jnp.float64))
        assert bool(res.converged)
        assert float(res.solution[-1]) == 13.0589 + sgn * 0.05
        # _verify_bracket reports the probed side consistently
        bs, _, _, bf, _ = _verify_bracket(
            step, jnp.float64, 0.08, 0.0, sgn, 0.05, 13.0589,
            np.asarray(Z0), 0.0, None, max_probes=1)
        assert bf == bs + sgn * 0.05


@pytest.mark.slow
def test_tracks_sigma0_grazing_boundary(cfg, key):
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    seen = []
    pts = track_existence_boundary(
        cfg, key, Z0, 13.0589, [0.0], bracket=0.5, bisect_tol=0.1,
        ncfg=ncfg, callback=seen.append)
    assert len(pts) == 1 and seen == [pts[0]]
    p = pts[0]
    # the slow family's grazing end is at beta* ~ 16.01 (arclength walk);
    # a 0.1-wide bracket around it must contain that value
    assert p.beta_star <= 16.0144 <= p.beta_fail or \
        abs(p.beta_star - 16.0144) < 0.1
    assert 0 < p.beta_fail - p.beta_star <= 0.2 + 1e-12
    # stayed on the slow family: wave speed continuous from the seed
    assert abs(float(p.Z[0]) - 0.345) < 0.05
    assert p.residual_norm < 1e-8
    assert np.all(np.isfinite(p.Z))
