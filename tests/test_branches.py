"""Branch-switching enumeration (analysis/branches.py).

The reference has no branch enumeration at all (its single sweep is
commented out, ``Driver.cu:86-114``); these tests pin the
worklist mechanics — guarded walks from both seed directions, diagram-plane
deduplication, and discovery-probe gating — on the CPU fp64 oracle path at
small scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation import (
    NewtonConfig, enumerate_branches)
from armadillocudalinearinterpolation.analysis.branches import is_known


# converged fixed point at N=512 (see conftest z_ref / verify drive)
Z0 = [0.32623663, 0.71936722, 1.36899475]


def test_is_known_diagram_plane():
    # points are compared in the (param, c) plane only: spike offsets
    # (middle entries) may drift without affecting identity
    known = [np.array([13.0, 0.33])]
    assert is_known(np.array([0.33, 0.70, 1.37, 13.0]), known, tol=0.05)
    assert is_known(np.array([0.33, 9.90, 9.99, 13.01]), known, tol=0.05)
    # a different wave speed at the same parameter is a different family
    assert not is_known(np.array([0.45, 0.70, 1.37, 13.0]), known, tol=0.05)
    assert not is_known(np.array([0.33, 0.70, 1.37, 14.0]), known, tol=0.05)
    assert not is_known(np.array([0.33, 0.70, 1.37, 13.0]), [], tol=0.05)


@pytest.fixture(scope="module")
def walked(cfg, key):
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    return enumerate_branches(
        cfg, key, jnp.asarray(Z0, jnp.float64), 13.0589, sigma=0.0,
        ds=0.2, n_steps=2, ncfg=ncfg, max_branches=2,
        jump_ds_factors=(2.0,))


def test_enumerates_both_seed_directions(walked):
    origins = [b.origin for b in walked]
    assert "seed+" in origins and "seed-" in origins


def test_walks_are_converged_and_distinct(walked):
    assert all(len(b.points) >= 1 for b in walked)
    up = next(b for b in walked if b.origin == "seed+")
    dn = next(b for b in walked if b.origin == "seed-")
    # both hit the 2-step limit on the smooth branch interior...
    assert up.hit_step_limit and dn.hit_step_limit
    # ...walking beta opposite ways from the same seed
    assert up.points[-1, -1] > 13.0589 > dn.points[-1, -1]
    # finite, sane wave speeds along both walks
    for b in walked:
        assert np.all(np.isfinite(b.points))
        assert np.all(b.points[:, 0] > 0.05) and np.all(b.points[:, 0] < 2.0)


def test_callback_receives_branch_and_step_indices(cfg, key):
    ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    seen = []
    enumerate_branches(
        cfg, key, jnp.asarray(Z0, jnp.float64), 13.0589,
        ds=0.2, n_steps=1, ncfg=ncfg, max_branches=1,
        callback=lambda b, i, s: seen.append((b, i, float(s.y[-1]))))
    assert [x[:2] for x in seen] == [(0, 0)]
    assert np.isfinite(seen[0][2])
