"""Automated branch enumeration — branch-switching continuation.

The reference's production loop walks ONE branch in one direction and dies
at its end (``Driver.cu:86-114``, commented out).  Round-1/2
artifacts showed the interesting structure of this model lives *across*
branches: a slow and a fast wave family connected near a grazing-type
boundary at ``beta ~ 16`` where the unguarded arclength corrector was
observed to tunnel between them (``artifacts/arclength_branches``).

This module turns that accident into a feature: a worklist-driven enumerator
that walks every discovered branch in both directions with the *guarded*
corrector (no silent family jumps), then at each detected branch end fires
deliberate unguarded "discovery" steps of increasing length; any landing
point that is far from the end and not on a known branch seeds a new walk.
Deduplication happens in the bifurcation-diagram plane ``(parameter, c)``
(wave speed ``c = Z[0]``), which is how the families are distinguished in
the artifacts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig, NewtonConfig
from ..model.emap import differentiable_backend
from .continuation import continue_branch, make_arclength_step_jit


class Branch(NamedTuple):
    """One fully-walked branch segment."""

    points: np.ndarray        # (K, n+1) accepted y = (Z..., param) per step
    origin: str               # how this walk was seeded (for provenance)
    hit_step_limit: bool      # False = ended at a genuine branch end


def _diagram_coords(y: np.ndarray) -> np.ndarray:
    """Project a point onto the bifurcation-diagram plane (param, c)."""
    return np.asarray([y[-1], y[0]], dtype=float)


def is_known(y, known_pts: list[np.ndarray], tol: float) -> bool:
    """True if ``y`` lies within ``tol`` of any recorded branch point.

    Distance is Euclidean in the ``(parameter, c)`` diagram plane — two
    wave families with the same parameter value differ in speed ``c``, so
    this separates them while being insensitive to the gauge-fixed spike
    offsets' slow drift along a branch.
    """
    if not known_pts:
        return False
    d = _diagram_coords(np.asarray(y))
    pts = np.stack(known_pts)
    return bool(np.min(np.linalg.norm(pts - d, axis=1)) < tol)


def enumerate_branches(cfg: ModelConfig, key: jax.Array, Z0, beta0, *,
                       sigma=0.0, param: str = "beta",
                       ds: float = 0.1, n_steps: int = 100,
                       ncfg: Optional[NewtonConfig] = None,
                       evolve_backend: str = "auto",
                       max_branches: int = 4,
                       jump_ds_factors=(0.02, 0.1, 0.5, 1.0, 2.0, 4.0, 8.0),
                       jump_min_dist: float = 0.3,
                       dedupe_tol: float = 0.05,
                       callback: Optional[Callable] = None,
                       mesh=None, mesh_axis: str = "real",
                       **walk_kw) -> list[Branch]:
    """Enumerate solution families reachable from ``(Z0, beta0)``.

    Walks the seed branch in both directions with the guarded corrector
    (``max_step_factor`` intact, so a walk never silently changes family).
    New families come from two harvests per walk:

    * **tunnels** — corrector solutions the guard rejected for landing too
      far away (via ``reject_hook``): each is an *observed* jump to another
      solution, typically the coexisting family whose basin abuts the
      boundary;
    * **end probes** — deliberate unguarded steps of ``ds * factor`` past
      a detected branch end, for each factor in ``jump_ds_factors``.

    A candidate farther than ``jump_min_dist`` from its branch end (probes)
    and not within ``dedupe_tol`` of any recorded point in the
    ``(param, c)`` plane becomes a new seed, itself walked in both
    directions.  Terminates when the worklist drains or ``max_branches``
    walks have been accepted.

    Args:
      beta0 / sigma / param: same convention as :func:`continue_branch` —
        ``param`` names the walked axis; the other value is held fixed.
      callback: optional ``f(branch_index, step_index, ArcStep)`` forwarded
        to each walk (the CLI uses it for logging/checkpointing).
      **walk_kw: extra keyword arguments passed through to
        :func:`continue_branch` (e.g. ``min_ds``, ``max_ds``).

    Returns:
      List of :class:`Branch`, in discovery order.  A branch whose
      ``hit_step_limit`` is False ended because the corrector failed even
      at the minimum step — a fold that cannot be rounded, a grazing-type
      boundary, or the edge of the wave family's existence region.
    """
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                            fd_mode="exact")
    dt_ = cfg.jdtype
    fixed, free0 = ((sigma, beta0) if param == "beta" else (beta0, sigma))
    # exact mode forward-differentiates the bordered residual; the Pallas
    # kernel has no JVP, so resolve to a differentiable backend here (the
    # library surface must not depend on the CLI's guard — ADVICE.md r2)
    backend = (differentiable_backend(evolve_backend)
               if ncfg.fd_mode == "exact" else evolve_backend)
    # ONE corrector program for the whole enumeration: every walk (via
    # jit_cache) and every end probe reuses it — the held value, param,
    # and ncfg are identical across the worklist, so re-tracing the
    # bordered system per branch walk (seconds on the XLA backend, ~13 s
    # on replay) would be pure waste
    walk_cache: dict = {}
    if ncfg.fd_mode in ("frozen", "frozen-fwd"):
        # (frozen-fwd — the staged solver's default stencil — routes to
        # the same corrector: the bordered system always differences its
        # central stencil, see make_arclength_step_frozen)
        from .continuation import make_arclength_step_frozen
        probe = make_arclength_step_frozen(cfg, key, fixed, param, ncfg,
                                           mesh=mesh, mesh_axis=mesh_axis)
    elif mesh is not None:
        # same contract as continue_branch: only the frozen corrector
        # shards — fail loudly instead of silently walking unsharded
        raise ValueError(
            "mesh-sharded branch enumeration needs a frozen corrector: "
            "pass ncfg with fd_mode='frozen' (or 'frozen-fwd'), or drop "
            "the mesh")
    else:
        probe = make_arclength_step_jit(cfg, key, fixed, param, ncfg,
                                        backend)
    walk_cache["step"] = probe

    known_pts: list[np.ndarray] = []
    branches: list[Branch] = []
    # worklist: (Z_start, free_start, direction, origin, tangent0)
    work = [(jnp.asarray(Z0, dt_), float(free0), +1.0, "seed+", None),
            (jnp.asarray(Z0, dt_), float(free0), -1.0, "seed-", None)]

    def queue_seed(y_new: np.ndarray, origin: str,
                   tangent0=None) -> bool:
        """Accept a discovery candidate if it is genuinely new.

        With ``tangent0`` (an end-probe's jump direction) only the
        continuation direction is walked — the reverse walk would re-cross
        the probed branch end and re-walk the branch that just ended (a
        tunnel to a *new* family, by contrast, is walked both ways).
        """
        if is_known(y_new, known_pts, dedupe_tol):
            return False
        work.append((jnp.asarray(y_new[:-1], dt_), float(y_new[-1]),
                     +1.0, origin + "+", tangent0))
        if tangent0 is None:
            work.append((jnp.asarray(y_new[:-1], dt_), float(y_new[-1]),
                         -1.0, origin + "-", None))
        # mark immediately so later candidates at the same point dedupe
        known_pts.append(_diagram_coords(y_new))
        return True

    while work and len(branches) < max_branches:
        Zs, ps, direction, origin, tan0 = work.pop(0)
        b_idx = len(branches)
        cb = ((lambda i, s: callback(b_idx, i, s))
              if callback is not None else None)
        walk_beta0, walk_sigma = ((ps, fixed) if param == "beta"
                                  else (fixed, ps))
        # Converged-but-rejected correctors ARE observed tunnels to another
        # family (the guard exists precisely to refuse them); harvest them
        # as discovery seeds instead of throwing the information away.
        tunnels: list[np.ndarray] = []
        steps = continue_branch(
            cfg, key, Zs, walk_beta0, sigma=walk_sigma, param=param,
            ds=ds, n_steps=n_steps, direction=direction, ncfg=ncfg,
            evolve_backend=backend, callback=cb, tangent0=tan0,
            reject_hook=tunnels.append, jit_cache=walk_cache,
            mesh=mesh, mesh_axis=mesh_axis, **walk_kw)
        if not steps:
            continue
        pts = np.stack([np.asarray(s.y) for s in steps])
        branches.append(Branch(points=pts, origin=origin,
                               hit_step_limit=len(steps) == n_steps))
        known_pts.extend(_diagram_coords(p) for p in pts)

        # A tunnel candidate must clear the same minimum distance as end
        # probes — measured against the walked branch in the diagram plane —
        # or a converged-but-rejected long corrector step landing farther
        # along the SAME family would be queued as a "new family" and
        # re-walk a known branch (round-2 advisor finding, ADVICE.md).
        walk_dc = np.stack([_diagram_coords(p) for p in pts])
        for y_t in tunnels:
            d_t = _diagram_coords(np.asarray(y_t))
            if float(np.min(np.linalg.norm(walk_dc - d_t, axis=1))
                     ) < jump_min_dist:
                continue
            if queue_seed(y_t, f"tunnel@{origin}:"):
                break  # one new family per walk end is plenty
        if len(steps) == n_steps:
            continue  # no branch end reached; nothing further to probe

        # branch end: deliberate unguarded discovery probes
        y_end, t_end = steps[-1].y, steps[-1].tangent
        for factor in jump_ds_factors:
            res = probe(y_end, t_end, jnp.asarray(factor * ds, dt_))
            if not (bool(res.converged)
                    and bool(jnp.all(jnp.isfinite(res.solution)))):
                continue
            y_new = np.asarray(res.solution)
            d = y_new - np.asarray(y_end)
            if (np.linalg.norm(d) >= jump_min_dist
                    and queue_seed(y_new, f"jump@{origin}:{factor:g}ds",
                                   tangent0=d / np.linalg.norm(d))):
                break
    return branches
