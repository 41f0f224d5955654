"""Two-parameter fold tracking (smooth-fold curve in the parameter plane).

The fast wave family ends *above* in a genuine smooth fold — round 2's
guarded arclength walk rounds it at ``beta = 20.3245`` (sigma = 0,
``artifacts/README.md``).  Unlike the grazing boundary (non-smooth, handled
by :mod:`.boundary`), a quadratic fold satisfies a perfectly smooth defining
system, so it can be *solved for* directly and continued in a second
parameter.  The extended (Moore-Spence) system in ``w = (Z, v, beta)``:

    F(Z; beta, sigma) = 0          (n equations — on the branch)
    J(Z; beta, sigma) v = 0        (n equations — J singular along v)
    v.v - 1 = 0                    (1 equation — null vector normalised)

is regular at a quadratic fold even though ``J`` itself is singular there,
so plain damped Newton (:func:`..solvers.newton.newton_solve`) converges
quadratically.  ``J v`` is one forward-mode JVP through the whole event
loop (the event-time implicit-function JVP, ``model/events.py``); the
extended system's own Jacobian — which contains *second* derivatives of the
map — is taken by central finite differences over the 7 unknowns, avoiding
nested differentiation of the custom event-time JVP rule.

The reference cannot do any of this (its one-parameter sweep is commented
out, ``Driver.cu:86-114``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig, MapParams, NewtonConfig
from ..model.emap import differentiable_backend, make_residual_fn
from ..solvers.newton import newton_solve
from .continuation import key_fingerprint

# f32 dots are pinned to full precision: a GPU may run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


class FoldPoint(NamedTuple):
    """One point on the fold curve ``beta_fold(sigma)``."""

    sigma: float
    beta: float               # fold location in the walked parameter
    Z: jax.Array              # solution at the fold
    v: jax.Array              # unit null vector of dF/dZ at the fold
    residual_norm: float      # of the extended system
    converged: bool


def make_fold_residual(cfg: ModelConfig, key: jax.Array,
                       *, evolve_backend: str = "auto"
                       ) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Extended-system residual ``H(w, sigma)`` with ``w = (Z, v, beta)``."""
    n = cfg.n_spikes
    dt_ = cfg.jdtype

    def H(w: jax.Array, sigma: jax.Array) -> jax.Array:
        Z, v, beta = w[:n], w[n:2 * n], w[2 * n]
        params = MapParams(beta=beta.astype(dt_),
                           sigma=jnp.asarray(sigma, dt_))
        F = make_residual_fn(cfg, params, key, evolve_backend=evolve_backend)
        f, Jv = jax.jvp(F, (Z,), (v,))
        vv = jnp.dot(v, v, precision=_HIGHEST)
        return jnp.concatenate([f, Jv, (vv - 1.0)[None]])

    return H


def null_direction(jacobian) -> np.ndarray:
    """Unit right-singular vector for the smallest singular value of J —
    the natural initial guess for the fold system's null vector."""
    _, _, vt = np.linalg.svd(np.asarray(jacobian))
    return vt[-1]


def solve_fold(cfg: ModelConfig, key: jax.Array, Z0, v0, beta0, sigma, *,
               ncfg: Optional[NewtonConfig] = None,
               evolve_backend: str = "auto",
               jit_cache: Optional[dict] = None) -> FoldPoint:
    """Newton-solve the extended fold system at fixed ``sigma``.

    ``jit_cache``: optional dict shared across calls with the same
    ``(cfg, key, ncfg, evolve_backend)`` — ``sigma`` is a traced argument
    of the cached program, so a fold-curve walk (:func:`track_fold`)
    traces and compiles the extended solve once, not once per sigma.
    """
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-8, max_iterations=20,
                            fd_epsilon=1e-6, fd_mode="central")
    dt_ = cfg.jdtype
    # exact mode would need second derivatives through the event-time
    # custom JVP; pin finite differences for the extended system.  replace()
    # keeps every other field (divergence_factor in particular) intact.
    if ncfg.fd_mode in ("exact", "frozen", "frozen-fwd"):
        # (the frozen modes likewise: the fused frozen-FD corrector
        # differences the plain map, not the J.v Moore-Spence rows)
        ncfg = dataclasses.replace(ncfg, fd_mode="central", fd_epsilon=1e-6)
    cache = jit_cache if jit_cache is not None else {}
    ident = (cfg, ncfg, evolve_backend, key_fingerprint(key))
    if cache.setdefault("_identity", ident) != ident:
        raise ValueError(
            "jit_cache was built for a different fold setup (cfg, ncfg, "
            "evolve_backend, or PRNG key differ); use a fresh cache.")
    if "solve" not in cache:
        # H contains Jv = one first-order JVP: any differentiable backend
        # works (xla, or the df64 replay — its scan carries the event-time
        # IFT rule)
        backend = differentiable_backend(evolve_backend)
        H = make_fold_residual(cfg, key, evolve_backend=backend)
        cache["solve"] = jax.jit(lambda w, s: newton_solve(
            lambda ww: H(ww, s), w, ncfg))
    sigma = jnp.asarray(sigma, dt_)
    w0 = jnp.concatenate([jnp.asarray(Z0, dt_), jnp.asarray(v0, dt_),
                          jnp.asarray(beta0, dt_)[None]])
    res = cache["solve"](w0, sigma)
    n = cfg.n_spikes
    sol = res.solution
    return FoldPoint(sigma=float(sigma), beta=float(sol[2 * n]),
                     Z=np.asarray(sol[:n]), v=np.asarray(sol[n:2 * n]),
                     residual_norm=float(res.residual_norm),
                     converged=bool(res.converged))


def track_fold(cfg: ModelConfig, key: jax.Array, Z0, v0, beta0,
               sigma_values: Sequence[float], *,
               ncfg: Optional[NewtonConfig] = None,
               evolve_backend: str = "auto",
               callback: Optional[Callable] = None) -> list[FoldPoint]:
    """Continue the fold curve over ``sigma_values``, warm-starting each
    solve from the previous fold point.  Stops at the first failure (the
    fold may leave the probed window or collide with the grazing
    boundary); the returned prefix is valid."""
    out: list[FoldPoint] = []
    Z, v, beta = Z0, v0, beta0
    cache: dict = {}  # one traced/compiled extended solve for the walk
    for sigma in sigma_values:
        pt = solve_fold(cfg, key, Z, v, beta, float(sigma), ncfg=ncfg,
                        evolve_backend=evolve_backend, jit_cache=cache)
        if not (pt.converged and np.all(np.isfinite(pt.Z))
                and np.isfinite(pt.beta)):
            break
        out.append(pt)
        if callback is not None:
            callback(pt)
        Z, v, beta = pt.Z, pt.v, pt.beta
    return out
