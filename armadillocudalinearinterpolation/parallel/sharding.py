"""Ensemble sharding: spread Monte-Carlo realisations over a device mesh.

The reference is single-process single-GPU; its only cross-realisation
communication is the final accept-masked average (SURVEY.md §2, "Distributed
communication backend: none").  The scaling story is therefore
simple and clean: the realisation axis of every ``(n_real, ...)`` array is
sharded over a mesh axis, the event loop partitions embarrassingly (it is
``vmap`` over realisations), and the only collective XLA inserts is the
``psum`` behind the masked mean.

We deliberately use the GSPMD path (``with_sharding_constraint`` under
``jit``) rather than hand-written ``shard_map`` collectives: the sharded and
unsharded programs are the *same traced function*, so correctness transfers
bitwise (tested), and XLA owns the collective schedule.

A second mesh axis (``batch``) shards the Newton solver's finite-difference
Jacobian evaluations — the ``n_spikes + 1`` whole-map evaluations that a
solve step batches via ``vmap`` (``NewtonSolver.cpp:181-195`` serialises
these on the reference).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig, MapParams, NewtonConfig
from ..model import emap as _emap
from ..model.restrict import masked_ensemble_mean
from ..solvers.newton import newton_solve, NewtonResult


def make_mesh(axis_sizes: dict[str, int],
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a named device mesh, e.g. ``make_mesh({"real": 8})`` or
    ``make_mesh({"batch": 2, "real": 4})``."""
    devices = list(devices) if devices is not None else jax.devices()
    shape = tuple(axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, tuple(axis_sizes.keys()))


def ensemble_constraint(mesh: Mesh, axis: str = "real"
                        ) -> Callable[[jax.Array], jax.Array]:
    """Sharding-constraint closure for ``(..., n_real, n_neurons)`` arrays:
    realisations over ``axis``, neurons replicated (the event loop needs the
    whole ring per realisation for the argmin and the coupling kick)."""
    def constrain(x: jax.Array) -> jax.Array:
        if x.ndim < 2:
            # The contract is (..., n_real, n_neurons).  A rank-1 array is
            # ambiguous — a per-realisation vector wants P(axis), a
            # per-neuron ring vector wants replication — so guessing here
            # could silently shard neurons over the realisation axis.
            # Constrain explicitly at such a call site instead.
            raise ValueError(
                f"ensemble_constraint needs (..., n_real, n_neurons) "
                f"arrays (got rank {x.ndim}); apply an explicit "
                "with_sharding_constraint for lower-rank values")
        # leading dims (e.g. a vmapped FD batch) replicated, realisations
        # sharded, ring replicated
        spec = P(*([None] * (x.ndim - 2)), axis, None)
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
    return constrain


def event_driven_map_sharded(cfg: ModelConfig, params: MapParams,
                             key: jax.Array, Z: jax.Array, mesh: Mesh,
                             axis: str = "real") -> jax.Array:
    """:func:`..model.emap.event_driven_map` with the realisation ensemble
    sharded over ``mesh[axis]``.  Identical numerics to the unsharded map
    (same traced program, GSPMD-partitioned).  Always uses the XLA evolve
    backend: GSPMD cannot partition a ``pallas_call`` — use
    :func:`make_shard_map_residual_fn` for the Pallas multi-chip route."""
    constrain = ensemble_constraint(mesh, axis)
    beta = constrain(_emap.sample_beta(cfg, params, key))
    U, _, _, _, res, positions = _emap.run_pipeline(cfg, params, Z, beta)
    u_mean, _ = masked_ensemble_mean(positions, res.accept)
    return _emap.assemble_residual(cfg, U, u_mean)


def make_sharded_residual_fn(cfg: ModelConfig, params: MapParams,
                             key: jax.Array, mesh: Mesh, axis: str = "real"
                             ) -> Callable[[jax.Array], jax.Array]:
    """Residual oracle ``F: Z -> f`` with the ensemble sharded over the mesh."""
    def F(Z: jax.Array) -> jax.Array:
        return event_driven_map_sharded(cfg, params, key, Z, mesh, axis)
    return F


def sharded_newton_solve(cfg: ModelConfig, params: MapParams, key: jax.Array,
                         Z0: jax.Array, newton_cfg: NewtonConfig, mesh: Mesh,
                         *, real_axis: str = "real") -> NewtonResult:
    """Full Newton solve with the realisation ensemble sharded over the mesh.

    The FD Jacobian's ``vmap`` over perturbed points composes with the GSPMD
    constraint (the batch dim prepends to the sharding spec), so each solver
    iteration is still one device program with all ``n_spikes + 1`` map
    evaluations in flight.  Wrap in ``jax.jit`` for the one-launch solve.
    """
    F = make_sharded_residual_fn(cfg, params, key, mesh, real_axis)
    return newton_solve(F, Z0, newton_cfg)


def make_gspmd_map_fn(cfg: ModelConfig, mesh: Mesh, axis: str = "real",
                      evolve_backend: str = "xla"
                      ) -> Callable[[jax.Array, MapParams, jax.Array],
                                    jax.Array]:
    """``(Z, params, key) -> f`` with the ensemble GSPMD-constrained.

    The same traced map as :func:`..model.emap.event_driven_map`,
    partitioned by XLA over ``mesh[axis]`` — with ``(params, key)`` as
    *traced arguments*, so sweep caches built on it stay valid as the
    parameters change step to step (unlike
    :func:`make_sharded_residual_fn`, which closes over them).  The
    replay's f32 schedule pass is pinned to the XLA backend and the
    evolve never selects the Pallas kernel (a ``pallas_call`` cannot be
    GSPMD-partitioned); ``"auto"``/``"pallas"`` therefore resolve to the
    XLA evolve, ``"replay"`` keeps the df64 schedule replay.
    """
    if evolve_backend not in ("xla", "auto", "pallas", "replay"):
        # every unmeshed variant raises on an unknown backend via
        # select_pallas_evolve; an unvalidated string here would silently
        # run the XLA evolve instead of the (e.g. mistyped) replay the
        # caller asked for — different numerics, no error
        raise ValueError(f"unknown evolve_backend {evolve_backend!r} "
                         "(use 'xla', 'auto', 'pallas' or 'replay')")
    cst = ensemble_constraint(mesh, axis)
    use_replay = evolve_backend == "replay"

    def F(Z: jax.Array, params: MapParams, key: jax.Array) -> jax.Array:
        beta = cst(_emap.sample_beta(cfg, params, key))
        U, _, _, _, res, positions = _emap.run_pipeline(
            cfg, params, Z, beta, use_replay=use_replay,
            schedule_backend="xla")
        u_mean, _ = masked_ensemble_mean(positions, res.accept)
        return _emap.assemble_residual(cfg, U, u_mean)
    return F


def make_shard_map_residual_fn(cfg: ModelConfig, params: MapParams,
                               key: jax.Array, mesh: Mesh,
                               axis: str = "real",
                               evolve_backend: str = "auto",
                               ) -> Callable[[jax.Array], jax.Array]:
    """Residual oracle with explicit per-device map shards (``shard_map``).

    The GSPMD path (:func:`make_sharded_residual_fn`) lets XLA partition the
    traced program, which works for the XLA evolve backend but cannot split a
    ``pallas_call``.  This variant runs the *whole local map* (optionally with
    the Pallas evolve kernel) on each device's slice of the ensemble and
    merges with one ``psum`` pair (position sums + accept counts) —
    the only cross-device communication the problem has (SURVEY.md §2).

    Each device draws its own heterogeneity slice from
    ``fold_in(key, axis_index)``: deterministic for a fixed mesh, and still
    common-random-numbers across evaluations within a solve.  (Draws differ
    from the single-device layout; at ``sigma == 0`` results are identical.)
    """
    n_dev = mesh.shape[axis]
    if cfg.n_real % n_dev:
        raise ValueError(f"n_real={cfg.n_real} must divide over {n_dev} "
                         f"devices on axis {axis!r}")
    local_cfg = cfg.with_(n_real=cfg.n_real // n_dev)
    dt_ = cfg.jdtype

    use_pallas = _emap.select_pallas_evolve(cfg, evolve_backend)
    use_replay = evolve_backend == "replay"

    def local_map(Z):
        idx = jax.lax.axis_index(axis)
        local_key = jax.random.fold_in(key, idx)
        beta = _emap.sample_beta(local_cfg, params, local_key)
        U, _, _, _, res, positions = _emap.run_pipeline(
            local_cfg, params, Z, beta, use_pallas=use_pallas,
            use_replay=use_replay)
        mask = res.accept.astype(dt_)[:, None]
        total_sum = jax.lax.psum(jnp.sum(positions * mask, axis=0), axis)
        total_count = jax.lax.psum(jnp.sum(res.accept.astype(dt_)), axis)
        return _emap.assemble_residual(cfg, U, total_sum / total_count)

    spec_rep = P()
    smapped = jax.shard_map(local_map, mesh=mesh, in_specs=(spec_rep,),
                            out_specs=spec_rep, check_vma=False)

    def F(Z: jax.Array) -> jax.Array:
        return smapped(Z)
    return F
