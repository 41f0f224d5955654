"""The event-driven map: one jitted pure function ``F(Z)``.

Reference: ``EventDrivenMap::ComputeF`` (``EventDrivenMap.cu:154-240``)
— the full lift → evolve → restrict → reduce pipeline plus gauge fixing and
residual assembly.  The reference crosses the host↔device boundary five times
per evaluation (index upload, parameter upload, RNG fill, result download,
residual assembly on host); here the entire map is one traced function with
zero host round-trips, so ``vmap`` batches whole map evaluations (the
finite-difference Jacobian's ``n_spikes + 1`` evaluations become ONE device
launch) and ``shard_map`` spreads the realisation ensemble over a mesh.

Common random numbers: the reference reseeds cuRAND to a fixed seed before
*every* evaluation (``EventDrivenMap.cu:178``) so that the stochastic map is
deterministic within a Newton solve.  Here the caller passes an explicit
``jax.random`` key; using the same key across evaluations *is* the
common-random-numbers protocol, and "reseeding" after a converged solve
(``PostProcess → SetNewSeed``, ``:343-346``) is just ``jax.random.split``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig, MapParams
from .coupling import coupling_kernel
from .lift import lift, initial_spike_indices
from .evolve import evolve_ensemble, EvolveResult
from .restrict import restrict_positions, masked_ensemble_mean


class MapDiagnostics(NamedTuple):
    """Optional per-stage intermediates (the reference's debug-dump stages,
    ``EventDrivenMap.cu:406-503``, as arrays instead of ``test*.dat`` files)."""

    v0: jax.Array
    s0: jax.Array
    init_ind: jax.Array
    evolve: EvolveResult
    positions: jax.Array
    accept_count: jax.Array
    u_mean: jax.Array


def z_to_u(Z: jax.Array) -> jax.Array:
    """Gauge fixing ``Z -> U = (c, 0, Z1, ..)``: spike 1 pinned at offset 0
    (translation symmetry of the ring; ``EventDrivenMap.cu:388-396``)."""
    return jnp.concatenate([Z[:1], jnp.zeros((1,), Z.dtype), Z[1:]])


def u_to_z(U: jax.Array) -> jax.Array:
    """Inverse gauge map (``EventDrivenMap.cu:398-404``)."""
    return jnp.concatenate([U[:1], U[2:]])


def sample_beta(cfg: ModelConfig, params: MapParams, key: jax.Array
                ) -> jax.Array:
    """Heterogeneous synaptic rates ``beta ~ N(mean, sigma)`` per neuron per
    realisation (``curandGenerateNormal`` at ``EventDrivenMap.cu:179``)."""
    dt_ = cfg.jdtype
    noise = jax.random.normal(key, (cfg.n_real, cfg.n_neurons), dtype=dt_)
    return params.beta.astype(dt_) + params.sigma.astype(dt_) * noise


def select_pallas_evolve(cfg: ModelConfig, evolve_backend: str) -> bool:
    """Resolve the evolve-backend switch (shared by every map variant).

    ``"auto"`` takes the GPU evolve kernel (:mod:`.evolve_pallas`) for fp32
    maps when the default backend is a GPU, and the XLA evolve otherwise.
    """
    if evolve_backend not in ("auto", "xla", "pallas", "replay"):
        raise ValueError(f"unknown evolve_backend: {evolve_backend!r}")
    if evolve_backend == "pallas" and cfg.dtype != "float32":
        # fail loudly, like every other impossible explicit request: the
        # kernel is fp32-only, and silently computing the evolve in f32
        # while returning it dressed as f64 would hand the caller a
        # residual the requested map never evaluated (~1e-4 floor where
        # ~1e-9 was asked for).  "auto"/"xla" and "replay" are the f64
        # routes.
        raise ValueError(
            f"evolve_backend='pallas' is fp32-only (cfg.dtype="
            f"{cfg.dtype!r}); use 'auto'/'xla' (native f64) or 'replay'")
    return evolve_backend == "pallas" or (
        evolve_backend == "auto"
        and cfg.dtype == "float32"
        and jax.default_backend() == "gpu")


def differentiable_backend(evolve_backend: str) -> str:
    """Resolve a backend choice to one safe under ``jax.jacfwd``.

    The Pallas evolve kernel defines no JVP, so any consumer that
    forward-differentiates the map (``fd_mode="exact"``, arclength bordered
    systems, Moore-Spence fold tracking) must pin a differentiable evolve
    path: ``"auto"``/``"pallas"`` resolve to ``"xla"`` (whose while-loop and
    windowed batched variants both carry the event-time IFT JVP,
    :mod:`.events`).  Library entry points call this instead of relying on
    the CLI's guard.
    """
    return "xla" if evolve_backend in ("auto", "pallas") else evolve_backend


def accurate_backend(evolve_backend: str) -> str:
    """Resolve a backend choice for the accurate (f64-grade) solve stage.

    ``"auto"``/``"pallas"`` (the kernel is fp32-only and defines no JVP)
    resolve to the native float64 XLA evolve on every platform; explicit
    ``"xla"`` and ``"replay"`` pass through.  The df64 schedule replay is
    explicit-only, and refused on a GPU
    (:func:`.replay.require_replay_platform`).
    """
    if evolve_backend in ("auto", "pallas"):
        return "xla"
    return evolve_backend


def run_pipeline(cfg: ModelConfig, params: MapParams, Z: jax.Array,
                 beta: jax.Array, *, use_pallas: bool = False,
                 use_replay: bool = False, schedule_backend: str = "auto"):
    """The lift -> evolve -> restrict stages shared by every map variant.

    Returns ``(U, init_ind, v0, s0, evolve_result, positions)``; callers
    differ only in how they produce ``beta`` (plain / sharding-constrained /
    per-device) and how they reduce ``positions`` (local mean / psum).
    ``schedule_backend`` pins the replay's f32 discovery pass — GSPMD
    callers pass ``"xla"`` (a ``pallas_call`` cannot be partitioned).
    """
    Z = Z.astype(cfg.jdtype)   # seed indices and lift from the SAME precision
    U = z_to_u(Z)
    init_ind = initial_spike_indices(cfg, Z)
    v0, s0 = lift(cfg, params, U)
    if use_replay:
        # two-pass f32-schedule + df64-replay evolve: f64-grade times at
        # f32 hardware speed, differentiable (model/replay.py)
        from .replay import evolve_ensemble_replay
        res = evolve_ensemble_replay(cfg, v0, s0, beta, init_ind,
                                     schedule_backend=schedule_backend)
    elif use_pallas:
        from .evolve_pallas import evolve_ensemble_pallas
        res = evolve_ensemble_pallas(cfg, v0, s0, beta, init_ind)
    elif cfg.evolve_window:
        # batched array-level loop: the certified window needs a genuine
        # scalar lax.cond fallback, which vmap would turn into a select
        from .evolve_batched import evolve_ensemble_batched
        res = evolve_ensemble_batched(cfg, coupling_kernel(cfg), v0, s0,
                                      beta, init_ind)
    else:
        res = evolve_ensemble(cfg, coupling_kernel(cfg), v0, s0, beta,
                              init_ind)
    return U, init_ind, v0, s0, res, restrict_positions(cfg, res)


def assemble_residual(cfg: ModelConfig, U: jax.Array, u_mean: jax.Array
                      ) -> jax.Array:
    """``f = -c U[1:] - U_T + c T`` (``EventDrivenMap.cu:239``)."""
    return (-U[0] * U[1:] - u_mean
            + U[0] * jnp.asarray(cfg.t_horizon, cfg.jdtype))


def event_driven_map(cfg: ModelConfig, params: MapParams, key: jax.Array,
                     Z: jax.Array, *, with_diagnostics: bool = False,
                     evolve_backend: str = "auto"):
    """Evaluate the equation-free map residual ``f = F(Z)``.

    Args:
      cfg: static model config (closed over by ``jit``).
      params: dynamic continuation parameters ``(beta, sigma)``.
      key: PRNG key; reuse the same key across evaluations for common random
        numbers within a solve.
      Z: ``(n_spikes,)`` reduced state ``(c, z_1, ..)``.
      with_diagnostics: also return per-stage intermediates.
      evolve_backend: ``"xla"`` (vmapped while loop, any backend/dtype),
        ``"pallas"`` (the GPU evolve kernel: one program per realisation
        runs the whole event loop, fp32), ``"replay"`` (f32 schedule pass +
        df64 replay: f64-grade accuracy, differentiable; CPU only), or
        ``"auto"`` (pallas for fp32 on a GPU, xla otherwise).

    Returns:
      ``f`` of shape ``(n_spikes,)`` — and ``MapDiagnostics`` if requested.
      Residual assembly (``EventDrivenMap.cu:239``):
      ``f = -c * U[1:] - U_T + c * T``.
    """
    beta = sample_beta(cfg, params, key)
    use_pallas = select_pallas_evolve(cfg, evolve_backend)
    U, init_ind, v0, s0, res, positions = run_pipeline(
        cfg, params, Z, beta, use_pallas=use_pallas,
        use_replay=evolve_backend == "replay")
    u_mean, count = masked_ensemble_mean(positions, res.accept)

    f = assemble_residual(cfg, U, u_mean)
    if with_diagnostics:
        return f, MapDiagnostics(v0=v0, s0=s0, init_ind=init_ind, evolve=res,
                                 positions=positions, accept_count=count,
                                 u_mean=u_mean)
    return f


def compute_discrete_outcome(cfg: ModelConfig, params: MapParams,
                             key: jax.Array, Z: jax.Array, *,
                             schedule_backend: str = "auto",
                             mesh=None, mesh_axis: str = "real"):
    """The map's discrete outcome at ``Z``: ``(schedule, n_events, init_ind)``.

    The event-driven map is piecewise smooth: between evaluations its only
    non-smooth content is *discrete* — the firing order per realisation (the
    schedule) and the seeding grid indices.  This helper runs the cheap f32
    discovery pass once and returns that outcome so
    :func:`frozen_schedule_map` can evaluate the surrounding smooth piece at
    many nearby points in one batched launch (fused residual + FD Jacobian,
    :func:`..solvers.staged.newton_solve_frozen`).

    ``mesh`` GSPMD-constrains the realisation ensemble over ``mesh_axis``
    so the discovery evolve partitions with the rest of a mesh-sharded
    frozen solve (round-3 review: it used to run replicated while only
    the replay stencil it feeds was spread over the devices).  Under a
    mesh the schedule backend is pinned to XLA (a ``pallas_call`` cannot
    be GSPMD-partitioned).  The outcome only feeds the df64 replay, so
    this is refused on a GPU (:func:`.replay.require_replay_platform`).
    """
    from .replay import compute_schedule, require_replay_platform
    require_replay_platform()
    Z = Z.astype(cfg.jdtype)
    beta = sample_beta(cfg, params, key)
    if mesh is not None:
        from ..parallel.sharding import ensemble_constraint
        beta = ensemble_constraint(mesh, mesh_axis)(beta)
        if schedule_backend == "pallas":
            # loud failure, same convention as make_gspmd_map_fn: a
            # pallas_call cannot be GSPMD-partitioned, and silently
            # substituting the XLA evolve would hand the caller a
            # different program than the one they named
            raise ValueError(
                "schedule_backend='pallas' cannot be GSPMD-partitioned "
                "over a mesh; use 'auto' (resolves to the XLA evolve "
                "under a mesh) or 'xla'")
        schedule_backend = "xla"          # resolve "auto" under the mesh
    init_ind = initial_spike_indices(cfg, Z)
    v0, s0 = lift(cfg, params, z_to_u(Z))
    sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind,
                                   schedule_backend=schedule_backend)
    return sched, n_ev, init_ind


def frozen_schedule_map(cfg: ModelConfig, params: MapParams, key: jax.Array,
                        Z: jax.Array, schedule: jax.Array, n_sched: jax.Array,
                        init_ind: jax.Array) -> jax.Array:
    """The smooth piece of ``F`` around a frozen discrete outcome.

    Evaluates the df64 replay of ``schedule`` from the lift at ``Z`` with
    the seeding indices pinned to ``init_ind``.  When the outcome came from
    :func:`compute_discrete_outcome` at the same ``Z`` this equals
    ``event_driven_map(..., evolve_backend="replay")`` exactly; for nearby
    ``Z`` it is the same *smooth piece* of the piecewise-smooth map — the
    function ``jax.jacfwd`` differentiates (the replay's ``stop_gradient``
    freezes the identical outcome).  Measured at N=512 f64: central FD of
    this at eps ≤ 1e-4 matches the jacfwd-exact Jacobian to ~3e-7 relative
    (tests/test_staged.py) — so a batched (2n+1)-point evaluation replaces a
    jacfwd sweep at a fraction of the cost, with no JVP requirement on the
    evolve backend.
    """
    from .replay import replay_events
    beta = sample_beta(cfg, params, key)
    Z = Z.astype(cfg.jdtype)
    U = z_to_u(Z)
    v0, s0 = lift(cfg, params, U)
    res = replay_events(cfg, schedule, n_sched, v0, s0, beta, init_ind)
    positions = restrict_positions(cfg, res)
    u_mean, _ = masked_ensemble_mean(positions, res.accept)
    return assemble_residual(cfg, U, u_mean)


def frozen_schedule_map_batched(cfg: ModelConfig, params: MapParams,
                                key: jax.Array, Zs: jax.Array,
                                schedule: jax.Array, n_sched: jax.Array,
                                init_ind: jax.Array, *,
                                params_batched: bool = False,
                                row_mesh=None,
                                row_axis: str = "real") -> jax.Array:
    """:func:`frozen_schedule_map` over a ``(P, n)`` stack of points sharing
    ONE frozen outcome — a flat ``(P * n_real)``-row replay, not a vmap.

    This is the evaluation engine of the fused frozen-FD Jacobians
    (``solvers/staged.py``, ``analysis/continuation.py``).  Two reasons it
    is not ``jax.vmap(frozen_schedule_map)``:

      * under ``vmap``, the replay's per-event small/full-exp ``lax.cond``
        lowers to a select that executes BOTH branches on every event —
        the small-exp split's ~4x win degrades into a net regression (the
        cond-inside-loops hazard measured in the 2D-binned kernel work);
      * one scan over ``(P*R, N)`` arrays vectorises better than ``P``
        lockstep scans over ``(R, N)``.

    Args:
      params: shared :class:`MapParams`, or (``params_batched=True``) a
        MapParams pytree with a leading ``P`` axis — one per point, for
        correctors that walk a map parameter (the heterogeneity draw stays
        frozen noise under common random numbers: same ``key``).
      Zs: ``(P, n_spikes)`` evaluation points.
      schedule, n_sched, init_ind: one frozen discrete outcome from
        :func:`compute_discrete_outcome`, shared by all points.
      row_mesh: optional :class:`jax.sharding.Mesh` — shard the flat
        ``P * n_real`` row axis over its ``row_axis`` dimension (GSPMD
        constraint).  The replay scan is row-parallel end to end (lane
        reductions stay within a row), so the loop body needs ZERO
        collectives; the only communication is the final per-point
        masked mean over realisations (one small all-reduce).
        This is the multi-chip scale-out of the fused frozen-FD Jacobian:
        the ``(2n+1)`` (or ``(n+1)``) stencil replays spread across the
        mesh like extra realisations.
      row_axis: mesh axis name for the row dimension (default ``"real"``).

    Returns:
      ``(P, n_spikes)`` residuals, row ``i`` equal to
      ``frozen_schedule_map(cfg, params_i, key, Zs[i], ...)`` to ~1 ulp
      (the tiled and single programs are different XLA programs, worth
      ~4e-16 even at ``sigma = 0``; the global-vs-per-point cond branch
      choice adds ~1e-15 per event at ``sigma > 0`` — both measured,
      ``tests/test_staged.py::test_frozen_batched_matches_single``).
    """
    from .replay import replay_events

    def prep(Z, p):
        beta = sample_beta(cfg, p, key)
        U = z_to_u(Z.astype(cfg.jdtype))
        v0, s0 = lift(cfg, p, U)
        return beta, U, v0, s0

    beta_s, Us, v0s, s0s = jax.vmap(
        prep, in_axes=(0, 0 if params_batched else None))(Zs, params)
    P, R = beta_s.shape[0], beta_s.shape[1]

    if row_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        def cst(x):
            spec = PartitionSpec(row_axis, *([None] * (x.ndim - 1)))
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(row_mesh, spec))
    else:
        def cst(x):
            return x

    res = replay_events(cfg,
                        cst(jnp.tile(schedule, (P, 1))),
                        cst(jnp.tile(n_sched, (P,))),
                        cst(jnp.repeat(v0s, R, axis=0)),
                        cst(jnp.repeat(s0s, R, axis=0)),
                        cst(beta_s.reshape(P * R, -1)),
                        init_ind)
    positions = restrict_positions(cfg, res)              # (P*R, M)
    M = positions.shape[-1]
    u_means, _ = jax.vmap(masked_ensemble_mean)(
        positions.reshape(P, R, M), res.accept.reshape(P, R))
    return jax.vmap(lambda u, um: assemble_residual(cfg, u, um))(Us, u_means)


def make_residual_fn(cfg: ModelConfig, params: MapParams, key: jax.Array,
                     *, evolve_backend: str = "auto",
                     ) -> Callable[[jax.Array], jax.Array]:
    """Close the map over ``(cfg, params, key)`` into a residual oracle
    ``F: Z -> f`` — the functional replacement for the reference's
    ``AbstractNonlinearProblem`` interface
    (``AbstractNonlinearProblem.hpp:11``)."""
    def F(Z: jax.Array) -> jax.Array:
        return event_driven_map(cfg, params, key, Z,
                                evolve_backend=evolve_backend)
    return F
