"""Configuration pytrees for the event-driven-map framework.

The reference splits configuration across compile-time macros
(``parameters.hpp:1-15``) and a runtime solver struct
(``NewtonSolver.hpp:17-34``).  Here both tiers collapse into
frozen dataclasses: ``ModelConfig`` is *static* (hashable, closed over by
``jax.jit`` so shapes and unrolled loops specialise on it) while runtime
continuation parameters (``beta``, ``sigma``) travel as a small dynamic
pytree (:class:`MapParams`) so a parameter sweep never recompiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model + discretisation constants.

    Mirrors ``parameters.hpp:1-15`` plus the runtime sizes the
    reference keeps on ``EventDrivenMap`` (``EventDrivenMap.cu:69-74``).

    Attributes:
      n_neurons: neurons per realisation (reference ``mNoThreads``, 1024
        default / 512 in the driver run).
      n_real: Monte-Carlo realisations (reference ``noReal``, 1000).
      n_spikes: spike trajectories tracked (reference ``noSpikes`` = 3).
      vth / vr: firing threshold and reset voltage.
      a1, a2, b1, b2: Mexican-hat coupling amplitudes / decay rates.
      drive: constant external drive (reference ``I``).
      half_width: ring half-domain (reference ``L``); x ∈ [-L, L).
      t_horizon: restriction time horizon ``T``.
      root_tol: event-time Newton tolerance (reference ``tol`` = 1e-6).
      counter_max: event-time Newton iteration cap.  The reference uses an
        undefined ``counterMax`` macro (``EventDrivenMap.cu:564`` — the
        shipped tree does not compile); we pin it to 50.
      max_events: hard bound on event-loop trip count used only by the
        fori-variant of evolve; the while-variant bounds by ``2*t_horizon``
        exactly like ``EventDrivenMap.cu:601``.
      evolve_window: XLA batched-evolve performance knob (the GPU kernel
        ignores it) — lanes of the per-event root-find window around the
        wave packet (0 = evaluate all lanes, the reference's behavior).
        Must be a multiple of 128 and < n_neurons.  Results are certified
        exact per event (closed-form lower bound on out-of-window crossing
        times, with full-evaluation fallback), so this changes wall-clock,
        not physics.  Size it to
        the packet: the spike span in lanes is ``c * (z_max - z_min) / dx``
        (~N/13 at the reference solution), and the window needs that plus
        ~96 lanes of margins — N/8 (128 at N=1024, 512 at N=4096); too
        narrow triggers certificate fallbacks, each a full evaluation.
      dtype: compute dtype ('float32' fast path, 'float64' accurate path).
    """

    n_neurons: int = 1024
    n_real: int = 1000
    n_spikes: int = 3
    vth: float = 1.0
    vr: float = 0.0
    a1: float = 11.0
    a2: float = 7.0
    b1: float = 5.0
    b2: float = 3.5
    drive: float = 0.9
    half_width: float = 3.0
    t_horizon: float = 5.0
    root_tol: float = 1e-6
    counter_max: int = 50
    max_events: int = 4096
    evolve_window: int = 0
    # How the df64 replay computes the small-argument delta factor of its
    # anchor/delta-split decay exp (model/replay.py).  Every mode gives
    # bitwise-identical results where it accepts; they differ in cost,
    # which has not been measured on the GPU yet.
    #   "cond"  — per-event lax.cond on the measured |z| bound: exp_small
    #             when every live row is within SMALL_EXP_BOUND, full
    #             range-reduced exp_fast otherwise.  Exact everywhere;
    #             the right choice under vmap, where "hoisted" degrades
    #             to both-loops (the plain FD-Jacobian paths on the replay
    #             backend vmap; the frozen/staged paths tile rows instead).
    #   "small" — exp_small hardcoded.  A live row whose |z| exceeds the
    #             bound on some event is REJECTED via the consistency flag
    #             (never silently mis-evolved), so this is exact-or-rejected:
    #             right for small-sigma regimes (|z| ~ sigma*dt stays ~1e-3
    #             at the reference parameters).
    #   "fast"  — exp_fast hardcoded.  Exact everywhere, no cond.
    #   "hoisted" — exp_small loop with the bound violation ACCUMULATED
    #             into one scalar flag; a single top-level lax.cond reruns
    #             the whole loop with exp_fast only when it fired.  Exact
    #             everywhere with no per-event cond; ~2x cost in the rare
    #             rerun case.  The default.
    replay_exp_mode: str = "hoisted"
    # Replay event-loop form (model/replay.py).  "while" (default): the
    # bounded lax.while_loop stopping at max(n_sched) — exact (dead-tail
    # steps are fully live-masked) and skips the ~15-20% of cfg.max_events
    # typical trajectories leave unfilled.  "scan": fixed-length lax.scan
    # over all cfg.max_events steps — same math (bitwise-identical values
    # and Jacobians, tested), paying the dead tail.
    replay_loop: str = "while"
    # Tangent arithmetic for forward-mode differentiation THROUGH the df64
    # replay (model/replay.py).  The tangent chains through the error-free
    # transformations are wide: every df64 add/mul splits into 6-20 f32
    # ops and each tangent pays all of them.  But the TANGENT needs no
    # df64 — Jacobian consumers (Newton directions, bordered continuation
    # systems, eigen-spectra) use a handful of digits, while only the
    # PRIMAL residual must hold the 1e-9 contract.
    #   "df64" — differentiate the df64 scan itself: machine-grade
    #            tangents (the pair arithmetic's ~2^-47).  THE DEFAULT:
    #            the Moore-Spence fold system consumes J.v as residual
    #            ROWS (analysis/fold.py), so tangent error displaces the
    #            computed fold location — tangent grade is a correctness
    #            surface there, not just a solver-speed knob.
    #   "f32"  — custom JVP at the whole-replay granularity: the primal
    #            stays the bitwise-identical df64 replay; tangents
    #            propagate through a plain-f32 re-evolution of the SAME
    #            schedule (IFT tangent at each scheduled root via
    #            events.event_time, closed-form advance in f32).
    #            Jacobian agreement vs "df64": ~1.5e-4 relative at N=512
    #            R=8 sigma=0.1 (tests/test_replay.py) — set by the f32
    #            trajectory's drift, ample for Newton directions and
    #            continuation correctors.  Opt in for exact-mode solves
    #            and arclength walks; avoid for fold tracking and spectra
    #            at < 1e-3 stability margins.
    # Either mode, use solvers.newton.jacfwd_cols (the package's exact-
    # mode consumers all do) rather than plain jax.jacfwd, which vmaps the
    # tangents through the event loop.
    replay_jvp: str = "df64"
    dtype: str = "float32"

    def __post_init__(self):
        if self.n_neurons < 1 or self.n_real < 1 or self.n_spikes < 1:
            raise ValueError("n_neurons, n_real, n_spikes must be positive")
        if self.max_events < 1:
            # fails six frames deep otherwise (the replay's schedule
            # recorder returns a bare result for a 0-length log and the
            # unpack raises) — validate at config time like every other
            # field
            raise ValueError("max_events must be positive (it sizes the "
                             "event log and the replay scan)")
        if self.vr != 0.0:
            # Every evolve implementation (and the reference itself:
            # EventDrivenMap.cu:615 multiplies by zero, ignoring the vr
            # macro) hard-codes reset-to-zero.  Reject rather than silently
            # ignore a nonzero setting.
            raise ValueError("vr != 0 is not supported: the reset is "
                             "multiplicative (v=0), as in the reference")
        if self.evolve_window and (self.evolve_window % 128
                                   or not 0 < self.evolve_window < self.n_neurons):
            raise ValueError("evolve_window must be a multiple of 128 in "
                             f"(0, n_neurons); got {self.evolve_window}")
        if self.replay_exp_mode not in ("cond", "small", "fast", "hoisted"):
            raise ValueError("replay_exp_mode must be 'cond', 'small', "
                             f"'fast' or 'hoisted'; got "
                             f"{self.replay_exp_mode!r}")
        if self.replay_loop not in ("while", "scan"):
            raise ValueError("replay_loop must be 'while' or 'scan'; got "
                             f"{self.replay_loop!r}")
        if self.replay_jvp not in ("df64", "f32"):
            raise ValueError("replay_jvp must be 'df64' or 'f32'; got "
                             f"{self.replay_jvp!r}")
        if self.n_neurons < 256:
            import warnings
            warnings.warn(
                f"n_neurons={self.n_neurons} is below the model's physical "
                "resolution floor (~256 at the default parameters): the "
                "lifted state may fire no neurons, rejecting every "
                "realisation (NaN mean).", stacklevel=2)

    @property
    def dx(self) -> float:
        return 2.0 * self.half_width / self.n_neurons

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def grid(self) -> jax.Array:
        """Ring coordinates x_i = -L + i*dx, ascending (EventDrivenMap.cu:117)."""
        return (-self.half_width
                + self.dx * jnp.arange(self.n_neurons, dtype=self.jdtype))

    def with_(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MapParams:
    """Dynamic (traced) continuation parameters.

    ``beta`` is the mean synaptic rate — the continuation parameter the
    reference sweeps (``Driver.cu:16,107``); ``sigma`` is the heterogeneity
    std-dev (``EventDrivenMap::SetParameterStdDev``, ``EventDrivenMap.cu:317``).
    """

    beta: jax.Array
    sigma: jax.Array

    @staticmethod
    def create(beta: float, sigma: float = 0.0, dtype="float32") -> "MapParams":
        return MapParams(beta=jnp.asarray(beta, dtype=dtype),
                         sigma=jnp.asarray(sigma, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton solver parameters (reference ``NewtonSolver::ParameterList``,
    ``NewtonSolver.hpp:17-34``, defaults from ``Driver.cu:28-37``)."""

    tolerance: float = 1e-4
    max_iterations: int = 10
    fd_epsilon: float = 1e-2
    damping: float = 1.0
    print_output: bool = False
    # Jacobian mode: "forward" FD (reference), "central" FD (O(eps^2)), or
    # "exact" (forward-mode autodiff through the map with an implicit-
    # function-theorem JVP at the event-time root; XLA evolve backend only).
    fd_mode: str = "forward"
    # Early-divergence cutoff: abandon the iteration once the residual norm
    # exceeds divergence_factor * initial norm.  inf (default) preserves the
    # reference's run-to-max_iterations behavior; continuation probes set it
    # finite so clearly-runaway correctors fail in ~2 iterations instead of
    # burning the full budget (boundary tracing spends most of its time in
    # deliberately-failing probes).
    divergence_factor: float = float("inf")
