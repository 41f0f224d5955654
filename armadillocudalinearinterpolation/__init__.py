"""Equation-free event-driven-map framework in JAX.

A brand-new JAX/XLA/Pallas re-design of the capabilities of
``kyle-wedgwood/ArmadilloCUDALinearInterpolation``: an equation-free
(lift–evolve–restrict) event-driven map for multi-spike traveling waves in a
stochastic spiking neural field, embedded in a Newton fixed-point solver with
finite-difference Jacobians, linear-stability analysis, and parameter
continuation.  See ``SURVEY.md`` at the repo root for the structural analysis
of the reference this was built against.

Design stance (not a port):
  * the GPU pipeline (``EventDrivenMap::ComputeF``) is one jit-compiled pure
    function over pytrees — zero host round-trips inside the map;
  * Monte-Carlo realisations are a ``vmap`` axis, shardable over a device
    mesh via ``shard_map`` + ``psum``;
  * the RNG-seeding protocol (common random numbers) is explicit
    ``jax.random`` key threading;
  * the solver class hierarchy becomes functions over pytrees.
"""

from .config import ModelConfig, MapParams, NewtonConfig
from .model.coupling import coupling_kernel, mexican_hat
from .model.lift import lift, initial_spike_indices
from .model.events import event_time
from .model.evolve import evolve, evolve_ensemble
from .model.restrict import restrict_positions, masked_ensemble_mean
from .model.emap import (
    z_to_u,
    u_to_z,
    differentiable_backend,
    event_driven_map,
    make_residual_fn,
    MapDiagnostics,
)
from .solvers.criterion import residual_norm_criterion
from .solvers.newton import (newton_solve, newton_solve_host,
                             frozen_jacobian_polish, NewtonResult)
from .solvers.staged import (newton_solve_frozen, newton_solve_staged,
                             staged_aot_warmup)
from .analysis.stability import (
    ProblemType,
    compute_eigenvalues,
    num_unstable_eigenvalues,
    fd_jacobian,
)
from .analysis.continuation import continue_branch, ArcStep
from .analysis.branches import enumerate_branches, Branch
from .analysis.boundary import track_existence_boundary, BoundaryPoint
from .analysis.fold import solve_fold, track_fold, FoldPoint

__version__ = "0.3.0"

__all__ = [
    "ModelConfig",
    "MapParams",
    "NewtonConfig",
    "coupling_kernel",
    "mexican_hat",
    "lift",
    "initial_spike_indices",
    "event_time",
    "evolve",
    "evolve_ensemble",
    "restrict_positions",
    "masked_ensemble_mean",
    "z_to_u",
    "u_to_z",
    "differentiable_backend",
    "event_driven_map",
    "make_residual_fn",
    "MapDiagnostics",
    "residual_norm_criterion",
    "newton_solve",
    "newton_solve_frozen",
    "newton_solve_host",
    "newton_solve_staged",
    "staged_aot_warmup",
    "frozen_jacobian_polish",
    "NewtonResult",
    "ProblemType",
    "compute_eigenvalues",
    "num_unstable_eigenvalues",
    "fd_jacobian",
    "continue_branch",
    "ArcStep",
    "enumerate_branches",
    "Branch",
    "track_existence_boundary",
    "BoundaryPoint",
    "solve_fold",
    "track_fold",
    "FoldPoint",
]
