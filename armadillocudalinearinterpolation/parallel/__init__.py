"""Parallel layer: device meshes and ensemble sharding across devices."""

from .sharding import (
    make_mesh,
    ensemble_constraint,
    make_sharded_residual_fn,
    make_gspmd_map_fn,
    make_shard_map_residual_fn,
    sharded_newton_solve,
)

__all__ = [
    "make_mesh",
    "ensemble_constraint",
    "make_sharded_residual_fn",
    "make_gspmd_map_fn",
    "make_shard_map_residual_fn",
    "sharded_newton_solve",
]
