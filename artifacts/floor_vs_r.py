"""Measure the 1e-8 event-reordering floor vs ensemble size.

ROADMAP predicts the discrete-outcome-ambiguity floor at N=4096 shrinks
~1/R (R Monte-Carlo realisations average the event-reordering jumps down);
the judged config-4 bench ran R=64 — right at the floor — while the
reference's driver uses noReal=1000 (Driver.cu:19).  This
script runs the staged solve at N=4096 for R in {64, 256, 1024}, recording
the converged residual, the *stall floor* (deepest residual a
beyond-target polish reaches), and warm wall-clock, so the config-4
default R is chosen with margin instead of sitting on the floor.

Run on a GPU, one R per invocation if desired:

    python artifacts/floor_vs_r.py [--r 64 256 1024] [--n 4096]

Appends one JSON line per R to artifacts/floor_vs_r.jsonl.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import jax.numpy as jnp

from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, newton_solve_staged)
from armadillocudalinearinterpolation.utils.cache import (
    enable_compilation_cache)


def measure(n: int, r: int, *, tolerance: float = 1e-8,
            floor_tolerance: float = 1e-10) -> dict:
    key = jax.random.PRNGKey(0)
    Z0 = jnp.array([0.3310, 0.6914, 1.3557], jnp.float32)
    cfg = ModelConfig(n_neurons=n, n_real=r, dtype="float64",
                      root_tol=1e-12, evolve_window=512, max_events=4096)
    params = MapParams.create(13.0589, 0.1, dtype="float64")

    jits = {}
    t0 = time.perf_counter()
    pol_cold = newton_solve_staged(cfg, params, key, Z0,
                                   tolerance=tolerance, jit_cache=jits)
    t_cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    pol = newton_solve_staged(cfg, params, key, Z0 + jnp.float32(1e-3),
                              tolerance=tolerance, jit_cache=jits)
    t_warm = time.perf_counter() - t0

    # Floor probe: ask for an unreachable target with a generous polish
    # budget; the deepest residual before the stall IS the event-reordering
    # floor at this (N, R).  Fresh cache — root_tol derives from tolerance.
    jits_f = {}
    t0 = time.perf_counter()
    pol_f = newton_solve_staged(
        ModelConfig(n_neurons=n, n_real=r, dtype="float64",
                    root_tol=1e-14, evolve_window=512, max_events=4096),
        params, key, Z0, tolerance=floor_tolerance,
        polish_iterations=60, jit_cache=jits_f)
    t_floor = time.perf_counter() - t0

    return {
        "n": n, "r": r, "tolerance": tolerance,
        "newton_s_cold": round(t_cold, 2),
        "newton_s_warm": round(t_warm, 2),
        "final_norm_cold": float(pol_cold.residual_norm),
        "final_norm_warm": float(pol.residual_norm),
        "converged": bool(pol.converged) and bool(pol_cold.converged),
        "iters_warm": int(pol.iterations),
        "floor_norm": float(pol_f.residual_norm),
        "floor_probe_s": round(t_floor, 2),
        "solution": [float(x) for x in pol.solution],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, nargs="+", default=[64, 256, 1024])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--out", default="artifacts/floor_vs_r.jsonl")
    args = ap.parse_args()

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    for r in args.r:
        rec = measure(args.n, r)
        rec["stamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
