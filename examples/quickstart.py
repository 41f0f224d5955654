"""Quickstart: solve, analyze, and continue the event-driven map.

Mirrors the reference driver's flow (``Driver.cu:11-126``:
build the map, smoke-test ``ComputeF``, Newton-solve, check stability,
sweep the parameter) through this framework's public API.  Runs anywhere —
on a CPU it uses the fp64 oracle path; on a GPU the same code takes the
evolve kernel (``dtype="float32"``) or the df64 staged solver
(``newton_solve_staged``) for deep tolerances.

Run:  python examples/quickstart.py [--cpu]
"""

import sys

import jax
import jax.numpy as jnp

if "--cpu" in sys.argv or jax.default_backend() == "cpu":
    # select the CPU platform BEFORE first backend use
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
jax.config.update("jax_enable_x64", True)

try:
    import armadillocudalinearinterpolation as alt
except ModuleNotFoundError:                      # run from a source checkout
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import armadillocudalinearinterpolation as alt  # noqa: E402

# ---------------------------------------------------------------- setup --
# Model constants live in a static, hashable config (replaces the
# reference's parameters.hpp macros); map parameters (beta, sigma) are a
# traced pytree, so parameter sweeps never recompile.
cfg = alt.ModelConfig(n_neurons=512, n_real=64, dtype="float64")
params = alt.MapParams.create(beta=13.0589, sigma=0.1, dtype="float64")
key = jax.random.PRNGKey(0)          # common-random-numbers: one key = one
#                                      frozen heterogeneity draw (ResetSeed)

# Driver.cu:24 initial guess: (wave speed c, spike offsets 2 and 3)
Z0 = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)

# ------------------------------------------------------------ the map F --
F = alt.make_residual_fn(cfg, params, key)   # AbstractNonlinearProblem
print("smoke test |F(Z0)| =", float(jnp.linalg.norm(F(Z0))))

# -------------------------------------------------------------- solving --
ncfg = alt.NewtonConfig(tolerance=1e-10, max_iterations=15, fd_epsilon=1e-7)
res = jax.jit(lambda z: alt.newton_solve(F, z, ncfg))(Z0)
print(f"converged={bool(res.converged)} iters={int(res.iterations)} "
      f"|F|={float(res.residual_norm):.3e}")
print("solution (c, x2, x3) =", res.solution)

# ------------------------------------------------------------ stability --
n_unstable = alt.num_unstable_eigenvalues(
    F, res.solution, alt.ProblemType.EQUATION_FREE, jacobian=res.jacobian)
print("unstable eigenvalues:", int(n_unstable))

# -------------------------------------------------- deep-tolerance solve --
# The staged hybrid-precision recipe (fp32 fast stage -> df64 schedule-
# replay Newton -> frozen-Jacobian polish) reaches 1e-8-grade tolerances
# without a native-f64 event loop.  `mesh=` runs the whole recipe sharded.
cache = {}
deep = alt.newton_solve_staged(cfg, params, key, Z0, tolerance=1e-8,
                               jit_cache=cache)
print(f"staged: converged={bool(deep.converged)} "
      f"|F|={float(deep.residual_norm):.3e}")

# ----------------------------------------------------------- sweep step --
# MapParams is a traced argument of the cached programs: the second solve
# at a new beta reuses every compiled program (warm sweep steps).
params2 = alt.MapParams.create(beta=13.1589, sigma=0.1, dtype="float64")
step2 = alt.newton_solve_staged(cfg, params2, key,
                                deep.solution.astype(jnp.float64),
                                tolerance=1e-8, jit_cache=cache)
print(f"sweep step beta=13.1589: converged={bool(step2.converged)} "
      f"|F|={float(step2.residual_norm):.3e}")

# For production sweeps, branch switching, fold / existence-boundary
# tracking and checkpointing, use the CLI:
#   python -m armadillocudalinearinterpolation.cli.driver --help
