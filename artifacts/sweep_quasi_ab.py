import os, sys, json, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from armadillocudalinearinterpolation import (
    ModelConfig, MapParams, NewtonConfig, make_residual_fn, newton_solve,
    ProblemType)
from armadillocudalinearinterpolation.analysis.stability import (
    compute_eigenvalues, count_unstable)
from armadillocudalinearinterpolation.solvers.newton import fd_jacobian
from armadillocudalinearinterpolation.utils.cache import (
    enable_compilation_cache)

enable_compilation_cache()
jax.config.update("jax_enable_x64", True)

cfg = ModelConfig(n_neurons=512, n_real=1024, dtype="float32",
                  evolve_window=128)
ncfg = NewtonConfig(tolerance=1e-4, max_iterations=10, fd_epsilon=1e-2)
key = jax.random.PRNGKey(0)
Z = jnp.array([0.3310, 0.6914, 1.3557], jnp.float32)

@jax.jit
def solve_plain(params, z0):
    return newton_solve(make_residual_fn(cfg, params, key), z0, ncfg)

@jax.jit
def solve_quasi(params, z0, jac0):
    F = make_residual_fn(cfg, params, key)
    res = newton_solve(F, z0, ncfg, jacobian0=jac0)
    # fresh smooth-slope at the solution for the exported spectrum
    jac = fd_jacobian(F, res.solution, res.residual, ncfg.fd_epsilon)
    return res._replace(jacobian=jac)

def run(variant, n_steps=100):
    beta, z = 13.0589, Z
    jac0 = jnp.eye(3, dtype=jnp.float32)
    n_conv = 0; unstable = []
    # warm compile
    p0 = MapParams.create(13.0589, 0.1, dtype="float32")
    if variant == "plain":
        _ = solve_plain(p0, Z); jax.block_until_ready(_.solution)
    else:
        _ = solve_quasi(p0, Z, jac0); jax.block_until_ready(_.solution)
    t0 = time.perf_counter()
    for i in range(n_steps):
        params = MapParams.create(beta, 0.1, dtype="float32")
        res = solve_plain(params, z) if variant == "plain" else \
              solve_quasi(params, z, jac0)
        ok = bool(res.converged) and bool(jnp.all(jnp.isfinite(res.solution)))
        ev = compute_eigenvalues(None, res.solution, ProblemType.EQUATION_FREE,
                                 jacobian=np.asarray(res.jacobian))
        unstable.append(int(count_unstable(ev, ProblemType.EQUATION_FREE)))
        if ok:
            z = res.solution; jac0 = res.jacobian; n_conv += 1
        beta += 0.1
    t = time.perf_counter() - t0
    return t / n_steps, n_conv, unstable

for variant in ("plain", "quasi", "plain", "quasi"):
    s, n_conv, unst = run(variant)
    print(json.dumps({"variant": variant, "s_per_step": round(s, 3),
                      "converged": n_conv,
                      "unstable_first_last": [unst[0], unst[-1]]}), flush=True)
