"""Deep-tolerance continuation: the reference's production loop at 1e-8.

The reference's commented-out sweep (``Driver.cu:86-114``)
steps ``beta`` by 0.1, Newton-solves each point to tol 1e-4 in native
double, and counts unstable eigenvalues.  This example runs the same loop
at **1e-8** using the staged hybrid-precision solver (``solvers/staged.py``): an fp32 fast
Newton, a df64 frozen-schedule-replay Newton (the fused one-sided FD
stencil, the default stage-2 mode), and a frozen-Jacobian
best-iterate polish.  One ``jit_cache`` serves the whole sweep —
``(params, key)`` are traced arguments of every cached program, so step 1
onward re-traces nothing.

Also shown: warm-starting each step from the previous root (the
reference's own pattern), the reseeding protocol (one ``jax.random.split``
per completed step = ``PostProcess -> SetNewSeed``), and stability from
the exported stage-2 Jacobian.

Run:  python examples/deep_sweep.py [--cpu] [--steps N]
(CPU: ~60 s for step 0 incl. trace+compile at N=512, then a few seconds
per warm step.  ``chip_smoke.py`` times the N=4096 solve on a GPU.)
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

if "--cpu" in sys.argv or jax.default_backend() == "cpu":
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
    import armadillocudalinearinterpolation as alt


def main() -> int:
    n_steps = 5
    if "--steps" in sys.argv:
        n_steps = int(sys.argv[sys.argv.index("--steps") + 1])

    # float64 config: the replay carries f64-grade precision on any
    # backend (double-float pairs in the replay, native f64 in the oracle)
    cfg = alt.ModelConfig(n_neurons=512, n_real=8, dtype="float64",
                          root_tol=1e-12, max_events=2048)
    key = jax.random.PRNGKey(0)
    Z = jnp.array([0.3310, 0.6914, 1.3557], jnp.float64)  # Driver.cu:24
    beta = 13.0589                                        # Driver.cu:16

    cache: dict = {}          # one cache for the whole sweep
    for step in range(n_steps):
        params = alt.MapParams.create(beta, 0.0, dtype="float64")
        res = alt.newton_solve_staged(cfg, params, key, Z,
                                      tolerance=1e-8, jit_cache=cache)
        if not bool(res.converged):
            print(f"step {step}: did not converge at beta={beta:.4f} "
                  f"(|r|={float(res.residual_norm):.3e}) — branch end")
            return 1
        # stability from the exported stage-2 Jacobian (the reference's
        # pJacobianExternal flow; eig of the 3x3 runs on the host)
        from armadillocudalinearinterpolation.analysis.stability import (
            count_unstable)
        ev = alt.compute_eigenvalues(None, res.solution,
                                     alt.ProblemType.EQUATION_FREE,
                                     jacobian=np.asarray(res.jacobian))
        n_unst = count_unstable(ev, alt.ProblemType.EQUATION_FREE)
        print(f"step {step}: beta={beta:.4f} |r|={float(res.residual_norm):.2e}"
              f" Z={np.array2string(np.asarray(res.solution), precision=6)}"
              f" unstable={int(n_unst)}")
        # warm start + reseed, as the reference loop does
        Z = res.solution
        beta += 0.1
        key, _ = jax.random.split(key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
